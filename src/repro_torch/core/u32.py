"""uint32 word arithmetic on PyTorch tensors.

The JAX package computes in ``uint32`` with wrapping semantics. PyTorch's
``torch.uint32`` lacks ``>>``, ``%`` and ``<`` on the CPU, so the port keeps
two representations and converts at the edges:

* **stored words** — ``torch.int32`` tensors holding the uint32 BIT PATTERN
  (two's complement view). ``FilterState.bits``, the rng key data and the
  key batches use it: ``&``, ``|``, ``^`` and ``~`` act on the bits exactly
  as on uint32, the CUDA kernels read the same bytes as ``uint32_t``, and
  ``to_numpy_u32`` hands back byte-identical numpy ``uint32`` arrays.
* **arithmetic values** — ``torch.int64`` tensors holding the uint32 VALUE
  in ``[0, 2^32)``. Shifts, ``%``, ``<`` and sorting use it (sorting int64
  values is the unsigned order). ``mul32`` multiplies in 16-bit halves so
  no product leaves the int64 range: the result never relies on signed
  overflow.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF


def to_u64(words: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern (or any integer tensor) -> int64 value in [0, 2^32)."""
    return words.to(torch.int64) & MASK


def to_i32(values: torch.Tensor) -> torch.Tensor:
    """int64 value (taken mod 2^32) -> int32 bit pattern."""
    return (((values & MASK) ^ 0x80000000) - 0x80000000).to(torch.int32)


def mul32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2^32 for int64 ``x`` in [0, 2^32) and a uint32 constant."""
    lo = x * (m & 0xFFFF)
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    """32-bit rotate left of int64 ``x`` in [0, 2^32)."""
    return ((x << r) | (x >> (32 - r))) & MASK


def popcount_u64(x: torch.Tensor) -> torch.Tensor:
    """SWAR population count of int64 values in [0, 2^32) -> int64."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & MASK) >> 24


def from_numpy_u32(arr, device) -> torch.Tensor:
    """numpy integers (taken as uint32) -> int32 bit-pattern tensor."""
    a = np.ascontiguousarray(np.asarray(arr).astype(np.uint32, copy=False))
    return torch.from_numpy(a.view(np.int32).copy()).to(device)


def to_numpy_u32(words: torch.Tensor) -> np.ndarray:
    """int32 bit-pattern tensor -> numpy uint32 (the same bytes)."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def as_words(keys, device) -> torch.Tensor:
    """Keys from a caller -> contiguous int32 bit-pattern tensor on
    ``device``. numpy arrays and Python sequences are taken as uint32;
    torch tensors keep their low 32 bits."""
    if isinstance(keys, torch.Tensor):
        if keys.dtype == torch.int32:
            return keys.to(device).contiguous()
        if keys.dtype == torch.uint32:
            return keys.to(device).view(torch.int32).contiguous()
        return to_i32(keys.to(device=device, dtype=torch.int64)).contiguous()
    return from_numpy_u32(keys, device)
