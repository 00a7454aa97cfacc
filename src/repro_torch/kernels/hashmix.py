"""hashmix: fused k-way murmur-mix hashing — keys (B,) -> positions (B, k).

The port of ``repro/kernels/hashmix.py::hashmix``. ``hashmix`` is the
wrapper: on a CUDA tensor it launches the hand-written kernel in
``csrc/hashmix.cu`` (note there: what bounds it and how) or raises; on a
CPU tensor it runs ``hashmix_plain``, the same function in plain PyTorch.
It is ``hash_positions`` for the plane layout on every device.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import u32
from . import build

M1 = 0x85EBCA6B
M2 = 0xC2B2AE35


def hashmix_plain(keys: torch.Tensor, seeds: torch.Tensor, s: int
                  ) -> torch.Tensor:
    """keys (B,) and seeds (k,) int32 words -> (B, k) int32 in [0, s)."""
    x = u32.to_u64(keys)[:, None] ^ u32.to_u64(seeds)[None, :]
    x = x ^ (x >> 16)
    x = u32.mul32(x, M1)
    x = x ^ (x >> 13)
    x = u32.mul32(x, M2)
    x = x ^ (x >> 16)
    pos = x & (s - 1) if s & (s - 1) == 0 else x % s
    return pos.to(torch.int32)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("hashmix").hashmix_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_uint32,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(keys: torch.Tensor, seeds: torch.Tensor, out: torch.Tensor,
            s: int) -> None:
    stream = torch.cuda.current_stream(keys.device).cuda_stream
    err = _entry()(keys.data_ptr(), seeds.data_ptr(), out.data_ptr(),
             keys.shape[0], seeds.shape[0], s, stream)
    if err != 0:
        raise RuntimeError(f"hashmix kernel launch failed: CUDA error {err}")


def hashmix(keys: torch.Tensor, seeds: torch.Tensor, *, s: int
            ) -> torch.Tensor:
    """Positions (B, k) int32. keys (B,) and seeds (k,) are int32 words on
    one device; ``hashmix.launches`` counts kernel launches."""
    if keys.dtype != torch.int32 or seeds.dtype != torch.int32:
        raise TypeError("hashmix takes int32 word tensors")
    if keys.dim() != 1 or seeds.dim() != 1:
        raise ValueError(f"hashmix takes keys (B,) and seeds (k,); got "
                         f"{tuple(keys.shape)} and {tuple(seeds.shape)}")
    if keys.device != seeds.device:
        raise ValueError("keys and seeds must share a device")
    if not 1 <= s <= 1 << 31:
        raise ValueError(f"s={s} outside [1, 2^31]")
    if not (keys.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("hashmix takes contiguous tensors")
    if keys.device.type == "cpu":
        return hashmix_plain(keys, seeds, s)
    if keys.device.type != "cuda":
        raise ValueError(f"hashmix runs on cpu or cuda, not {keys.device}")
    out = torch.empty((keys.shape[0], seeds.shape[0]), dtype=torch.int32,
                      device=keys.device)
    _launch(keys, seeds, out, s)
    hashmix.launches += 1
    return out


hashmix.launches = 0
