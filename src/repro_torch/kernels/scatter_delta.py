"""scatter_delta: OR-union of (B, k) bit masks into a packed (k, W) delta.

The port of ``repro/kernels/scatter_delta.py::scatter_delta``: word_idx
(B, k) int32 and bit_mask (B, k) -> delta (k, W), delta[f, w] the OR of
the masks of row f that land on word w. Lanes whose index lies outside
[0, W) are dropped — the ``-1`` of ``ops.scatter_or`` and the ``>= W`` of
the reference's padding alike. On a CUDA tensor the wrapper zero-fills the
delta and launches the hand-written kernel in ``csrc/scatter_delta.cu``
(``atomicOr``; its note says what bounds it) or raises; on a CPU tensor it
runs ``scatter_delta_plain``. ``words | delta`` and ``words & ~delta``
stay torch ops (``kernels/ops.py``), as the reference leaves them to XLA.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packed, u32
from . import build
from .bloom_probe import check_operands
from .scope import plain_region


def scatter_delta_plain(word_idx: torch.Tensor, bit_mask: torch.Tensor,
                        w: int) -> torch.Tensor:
    """-> (k, W) int32 delta. Each enabled lane's mask is split into its
    set bits, one cell per bit; run heads of the sorted cells are distinct
    bits, so an int64 ``index_add_`` of them is the OR."""
    b, k = word_idx.shape
    dev = word_idx.device
    idx = word_idx.to(torch.int64)
    rows = torch.arange(k, device=dev)[None, :]
    shifts = torch.arange(32, device=dev)
    bits = ((u32.to_u64(bit_mask)[..., None] >> shifts) & 1) != 0
    keep = bits & ((idx >= 0) & (idx < w))[..., None]         # (B, k, 32)
    sentinel = 32 * k * w
    cell = ((rows * w + idx) * 32)[..., None] + shifts
    sp = torch.sort(torch.where(keep, cell, sentinel).reshape(-1)).values
    head = packed.run_heads_1d(sp) & (sp < sentinel)
    acc = torch.zeros((k * w,), dtype=torch.int64, device=dev)
    acc.index_add_(0, torch.where(head, sp >> 5, 0),
                   torch.where(head, 1 << (sp & 31), 0))
    return u32.to_i32(acc).reshape(k, w)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("scatter_delta").scatter_delta_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, i, i, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


def scatter_delta(word_idx: torch.Tensor, bit_mask: torch.Tensor, *,
                  w: int) -> torch.Tensor:
    """(k, W) int32 OR-accumulated delta; ``scatter_delta.launches``
    counts kernel launches."""
    check_operands("scatter_delta", None, word_idx, bit_mask)
    if w < 1:
        raise ValueError(f"scatter_delta: W must be >= 1, got {w}")
    if word_idx.device.type == "cpu":
        with plain_region("scatter_delta"):
            return scatter_delta_plain(word_idx, bit_mask, w)
    b, k = word_idx.shape
    delta = torch.zeros((k, w), dtype=torch.int32, device=word_idx.device)
    err = _entry()(word_idx.data_ptr(), bit_mask.data_ptr(),
                   delta.data_ptr(), b, k, w,
                   torch.cuda.current_stream(word_idx.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scatter_delta kernel launch failed: CUDA error "
                           f"{err}")
    scatter_delta.launches += 1
    return delta


scatter_delta.launches = 0
