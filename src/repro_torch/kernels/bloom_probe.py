"""bloom_probe: packed Bloom-filter probe — gather + bit test.

The port of ``repro/kernels/bloom_probe.py::bloom_probe``: words (k, W),
word_idx (B, k) int32 and bit_mask (B, k) -> hits (B, k) uint8. On a CUDA
tensor the wrapper launches the hand-written kernel in
``csrc/bloom_probe.cu`` (its note says what bounds it) or raises; on a CPU
tensor it runs ``bloom_probe_plain``. Words and masks are int32 tensors of
uint32 bit patterns (``core.u32``). An index outside [0, W) reads a
clamped word, as a JAX gather does. Unlike the reference, no 8 MiB row
limit applies: that was the TPU's VMEM budget, and this kernel gathers
from device memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build


def bloom_probe_plain(words: torch.Tensor, word_idx: torch.Tensor,
                      bit_mask: torch.Tensor) -> torch.Tensor:
    """-> hits (B, k) uint8."""
    k, w = words.shape
    idx = torch.clamp(word_idx.to(torch.int64), 0, w - 1)
    rows = torch.arange(k, device=words.device)[None, :]
    return ((words[rows, idx] & bit_mask) != 0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("bloom_probe").bloom_probe_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, p, p, i, i, ctypes.c_longlong, p]
    fn.restype = ctypes.c_int
    return fn


def check_operands(kernel: str, words, word_idx, bit_mask) -> None:
    """The (B, k) index and mask operands of ``bloom_probe`` and
    ``scatter_delta``: int32, contiguous, one device."""
    for name, t in (("words", words), ("word_idx", word_idx),
                    ("bit_mask", bit_mask)):
        if t is None:
            continue
        if t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32 words, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")
        if t.device != word_idx.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"word_idx on {word_idx.device}")
    if word_idx.dim() != 2 or bit_mask.shape != word_idx.shape:
        raise ValueError(f"{kernel}: word_idx and bit_mask must be (B, k), "
                         f"got {tuple(word_idx.shape)} and "
                         f"{tuple(bit_mask.shape)}")
    if word_idx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on cpu or cuda, not "
                         f"{word_idx.device}")


def bloom_probe(words: torch.Tensor, word_idx: torch.Tensor,
                bit_mask: torch.Tensor) -> torch.Tensor:
    """hits (B, k) uint8 of the (k, W) ``words`` at (word_idx, bit_mask);
    ``bloom_probe.launches`` counts kernel launches."""
    check_operands("bloom_probe", words, word_idx, bit_mask)
    if words.dim() != 2 or words.shape[0] != word_idx.shape[1]:
        raise ValueError(f"bloom_probe: words must be (k, W) with k = "
                         f"{word_idx.shape[1]}, got {tuple(words.shape)}")
    if words.device.type == "cpu":
        return bloom_probe_plain(words, word_idx, bit_mask)
    b, k = word_idx.shape
    hits = torch.empty((b, k), dtype=torch.uint8, device=words.device)
    err = _entry()(words.data_ptr(), word_idx.data_ptr(),
                   bit_mask.data_ptr(), hits.data_ptr(), b, k,
                   words.shape[1],
                   torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bloom_probe kernel launch failed: CUDA error "
                           f"{err}")
    bloom_probe.launches += 1
    return hits


bloom_probe.launches = 0
