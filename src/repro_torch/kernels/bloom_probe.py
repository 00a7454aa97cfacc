"""bloom_probe: packed Bloom-filter probe — gather + bit test; and
fused_probe, the whole probe of a batch of keys in one launch.

``bloom_probe`` is the port of ``repro/kernels/bloom_probe.py::
bloom_probe``: words (k, W), word_idx (B, k) int32 and bit_mask (B, k) ->
hits (B, k) uint8. ``fused_probe`` is ``repro/kernels/ops.py::
fused_probe`` — hashmix, the split into word index and mask, bloom_probe
and the AND over the rows — as one kernel: keys (B,) -> (dup (B,) bool,
hits (B, k) uint8, pos (B, k) int32). On CUDA tensors each wrapper
launches its hand-written kernel in ``csrc/bloom_probe.cu`` (its note says
what bounds them) or raises; on CPU tensors they run ``bloom_probe_plain``
and ``fused_probe_plain``. Words and masks are int32 tensors of uint32 bit
patterns (``core.u32``). An index outside [0, W) reads a clamped word, as
a JAX gather does. Unlike the reference, no 8 MiB row limit applies: that
was the TPU's VMEM budget, and these kernels gather from device memory.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import packed
from . import build
from .hashmix import check_hash_operands, hashmix_plain, launch_seeds, ptr
from .scope import plain_region


def bloom_probe_plain(words: torch.Tensor, word_idx: torch.Tensor,
                      bit_mask: torch.Tensor) -> torch.Tensor:
    """-> hits (B, k) uint8."""
    k, w = words.shape
    idx = torch.clamp(word_idx.to(torch.int64), 0, w - 1)
    rows = torch.arange(k, device=words.device)[None, :]
    return ((words[rows, idx] & bit_mask) != 0).to(torch.uint8)


def fused_probe_plain(keys: torch.Tensor, words: torch.Tensor,
                      seeds: torch.Tensor, s: int):
    """-> (dup (B,) bool, hits (B, k) uint8, pos (B, k) int32): the chain
    of plain versions the reference's ``fused_probe`` runs."""
    pos = hashmix_plain(keys, seeds, s)
    hits = bloom_probe_plain(words, *packed.split_pos(pos))
    return (hits == 1).all(dim=1), hits, pos


@functools.lru_cache(maxsize=None)
def _entry(name: str):
    """The C entry point ``<name>_launch``, built at first use, its
    signature set once."""
    fn = getattr(build.load("bloom_probe"), f"{name}_launch")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = {"bloom_probe": [p, p, p, p, i, i, ll, p],
                   "fused_probe": [p, p, p, p, p, i, ll, p, p, i,
                                   ctypes.c_uint32, p]}[name]
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
        with plain_region("bloom_probe"):
            return bloom_probe_plain(words, word_idx, bit_mask)
    b, k = word_idx.shape
    hits = torch.empty((b, k), dtype=torch.uint8, device=words.device)
    err = _entry("bloom_probe")(words.data_ptr(), word_idx.data_ptr(),
                   bit_mask.data_ptr(), hits.data_ptr(), b, k,
                   words.shape[1],
                   torch.cuda.current_stream(words.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bloom_probe kernel launch failed: CUDA error "
                           f"{err}")
    bloom_probe.launches += 1
    return hits


bloom_probe.launches = 0


def fused_probe(keys: torch.Tensor, words: torch.Tensor, seeds: torch.Tensor,
                s: int):
    """keys (B,) int32 words against the (k, W) ``words`` -> (dup (B,)
    bool, hits (B, k) uint8, pos (B, k) int32), ``seeds`` (k,) int32 words
    (read on the host by a launch: on the CPU; any k). On CUDA one
    launch: the hash in registers, all k gathers, the bit tests and the
    AND. ``fused_probe.launches`` counts its kernel launches (bloom_probe's
    count does not move)."""
    check_hash_operands("fused_probe", keys, seeds, s, 0, None)
    if keys.dim() != 1 or not keys.is_contiguous():
        raise ValueError(f"fused_probe takes contiguous keys (B,); got "
                         f"{tuple(keys.shape)}")
    if (words.dtype != torch.int32 or words.dim() != 2
            or words.shape[0] != seeds.shape[0]
            or not words.is_contiguous()):
        raise ValueError(f"fused_probe: words must be contiguous int32 (k, "
                         f"W) with k = {seeds.shape[0]}, got {words.dtype} "
                         f"{tuple(words.shape)}")
    if words.device != keys.device:
        raise ValueError(f"fused_probe: words are on {words.device}, keys "
                         f"on {keys.device}")
    if keys.device.type == "cpu":
        with plain_region("fused_probe"):
            return fused_probe_plain(keys, words, seeds, s)
    if keys.device.type != "cuda":
        raise ValueError(f"fused_probe runs on cpu or cuda, not "
                         f"{keys.device}")
    b, (k, w) = keys.shape[0], words.shape
    hits = torch.empty((b, k), dtype=torch.uint8, device=keys.device)
    dup = torch.empty((b,), dtype=torch.bool, device=keys.device)
    pos = torch.empty((b, k), dtype=torch.int32, device=keys.device)
    hs, _, dev = launch_seeds(seeds, None, keys.device)
    err = _entry("fused_probe")(
        words.data_ptr(), keys.data_ptr(), hits.data_ptr(), dup.data_ptr(),
        pos.data_ptr(), b, w, hs.data_ptr(), ptr(dev), k, s,
        torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_probe kernel launch failed: CUDA error "
                           f"{err}")
    fused_probe.launches += 1
    return dup, hits, pos


fused_probe.launches = 0
