"""hashmix: fused k-way murmur-mix hashing — keys (B,) -> positions (B, k).

The port of ``repro/kernels/hashmix.py::hashmix``, with the blocked layout
of DESIGN §3.3 in the same call. ``hashmix`` is the wrapper: on a CUDA
tensor it launches the hand-written kernel in ``csrc/hashmix.cu`` (note
there: what bounds it and how) or raises; on a CPU tensor it runs the
plain versions, ``hashmix_plain`` and ``positions_plain``. The bitset step
and ``fused_probe`` hash inside their own kernels (``csrc/hashmix.cuh``,
the one definition of the hash), so on the card only the counter family's
steps, the dense8 steps and oracle, ``Dedup.estimate`` and
``ops.hash_positions`` launch this kernel.

A launch reads the seeds on the host, into the kernel's argument block:
callers pass them as a CPU tensor (``host_seeds`` refuses seeds on the
card). Past ``MAX_ROWS`` rows (the reference takes any k >= 1) the
argument block cannot hold them: ``launch_seeds`` then copies them to the
card on the launch's stream, from pinned memory and without a host wait,
and the kernels read them there.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core import u32
from . import build
from .scope import plain_region

M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
MAX_ROWS = 32                     # csrc/hashmix.cuh::kMaxHashRows: seeds
                                  # in the argument block up to here


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


def positions_plain(keys: torch.Tensor, seeds: torch.Tensor, s: int,
                    block_bits: int = 0,
                    block_seeds: torch.Tensor | None = None) -> torch.Tensor:
    """The positions of either layout in plain PyTorch: ``hashmix_plain``,
    or for ``block_bits`` > 0 the blocked layout as the reference computes
    it — ``hb % n_blocks`` and ``h & (bsize - 1)`` are hashmix at ``s =
    n_blocks`` and at ``s = bsize``, the product taken in int64 and kept
    to its low 32 bits."""
    if block_bits <= 0:
        return hashmix_plain(keys, seeds, s)
    bsize = 1 << block_bits
    n_blocks = max(1, s // bsize)
    block = hashmix_plain(keys, block_seeds, n_blocks).to(torch.int64)
    bit = hashmix_plain(keys, seeds, bsize)
    return u32.to_i32(block * bsize + bit)


def check_hash_operands(kernel: str, keys, seeds, s: int, block_bits: int,
                        block_seeds) -> None:
    """What every hashing wrapper takes: int32 keys and seeds (k,), s in
    [1, 2^31], and block seeds (k,) for the blocked layout."""
    for name, t in (("keys", keys), ("seeds", seeds),
                    ("block_seeds", block_seeds)):
        if t is not None and t.dtype != torch.int32:
            raise TypeError(f"{kernel}: {name} must be int32 words, got "
                            f"{t.dtype}")
    if seeds.dim() != 1 or seeds.shape[0] < 1:
        raise ValueError(f"{kernel}: seeds must be (k,) with k >= 1, got "
                         f"{tuple(seeds.shape)}")
    if not 1 <= s <= 1 << 31:
        raise ValueError(f"{kernel}: s={s} outside [1, 2^31]")
    if block_bits > 0:
        if block_seeds is None:
            raise ValueError("blocked layout needs block_seeds")
        if block_seeds.shape != seeds.shape:
            raise ValueError(f"{kernel}: block_seeds must be "
                             f"{tuple(seeds.shape)}, got "
                             f"{tuple(block_seeds.shape)}")
        if not 1 <= block_bits <= 31:
            raise ValueError(f"{kernel}: block_bits={block_bits} outside "
                             f"[1, 31]")


def host_seeds(seeds: torch.Tensor, block_seeds: torch.Tensor | None
               ) -> tuple:
    """The seeds (and the block seeds, or None) as contiguous CPU int32
    tensors, as a launch reads them into its argument block. Seeds on the
    card are refused: copying them to the host would wait for the card at
    every launch. Keep the result alive until the launch returns."""
    for name, x in (("seeds", seeds), ("block_seeds", block_seeds)):
        if x is not None and x.device.type != "cpu":
            raise ValueError(f"a kernel launch reads its {name} on the "
                             f"host: pass them as a CPU tensor, not on "
                             f"{x.device}")
    return tuple(None if x is None else x.contiguous()
                 for x in (seeds, block_seeds))


def launch_seeds(seeds: torch.Tensor, block_seeds: torch.Tensor | None,
                 device) -> tuple:
    """(host seeds, host block seeds or None, device seeds or None) for a
    launch on ``device``: ``host_seeds``, and for k > ``MAX_ROWS`` the 2k
    words the kernel reads from device memory instead — the probe seeds,
    then the block seeds (zeros without them) — copied from pinned host
    memory on the current stream, so the host does not wait. Keep all
    three alive until the launch returns."""
    hs, hb = host_seeds(seeds, block_seeds)
    if hs.shape[0] <= MAX_ROWS:
        return hs, hb, None
    both = torch.cat([hs, torch.zeros_like(hs) if hb is None else hb])
    return hs, hb, both.pin_memory().to(device, non_blocking=True)


def ptr(t: torch.Tensor | None):
    """A tensor's address for a C call, None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("hashmix").hashmix_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, p, i, p, p, p, i, ctypes.c_uint32, i, p]
    fn.restype = ctypes.c_int
    return fn


def hashmix(keys: torch.Tensor, seeds: torch.Tensor, *, s: int,
            block_bits: int = 0,
            block_seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Positions (B, k) int32 of keys (B,) int32 words. ``seeds`` (k,),
    and ``block_seeds`` (k,) for ``block_bits`` > 0, are int32 words: on
    the keys' device for the plain versions, on the CPU for a launch,
    which reads them on the host (``launch_seeds``; any k).
    ``hashmix.launches`` counts kernel launches: one per call on CUDA,
    either layout."""
    check_hash_operands("hashmix", keys, seeds, s, block_bits, block_seeds)
    if keys.dim() != 1:
        raise ValueError(f"hashmix takes keys (B,); got "
                         f"{tuple(keys.shape)}")
    if not (keys.is_contiguous() and seeds.is_contiguous()):
        raise ValueError("hashmix takes contiguous tensors")
    if keys.device.type == "cpu":
        with plain_region("hashmix"):
            return positions_plain(keys, seeds, s, block_bits, block_seeds)
    if keys.device.type != "cuda":
        raise ValueError(f"hashmix runs on cpu or cuda, not {keys.device}")
    out = torch.empty((keys.shape[0], seeds.shape[0]), dtype=torch.int32,
                      device=keys.device)
    hs, hb, dev = launch_seeds(seeds, block_seeds if block_bits > 0
                               else None, keys.device)
    err = _entry()(keys.data_ptr(), out.data_ptr(), keys.shape[0],
                   hs.data_ptr(), ptr(hb), ptr(dev), hs.shape[0], s,
                   max(block_bits, 0),
                   torch.cuda.current_stream(keys.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"hashmix kernel launch failed: CUDA error {err}")
    hashmix.launches += 1
    return out


hashmix.launches = 0
