"""Vectorized uint32 hash family for Bloom-filter probing and key routing —
the port of ``repro.core.hashing``.

murmur3's 32-bit finalizer (fmix32) seeded per hash slot, reduced to a bit
position by mask (power-of-two ``s``) or modulo. Keys and hashes travel as
int32 bit patterns; the arithmetic runs on int64 values masked to 32 bits
(``core.u32``). ``hash_positions`` is one call of the hashmix wrapper
(``kernels/hashmix.py``): its kernel on a CUDA tensor, either layout in
one launch, and its plain form on the CPU. It is not the only place the
hash runs on the card: the bitset step and ``ops.fused_probe`` hash their
keys inside their own kernels (``kernels/csrc/hashmix.cuh``) and never call
it; the counter family, the dense8 steps and oracle, ``Dedup.estimate`` and
``ops.hash_positions`` do.
"""

from __future__ import annotations

import numpy as np
import torch

from . import prng, u32
from ..kernels.hashmix import hashmix as _hashmix_kernel

__all__ = ["fmix32", "hash_slots", "hash_positions", "route_hash",
           "range_bucket", "derive_seeds", "uniform_positions"]

_GOLDEN = np.uint32(0x9E3779B9)
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 values in [0, 2^32) -> int64 values."""
    x = x ^ (x >> 16)
    x = u32.mul32(x, M1)
    x = x ^ (x >> 13)
    x = u32.mul32(x, M2)
    return x ^ (x >> 16)


def derive_seeds(base_seed: int, k: int, channel: int = 0) -> np.ndarray:
    """k decorrelated uint32 seeds (host numpy; ``channel`` separates probe,
    block, routing and deletion uses so they never alias)."""
    base = np.uint32(base_seed & 0xFFFFFFFF) ^ np.uint32(
        (channel * M2) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        idx = (np.arange(1, k + 1, dtype=np.uint32) * _GOLDEN) ^ base
    x = idx
    x = x ^ (x >> 16)
    x = (x * np.uint32(M1)) & np.uint32(0xFFFFFFFF)
    x = x ^ (x >> 13)
    x = (x * np.uint32(M2)) & np.uint32(0xFFFFFFFF)
    x = x ^ (x >> 16)
    return x.astype(np.uint32)


def hash_slots(keys: torch.Tensor, seeds: torch.Tensor) -> torch.Tensor:
    """keys (...,) and seeds (k,) int32 words -> (..., k) int64 hashes."""
    return fmix32(u32.to_u64(keys)[..., None] ^ u32.to_u64(seeds))


def hash_positions(keys: torch.Tensor, seeds: torch.Tensor, s: int,
                   block_bits: int = 0,
                   block_seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Bit positions in [0, s) for each of the k filters -> (..., k) int32
    for keys (...,): one hashmix call over the flattened keys. ``seeds``
    (k,) int32 words; a launch reads them on the host and refuses them on
    the card, so the step builders make them on the CPU (``derive_seeds``
    converted once), and a step copies nothing to the card for them.

    ``block_bits`` > 0 selects the blocked layout (DESIGN §3.3): a hash
    over ``block_seeds`` picks a 2^block_bits-bit block per filter and the
    bit lands inside it — on the card in the same launch."""
    flat = keys.reshape(-1)
    shape = (*keys.shape, seeds.shape[0])
    return _hashmix_kernel(flat, seeds, s=s, block_bits=block_bits,
                           block_seeds=block_seeds).view(shape)


def route_hash(keys: torch.Tensor, n_shards: int, base_seed: int
               ) -> torch.Tensor:
    """Shard id in [0, n_shards) (channel 7: independent of every probe)."""
    seed = int(derive_seeds(base_seed, 1, channel=7)[0])
    h = fmix32(u32.to_u64(keys) ^ seed)
    if n_shards & (n_shards - 1) == 0:
        return (h & (n_shards - 1)).to(torch.int32)
    return (h % n_shards).to(torch.int32)


def range_bucket(keys: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """Router bucket in [0, n_buckets) by contiguous key range (DESIGN §4.4)."""
    k = u32.to_u64(keys)
    if n_buckets & (n_buckets - 1) == 0:
        shift = 32 - (n_buckets.bit_length() - 1)
        if shift >= 32:
            return torch.zeros(keys.shape, dtype=torch.int32,
                               device=keys.device)
        return (k >> shift).to(torch.int32)
    stride = (1 << 32) // n_buckets + 1
    return torch.clamp(k // stride, max=n_buckets - 1).to(torch.int32)


def uniform_positions(rng: torch.Tensor, shape, s: int,
                      partitionable: bool = True) -> torch.Tensor:
    """Uniform random bit positions in [0, s), int32 — the reference's
    ``jax.random.randint(rng, shape, 0, s)`` bit for bit under either
    threefry layout (``core.prng.randint``)."""
    return prng.randint(rng, shape, 0, s, partitionable)
