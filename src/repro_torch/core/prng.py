"""Threefry-2x32, bit-exact with ``jax.random``.

The randomized variants draw every random input of a batched step from the
state's threefry key (``core.batched.draw_randomness``), and the engine's
determinism contract (DESIGN §2, §3.8) pins those draws. This module
reproduces ``jax.random``'s ``PRNGKey``, ``split``, ``fold_in``, raw
32-bit ``random_bits``, ``uniform`` (float32) and ``randint`` (int32)
exactly, in both of JAX's counter layouts (``jax_threefry_partitionable``):

* ``partitionable=True`` (JAX's default since 0.5): element i of a draw
  hashes the 64-bit counter i, split as (hi, lo) words, and a 32-bit draw
  XORs the two output words;
* ``partitionable=False`` (the original layout, under which the reference's
  pinned digests were captured): a draw of n words hashes the counters
  0..n-1 as two halves, (i, i + n/2), and concatenates the outputs.

``fold_in`` is the same in both.

JAX keeps the layout in one process-wide flag. The port takes it as an
argument instead, fixed when an engine is built (``Dedup(...,
partitionable=)``) and handed down to the one function that draws
(``core.batched.draw_randomness``): a stream keeps the layout it started
under, and engines of both layouts run side by side in one process — the
parity tests follow the installed JAX's layout while the pinned-digest
checks need the original one.

A key is a (2,) int32 word tensor (the bit pattern of JAX's ``key_data``);
it is the explicit generator the engine carries in ``FilterState.rng``. A
tenant fleet carries T keys as one (T, 2) tensor: every function here takes
a key with leading axes and draws for each row what the one-key call draws
with that row (``jax.vmap`` of the same call), in one broadcast evaluation
rather than a loop over rows. The
arithmetic runs on int64 values masked to 32 bits (``core.u32``), on the
key's device, with no host round trip.
"""

from __future__ import annotations

import math

import torch

from . import u32
from .device import resolve_device

_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor):
    """The Threefry-2x32 block function (20 rounds). key (..., 2) int32
    words; x0/x1 int64 counter words in [0, 2^32) -> two int64 output
    words. A key with leading axes hashes the counters once per key row:
    key (*lead, 2) and counters (n,) give (*lead, n)."""
    k = u32.to_u64(key)
    k0, k1 = k[..., 0], k[..., 1]
    if key.dim() > 1:
        k0, k1 = k0[..., None], k1[..., None]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & u32.MASK
    x1 = (x1 + ks[1]) & u32.MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & u32.MASK
            x1 = u32.rotl32(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & u32.MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & u32.MASK
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data with 64-bit types off: the
    seed becomes a 32-bit integer, so the high word is 0. On ``cuda``
    unless the caller passes ``device="cpu"`` (``core.device``)."""
    return u32.to_i32(torch.tensor([0, int(seed) & u32.MASK],
                                   dtype=torch.int64,
                                   device=resolve_device(device)))


def _counters(n: int, device):
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & u32.MASK


def _threefry_flat(key: torch.Tensor, n: int) -> torch.Tensor:
    """The original layout's hash of the counters 0..n-1 -> (*lead, n)
    int64 for a key (*lead, 2): each key row hashes its own counters."""
    half = (n + 1) // 2
    c = torch.arange(2 * half, dtype=torch.int64, device=key.device)
    c[n:] = 0                                   # odd n pads one zero counter
    y0, y1 = threefry2x32(key, c[:half], c[half:])
    return torch.cat([y0, y1], dim=-1)[..., :n]


def split(key: torch.Tensor, num: int = 2, partitionable: bool = True
          ) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> (*lead, num, 2) int32 words for a
    key (*lead, 2): one split per key row, in one broadcast evaluation."""
    lead = key.shape[:-1]
    if not partitionable:
        return u32.to_i32(_threefry_flat(key, 2 * num)
                          .reshape(*lead, num, 2))
    hi, lo = _counters(num, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return u32.to_i32(torch.stack([b0, b1], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``. An int folds every row of a key
    (*lead, 2) -> (*lead, 2); a (n,) tensor of data folds one (2,) key
    once per element -> (n, 2), as ``jax.vmap(fold_in, (None, 0))``."""
    if isinstance(data, torch.Tensor):
        if key.dim() != 1 or data.dim() != 1:
            raise ValueError("fold_in takes a (2,) key with (n,) data")
        lo = data.to(device=key.device, dtype=torch.int64) & u32.MASK
    else:
        lo = torch.tensor([int(data) & u32.MASK], dtype=torch.int64,
                          device=key.device)
    b0, b1 = threefry2x32(key, torch.zeros_like(lo), lo)
    out = u32.to_i32(torch.stack([b0, b1], dim=-1))
    return out if isinstance(data, torch.Tensor) else out[..., 0, :]


def random_bits(key: torch.Tensor, shape, partitionable: bool = True
                ) -> torch.Tensor:
    """32 random bits per element -> int64 values in [0, 2^32), shape
    (*lead, *shape) for a key (*lead, 2)."""
    shape = tuple(key.shape[:-1]) + tuple(shape)
    n = math.prod(shape[key.dim() - 1:])
    if not partitionable:
        return _threefry_flat(key, n).reshape(shape)
    hi, lo = _counters(n, key.device)
    b0, b1 = threefry2x32(key, hi, lo)
    return (b0 ^ b1).reshape(shape)


def uniform(key: torch.Tensor, shape, partitionable: bool = True
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1) float32: the top 23
    random bits become the mantissa of a float in [1, 2), minus 1."""
    bits = (random_bits(key, shape, partitionable) >> 9) | 0x3F800000
    floats = u32.to_i32(bits).view(torch.float32) - 1.0
    return torch.clamp(floats, min=0.0)


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            partitionable: bool = True) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)``: two bit
    streams from a 2-way split, reduced mod the span with the
    ``2^16 mod span`` multiplier, in wrapping uint32 as JAX does."""
    ks = split(key, 2, partitionable)
    k1, k2 = ks[..., 0, :], ks[..., 1, :]
    higher = random_bits(k1, shape, partitionable)
    lower = random_bits(k2, shape, partitionable)
    span = max(1, int(maxval) - int(minval))
    # the square wraps in uint32 too: for span > 2^16 it is 2^32 -> 0
    mult = ((((1 << 16) % span) ** 2) & u32.MASK) % span
    off = ((higher % span) * mult) & u32.MASK
    off = (off + lower % span) & u32.MASK
    return (off % span + int(minval)).to(torch.int32)
