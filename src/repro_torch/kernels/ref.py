"""The reference's oracles by their names, the port of
``repro/kernels/ref.py``: each ``ref_*`` has the reference's signature
and is the plain PyTorch version beside its kernel (``hashmix_plain``,
``bloom_probe_plain``, ``scatter_delta_plain``), on the tensors' device.
Words, keys, seeds and masks are int32 tensors of uint32 bit patterns
(``core.u32``)."""

from __future__ import annotations

import torch

from .bloom_probe import bloom_probe_plain
from .hashmix import hashmix_plain
from .scatter_delta import scatter_delta_plain


def ref_hashmix(keys: torch.Tensor, seeds: torch.Tensor, *, s: int
                ) -> torch.Tensor:
    """(B,) keys, (k,) seeds -> (B, k) int32 positions in [0, s)."""
    return hashmix_plain(keys, seeds, s)


def ref_bloom_probe(words: torch.Tensor, word_idx: torch.Tensor,
                    bit_mask: torch.Tensor) -> torch.Tensor:
    """(k, W) words at (B, k) word indices and masks -> (B, k) uint8."""
    return bloom_probe_plain(words, word_idx, bit_mask)


def ref_scatter_delta(word_idx: torch.Tensor, bit_mask: torch.Tensor, *,
                      w: int) -> torch.Tensor:
    """(B, k) word indices and masks -> the (k, W) OR delta; indices
    outside [0, W) drop."""
    return scatter_delta_plain(word_idx, bit_mask, w)
