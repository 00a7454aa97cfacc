"""Public wrappers around the port's probe and scatter kernels — the port of
``repro/kernels/ops.py``.

``fused_probe`` is hashmix -> split -> bloom_probe -> AND-reduce, the
paper's "report duplicate / distinct" decision of Algorithms 1-4, which
the reference runs as two kernel launches: here it is one kernel
(``bloom_probe.fused_probe``). Each function runs where its tensors lie:
the hand-written kernels on CUDA, their plain versions on the CPU. Words,
keys, seeds and masks are int32 tensors of uint32 bit patterns
(``core.u32``). As in the reference, ``hash_positions`` and
``fused_probe`` take their seeds on any device; a launch reads them on the
host, so seeds given on the card are copied to the host once per call,
which waits for the card. The engine never does that: it keeps its seeds
on the CPU, and the kernel wrappers below ``ops`` refuse seeds on the card
(``hashmix.host_seeds``).

One difference from the reference: ``probe`` does not refuse filter rows
over 8 MiB. That limit was the TPU's VMEM budget for a row pinned in fast
memory; the CUDA kernel gathers from device memory, where it means nothing.
"""

from __future__ import annotations

import torch

from .bloom_probe import bloom_probe
from .bloom_probe import fused_probe as _fused_probe
from .hashmix import hashmix
from .scatter_delta import scatter_delta


def _host(seeds: torch.Tensor) -> torch.Tensor:
    """The seeds on the host; seeds on the card are copied, which waits."""
    return seeds if seeds.device.type == "cpu" else seeds.cpu()


def hash_positions(keys: torch.Tensor, seeds: torch.Tensor, s: int
                   ) -> torch.Tensor:
    """(B,) keys -> (B, k) int32 positions (the hashmix kernel); ``seeds``
    (k,) on any device."""
    return hashmix(keys, _host(seeds), s=s)


def probe(words: torch.Tensor, word_idx: torch.Tensor,
          bit_mask: torch.Tensor) -> torch.Tensor:
    """(k, W) packed filter + (B, k) probes -> (B, k) uint8 hits."""
    return bloom_probe(words, word_idx, bit_mask)


def fused_probe(keys: torch.Tensor, words: torch.Tensor, seeds: torch.Tensor,
                s: int):
    """keys (B,) -> (dup (B,) bool, hits (B, k) uint8, pos (B, k) int32),
    one kernel launch on CUDA; ``seeds`` (k,) on any device."""
    return _fused_probe(keys, words, _host(seeds), s)


def scatter_or(words: torch.Tensor, word_idx: torch.Tensor,
               bit_mask: torch.Tensor) -> torch.Tensor:
    """Set bits: words (k, W) | the OR-delta of (B, k) masks. Disabled
    lanes: word_idx = -1 (or any index outside [0, W))."""
    return words | scatter_delta(word_idx, bit_mask, w=words.shape[1])


def scatter_andnot(words: torch.Tensor, word_idx: torch.Tensor,
                   bit_mask: torch.Tensor) -> torch.Tensor:
    """Clear bits (same contract as ``scatter_or``)."""
    return words & ~scatter_delta(word_idx, bit_mask, w=words.shape[1])
