"""Packed word operations — the port of the 1-bit half of
``repro.core.packed`` (DESIGN §3.2).

Words are int32 bit-pattern tensors (``core.u32``); bit positions are
int32 or int64 values. The delta builder follows the reference: the batch's
positions arrive sorted per row, each equal-position run keeps its head,
and the heads' single-bit masks are summed into their words with one int64
``index_add_`` — the heads are distinct bits, so within a word the sum IS
the OR, and no read-modify-write or segmented scan is needed.
"""

from __future__ import annotations

import torch

from . import u32

__all__ = ["pack_bits", "unpack_bits", "split_pos", "probe_packed",
           "probe_sorted_packed", "run_heads", "delta_from_sorted_positions",
           "popcount_words", "popcount"]


def split_pos(pos: torch.Tensor):
    """bit position -> (word index int32, single-bit mask as int32 word)."""
    p = pos.to(torch.int64)
    return (p >> 5).to(torch.int32), u32.to_i32(1 << (p & 31))


def pack_bits(bits8: torch.Tensor) -> torch.Tensor:
    """(..., s) {0,1} -> (..., ceil(s/32)) int32 words."""
    s = bits8.shape[-1]
    pad = (-s) % 32
    b = torch.nn.functional.pad(bits8.to(torch.int64), (0, pad))
    b = b.reshape(*b.shape[:-1], -1, 32)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=b.device)
    return u32.to_i32((b * weights).sum(dim=-1))


def unpack_bits(words: torch.Tensor, s: int) -> torch.Tensor:
    """(..., W) int32 words -> (..., s) uint8 {0,1}."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = (u32.to_u64(words)[..., None] >> shifts) & 1
    return b.reshape(*words.shape[:-1], -1)[..., :s].to(torch.uint8)


def probe_packed(words: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """words (k, W), pos (B, k) -> (B, k) uint8 bit values."""
    p = pos.to(torch.int64)
    rows = torch.arange(words.shape[0], device=words.device)[None, :]
    got = u32.to_u64(words[rows, p >> 5])
    return ((got >> (p & 31)) & 1).to(torch.uint8)


def probe_sorted_packed(words: torch.Tensor, sp: torch.Tensor) -> torch.Tensor:
    """Row-aligned probe: words (k, W), sp (k, B) positions -> (k, B) uint8.
    Sentinel positions read a clamped word; mask the result with sp < s."""
    k, w = words.shape
    p = sp.to(torch.int64)
    rows = torch.arange(k, device=words.device)[:, None]
    got = u32.to_u64(words[rows, torch.clamp(p >> 5, max=w - 1)])
    return ((got >> (p & 31)) & 1).to(torch.uint8)


def run_heads(sp: torch.Tensor) -> torch.Tensor:
    """(k, B) sorted -> True at the first element of each equal-value run."""
    head = torch.ones_like(sp, dtype=torch.bool)
    head[:, 1:] = sp[:, 1:] != sp[:, :-1]
    return head


def delta_from_sorted_positions(sp: torch.Tensor, w: int) -> torch.Tensor:
    """(k, B) sorted bit positions -> (k, W) int32 OR-union delta words.
    Disabled lanes carry a sentinel >= 32·W and are dropped."""
    k = sp.shape[0]
    p = sp.to(torch.int64)
    keep = run_heads(p) & (p < 32 * w)
    rows = torch.arange(k, device=sp.device)[:, None]
    idx = torch.where(keep, rows * w + (p >> 5), 0).reshape(-1)
    bit = torch.where(keep, 1 << (p & 31), 0).reshape(-1)
    acc = torch.zeros(k * w, dtype=torch.int64, device=sp.device)
    acc.index_add_(0, idx, bit)
    return u32.to_i32(acc).reshape(k, w)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Elementwise per-word population count: int32 words -> int32."""
    return u32.popcount_u64(u32.to_u64(words)).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-row population count: (k, W) words -> (k,) int32."""
    return u32.popcount_u64(u32.to_u64(words)).sum(dim=-1).to(torch.int32)
