"""Packed word operations — the port of ``repro.core.packed`` (DESIGN
§3.2/§3.6).

Words are int32 bit-pattern tensors (``core.u32``); bit positions are
int32 or int64 values. The delta builder follows the reference: the batch's
positions arrive sorted per row, each equal-position run keeps its head,
and the heads' single-bit masks are summed into their words with one int64
``index_add_`` — the heads are distinct bits, so within a word the sum IS
the OR, and no read-modify-write or segmented scan is needed.

The counter half stores d-bit cells as d bit-planes, plane p holding bit p
of every cell (DESIGN §3.6): saturating subtract and add are borrow and
carry chains of word ops, set-to-value is the ``(A & ~D) | I`` form per
plane, and a batch's per-cell event counts reach plane form through one
collision-free scatter-add of the sorted events' run heads.
"""

from __future__ import annotations

import torch

from . import u32

__all__ = ["pack_bits", "unpack_bits", "split_pos", "probe_packed",
           "probe_cell_values", "probe_sorted_packed", "run_heads",
           "scatter_or", "scatter_andnot", "delta_from_sorted_positions", "popcount_words", "popcount",
           "pack_cells", "unpack_cells", "planes_nonzero",
           "count_field_chunks", "counts_to_planes", "run_heads_1d",
           "clamped_run_counts", "count_planes_from_sorted",
           "planes_saturating_sub", "planes_saturating_add",
           "planes_set_value"]


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


def _bit_delta_rows(w: int, w_idx: torch.Tensor, mask: torch.Tensor
                    ) -> torch.Tensor:
    """(..., k) word indices and int32 mask words -> the (k, W) int32
    OR-union of each row's masks. A negative index counts from the end,
    as in the reference's scatter; one still out of range is dropped."""
    k = w_idx.shape[-1]
    idx = w_idx.reshape(-1, k).T.to(torch.int64)               # (k, B)
    idx = torch.where(idx < 0, idx + w, idx)
    bit = torch.arange(32, dtype=torch.int64, device=idx.device)
    on = (u32.to_u64(mask.reshape(-1, k).T)[..., None] >> bit) & 1
    keep = (on == 1) & ((idx >= 0) & (idx < w))[..., None]
    sp = torch.where(keep, idx[..., None] * 32 + bit, 32 * w)
    return delta_from_sorted_positions(
        torch.sort(sp.reshape(k, -1), dim=-1).values, w)


def scatter_or(words: torch.Tensor, w_idx: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Set bits: words (k, W); w_idx / mask (..., k), the masks int32 bit
    patterns. Out-of-range indices drop (the reference's per-element
    enable masks), unlike ``kernels/ops.py``, which clamps."""
    return words | _bit_delta_rows(words.shape[1], w_idx, mask)


def scatter_andnot(words: torch.Tensor, w_idx: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Clear bits (the same contract as ``scatter_or``)."""
    return words & ~_bit_delta_rows(words.shape[1], w_idx, mask)


def popcount_words(words: torch.Tensor) -> torch.Tensor:
    """Elementwise per-word population count: int32 words -> int32."""
    return u32.popcount_u64(u32.to_u64(words)).to(torch.int32)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Per-row population count: (k, W) words -> (k,) int32."""
    return u32.popcount_u64(u32.to_u64(words)).sum(dim=-1).to(torch.int32)


# ------------------------------------------------------------------ planes //
# Counter cells as d bit-planes (DESIGN §3.6): plane p holds bit p of every
# cell's value, 32 cells per word. Bitwise ops on the int32 words act on
# the uint32 bits exactly, so the chains below need no value conversion.

def probe_cell_values(planes: torch.Tensor, pos: torch.Tensor
                      ) -> torch.Tensor:
    """planes (d, W), pos (..., k) cell positions -> (..., k) int32 cell
    values: one word gather per plane, bit test, shift-OR."""
    p = pos.to(torch.int64)
    w_idx, bit = p >> 5, p & 31
    vals = torch.zeros(pos.shape, dtype=torch.int64, device=planes.device)
    for q in range(planes.shape[0]):
        vals |= ((u32.to_u64(planes[q][w_idx]) >> bit) & 1) << q
    return vals.to(torch.int32)


def pack_cells(cells: torch.Tensor, d: int) -> torch.Tensor:
    """(..., s) integer cells in [0, 2^d) -> (d, ..., W) int32 bit-planes."""
    c = cells.to(torch.int64)
    return torch.stack([pack_bits((c >> q) & 1) for q in range(d)])


def unpack_cells(planes: torch.Tensor, s: int) -> torch.Tensor:
    """(d, ..., W) int32 bit-planes -> (..., s) int32 cell values."""
    out = None
    for q in range(planes.shape[0]):
        bit = unpack_bits(planes[q], s).to(torch.int32) << q
        out = bit if out is None else out + bit
    return out


def planes_nonzero(planes: torch.Tensor) -> torch.Tensor:
    """(d, ..., W) -> (..., W) word with bit j set iff cell j != 0."""
    nz = planes[0]
    for q in range(1, planes.shape[0]):
        nz = nz | planes[q]
    return nz


def count_field_chunks(d: int) -> int:
    """Chunk words per filter word for the d-bit count-field accumulator."""
    return -(-32 // (32 // d))


def counts_to_planes(acc: torch.Tensor, d: int, w: int) -> torch.Tensor:
    """(W·n_chunks,) count-field accumulator words -> (d, W) bit-planes.

    Chunk word ``w·n_chunks + c`` holds cells ``[c·cpc, (c+1)·cpc)`` of
    filter word w as d-bit fields (cpc = 32 // d cells per chunk); this
    unscrambles them back to plane form. d == 2 takes the reference's
    5-step bit-compaction fast path."""
    if d == 1:
        return acc.reshape(1, w)
    nc = count_field_chunks(d)
    a = u32.to_u64(acc).reshape(w, nc)
    if d == 2:
        planes = []
        for q in range(2):
            halves = []
            for c in range(2):
                x = (a[:, c] >> q) & 0x55555555
                x = (x | (x >> 1)) & 0x33333333
                x = (x | (x >> 2)) & 0x0F0F0F0F
                x = (x | (x >> 4)) & 0x00FF00FF
                x = (x | (x >> 8)) & 0x0000FFFF
                halves.append(x)
            planes.append(halves[0] | (halves[1] << 16))
        return u32.to_i32(torch.stack(planes))
    cpc = 32 // d
    planes = []
    for q in range(d):
        p = torch.zeros((w,), dtype=torch.int64, device=acc.device)
        for t in range(32):
            c, tl = t // cpc, t % cpc
            p |= ((a[:, c] >> (d * tl + q)) & 1) << t
        planes.append(p)
    return u32.to_i32(torch.stack(planes))


def run_heads_1d(sp: torch.Tensor) -> torch.Tensor:
    """(..., n) sorted along the last axis -> True at the first event of
    each equal-value run of its row."""
    head = torch.ones_like(sp, dtype=torch.bool)
    head[..., 1:] = sp[..., 1:] != sp[..., :-1]
    return head


def clamped_run_counts(sp: torch.Tensor, cmax: int):
    """(..., n) event cells SORTED along the last axis -> (head bool, cnt
    int64): run-head flags and each event's run length in its row clamped
    to ``cmax`` (exact at every head, the only places it is read). Caps up
    to 17 count with cmax - 1 shifted equality compares, wider ones with
    two binary searches of the sorted row against itself, as the reference
    does; the outputs are equal."""
    n = sp.shape[-1]
    head = run_heads_1d(sp)
    if cmax <= 1:
        return head, torch.ones(sp.shape, dtype=torch.int64,
                                device=sp.device)
    if cmax - 1 > 16:
        lo = torch.searchsorted(sp, sp, side="left")
        hi = torch.searchsorted(sp, sp, side="right")
        return head, torch.clamp(hi - lo, max=cmax)
    cnt = torch.ones(sp.shape, dtype=torch.int64, device=sp.device)
    ext = torch.cat([sp, torch.full((*sp.shape[:-1], cmax - 1), -1,
                                    dtype=sp.dtype, device=sp.device)], -1)
    for r in range(1, cmax):
        cnt += sp == ext[..., r:r + n]
    return head, cnt


def count_planes_from_sorted(sp: torch.Tensor, head: torch.Tensor,
                             cnt: torch.Tensor, d: int, w: int
                             ) -> torch.Tensor:
    """Sorted event cells + clamped head counts -> (d, W) count bit-planes.

    Heads are unique per cell, so each form below is one collision-free
    int64 scatter-add per event: for d <= 2 each count as a d-bit field of
    the chunked accumulator, unscrambled by ``counts_to_planes``; for d > 2
    each count's d plane bits as one row of a (W, d) accumulator, then
    transposed. Sentinel cells (>= 32·W) are dropped."""
    p = sp.to(torch.int64)
    keep = head & (p < 32 * w)
    t = p & 31
    masked = torch.where(keep, cnt.to(torch.int64), 0)
    if d <= 2:
        cpc = 32 // d
        nc = count_field_chunks(d)
        fidx = torch.where(keep, (p >> 5) * nc + t // cpc, 0)
        acc = torch.zeros((w * nc,), dtype=torch.int64, device=sp.device)
        acc.index_add_(0, fidx, masked << (d * (t % cpc)))
        return counts_to_planes(u32.to_i32(acc), d, w)
    widx = torch.where(keep, p >> 5, 0)
    q = torch.arange(d, device=sp.device)
    vals = ((masked[:, None] >> q) & 1) << t[:, None]            # (E, d)
    acc = torch.zeros((w, d), dtype=torch.int64, device=sp.device)
    acc.index_add_(0, widx, vals)
    return u32.to_i32(acc.T.contiguous())


def planes_saturating_sub(planes: torch.Tensor, counts: torch.Tensor
                          ) -> torch.Tensor:
    """Per-cell ``max(value - count, 0)`` as a borrow chain of word ops;
    ``counts`` (d, ..., W) bit-planes, each count already clamped into
    [0, 2^d). Cells whose final borrow is set saturate to 0."""
    d = planes.shape[0]
    if counts.shape[0] != d:
        raise ValueError(f"planes {tuple(planes.shape)} and counts "
                         f"{tuple(counts.shape)} differ in d")
    borrow = torch.zeros_like(planes[0])
    diffs = []
    for q in range(d):
        a, c = planes[q], counts[q]
        diffs.append(a ^ c ^ borrow)
        borrow = (~a & (c | borrow)) | (c & borrow)
    return torch.stack([x & ~borrow for x in diffs])


def planes_saturating_add(planes: torch.Tensor, addend: torch.Tensor
                          ) -> torch.Tensor:
    """Per-cell ``min(value + addend, 2^d - 1)`` as a carry chain of word
    ops; overflowing cells saturate to all ones."""
    d = planes.shape[0]
    if addend.shape[0] != d:
        raise ValueError(f"planes {tuple(planes.shape)} and addend "
                         f"{tuple(addend.shape)} differ in d")
    carry = torch.zeros_like(planes[0])
    sums = []
    for q in range(d):
        a, c = planes[q], addend[q]
        sums.append(a ^ c ^ carry)
        carry = (a & c) | (a & carry) | (c & carry)
    return torch.stack([x | carry for x in sums])


def planes_set_value(planes: torch.Tensor, delta: torch.Tensor, value
                     ) -> torch.Tensor:
    """Set every cell selected by the OR-union word ``delta`` to ``value``:
    plane p gets ``A | delta`` where value's bit p is 1 and ``A & ~delta``
    where it is 0. ``value`` is an int, or a 0-dim integer tensor (a
    tenant's Max, DESIGN §4.6) read on the device: plane p then gets
    ``(A & ~delta) | (delta & mask_p)``, ``mask_p`` all ones iff bit p is
    set — the same words."""
    if not isinstance(value, torch.Tensor):
        value = int(value)
        return torch.stack([(planes[q] | delta) if (value >> q) & 1
                            else (planes[q] & ~delta)
                            for q in range(planes.shape[0])])
    v = value.to(torch.int32)
    return torch.stack([(planes[q] & ~delta) | (delta & -((v >> q) & 1))
                        for q in range(planes.shape[0])])
