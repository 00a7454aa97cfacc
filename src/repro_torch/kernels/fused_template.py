"""The fused steps — the port of ``repro/kernels/fused_template.py``.

Two families, each one function in two forms with the same outputs bit for
bit:

* **bitset** (``_make_bitset_kernel_step``): ``bitset_step`` is the
  wrapper — on CUDA tensors it launches the hand-written kernel in
  ``csrc/bitset_step.cu`` or raises; on CPU tensors it runs
  ``bitset_step_plain``, which follows the reference's jnp step (DESIGN
  §3.1/§3.2): probe, decide, sort the enabled positions, keep run heads,
  build the (k, W) deletion and insertion words with an int64
  ``index_add_`` of distinct single-bit masks, apply ``(A & ~D) | I``, and
  take the load delta from the sorted positions. It shares none of the
  kernel's atomics logic, which is what makes it a check on the kernel.
* **counter** (``_make_counter_kernel_step``): ``counter_step`` is the
  wrapper — on CUDA tensors ``csrc/counter_step.cu``, on CPU tensors
  ``counter_step_plain``, which applies the reference jnp step's (d, W)
  delta planes with the borrow / set / carry chains of ``core.packed`` and
  takes the load from the sorted event lists. The kernel instead works per
  event: it never builds a (d, W) delta plane, and one thread owns each
  touched word (its source note says why and what bounds it). So
  ``cfg.kernel_accumulate`` — the reference's switch between delta-plane
  and per-event operands — changes nothing here: on CUDA both values
  launch this one per-event kernel.

Every step updates its filter tensor in place; the caller computes hashes,
the intra-batch join, the randomness and the sorted event lists first, as
the reference does outside its ``pallas_call``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core import batched as _batched
from ..core import packed as _packed
from ..core import u32
from . import build

VARIANT_CODES = {"rsbf": 0, "bsbf": 1, "bsbfsd": 2, "rlbsbf": 3}
# the counter sketches whose decision the kernel computes: a min over the k
# probed cells against a threshold (1 for the nonzero probe), OR'd with the
# intra-batch join where the spec uses it
COUNTER_SKETCHES = ("sbf", "swbf", "cms", "hh")
MAX_PLANES = 16                   # csrc/counter_step.cu::kMaxPlanes


def _check_tensors(kernel: str, want: dict, device) -> None:
    for name, (t, dtype, shape) in want.items():
        if t is None:
            raise ValueError(f"{kernel}: {name} is missing")
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"{kernel}: {name} must be {dtype} {shape}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"expected {device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


# ---------------- bitset family ------------------------------------------ //

def bitset_step_plain(cfg, words, pos, rnd, valid, seen, i_t, load):
    """-> (new words (k, W), dup (B,), inserted (B,), load (k,))."""
    b, k = pos.shape
    w = words.shape[1]
    decide = _batched.make_decision_fn(cfg)
    vals = _packed.probe_packed(words, pos)
    dup, insert, del_mask = decide(vals, valid, seen, i_t, load, rnd)
    sentinel = 32 * w
    spi = _batched.sorted_enabled_positions(
        pos, insert[:, None].expand(b, k), sentinel)
    spd = _batched.sorted_enabled_positions(rnd.del_pos, del_mask, sentinel)
    delta_i = _packed.delta_from_sorted_positions(spi, w)
    delta_d = _packed.delta_from_sorted_positions(spd, w)
    new = (words & ~delta_d) | delta_i
    pre_i = _packed.probe_sorted_packed(words, spi)
    pre_d = _packed.probe_sorted_packed(words, spd)
    post_d = _packed.probe_sorted_packed(new, spd)
    new_load = load + _batched.load_delta_from_sorted(
        spi, pre_i, spd, pre_d, post_d, cfg.s)
    return new, dup, insert, new_load


def _check(cfg, words, pos, rnd, valid, seen, i_t, load):
    k, w = cfg.k, cfg.s_words
    b = pos.shape[0] if pos.dim() == 2 else -1
    _check_tensors("bitset_step", {
        "words": (words, torch.int32, (k, w)),
        "pos": (pos, torch.int32, (b, k)),
        "del_pos": (rnd.del_pos, torch.int32, (b, k)),
        "u_bern": (rnd.u_bern, torch.float32, (b,)),
        "u_aux": (rnd.u_aux, torch.float32, (b, k)),
        "which": (rnd.which, torch.int32, (b,)),
        "valid": (valid, torch.bool, (b,)),
        "seen": (seen, torch.bool, (b,)),
        "i_t": (i_t, torch.int32, (b,)),
        "load": (load, torch.int32, (k,)),
    }, words.device)
    if cfg.variant not in VARIANT_CODES:
        raise ValueError(f"bitset_step runs {tuple(VARIANT_CODES)}, "
                         f"not {cfg.variant!r}")
    if not 1 <= k <= 32:
        raise ValueError(f"bitset_step takes 1 <= k <= 32, got {k}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("bitset_step").bitset_step_launch
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   p, p, p, p, p, p, p, p, p, p, p, p, p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float,
                   ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(cfg, words, pos, rnd, valid, seen, i_t, load, dup, ins,
            del_rows, load_out):
    stream = torch.cuda.current_stream(words.device).cuda_stream
    err = _entry()(words.data_ptr(), words.shape[1], cfg.k, pos.shape[0],
             pos.data_ptr(), rnd.del_pos.data_ptr(), valid.data_ptr(),
             seen.data_ptr(), i_t.data_ptr(), rnd.u_bern.data_ptr(),
             rnd.u_aux.data_ptr(), rnd.which.data_ptr(), load.data_ptr(),
             load_out.data_ptr(), dup.data_ptr(), ins.data_ptr(),
             del_rows.data_ptr(), VARIANT_CODES[cfg.variant], cfg.s,
             float(np.float32(cfg.s)), float(np.float32(cfg.p_star)),
             stream)
    if err != 0:
        raise RuntimeError(f"bitset_step kernel launch failed: CUDA error "
                           f"{err}")


def bitset_step(cfg, words, pos, rnd, valid, seen, i_t, load):
    """One bitset-family step on the (k, W) int32 ``words``, updated in
    place. pos (B, k) int32 positions; ``rnd`` the step's
    ``BatchRandomness``; valid/seen (B,) bool; i_t (B,) int32 stream
    positions; load (k,) int32 batch-entry load. Returns (dup (B,) bool,
    inserted (B,) bool, load (k,) int32). ``bitset_step.launches`` counts
    kernel launches: one per step, three grid launches each."""
    _check(cfg, words, pos, rnd, valid, seen, i_t, load)
    if words.device.type == "cpu":
        new, dup, ins, new_load = bitset_step_plain(
            cfg, words, pos, rnd, valid, seen, i_t, load)
        words.copy_(new)
        return dup, ins, new_load
    if words.device.type != "cuda":
        raise ValueError(f"bitset_step runs on cpu or cuda, not "
                         f"{words.device}")
    b = pos.shape[0]
    dup = torch.empty((b,), dtype=torch.bool, device=words.device)
    ins = torch.empty((b,), dtype=torch.bool, device=words.device)
    del_rows = torch.empty((b,), dtype=torch.int32, device=words.device)
    load_out = load.clone()
    _launch(cfg, words, pos, rnd, valid, seen, i_t, load, dup, ins,
            del_rows, load_out)
    bitset_step.launches += 1
    return dup, ins, load_out


bitset_step.launches = 0


# ---------------- counter family ----------------------------------------- //

def counter_step_plain(cfg, spec, planes, pos, valid, seen, load, ev):
    """-> (new planes (d, W), dup (B,) bool, load (1,) int32), as the
    reference's jnp counter step computes them: probe, decide, subtract the
    ``ev.sub_planes``, set ``ev.set_delta`` to ``cfg.sbf_max`` or add
    ``ev.add_planes``, and the exact nonzero-cell load from the sorted
    event lists. ``ev`` must carry its delta planes (events built with
    ``build_planes=True``)."""
    w = planes.shape[1]
    nzw = _packed.planes_nonzero(planes)
    if spec.probe == "value":
        vals = _packed.probe_cell_values(planes, pos)
    else:
        p = pos.to(torch.int64)
        vals = ((u32.to_u64(nzw[p >> 5]) >> (p & 31)) & 1) != 0
    dup = spec.make_decide(cfg)(vals, valid, seen)
    new = planes
    if spec.has_sub:
        new = _packed.planes_saturating_sub(new, _need(ev.sub_planes,
                                                       "sub_planes"))
    if spec.combine == "set":
        # set-to-Max writes the counter ceiling sbf_max, which may sit
        # below the plane capacity 2^d - 1
        new = _packed.planes_set_value(new, _need(ev.set_delta, "set_delta"),
                                       cfg.sbf_max)
    else:
        new = _packed.planes_saturating_add(new, _need(ev.add_planes,
                                                       "add_planes"))
    # gained: inserted cells that were zero; lost: decremented cells that
    # were nonzero and whose post bit is clear (inserts apply after
    # decrements, so the post bit IS the "was it refreshed" flag). Run
    # heads count each cell once.
    new_nz = _packed.planes_nonzero(new)
    sentinel = 32 * w

    def nz_bit(words, sp):
        got = u32.to_u64(words[torch.clamp(sp >> 5, max=w - 1)])
        return (got >> (sp & 31)) & 1

    gained = (ev.ins_heads & (ev.ins_events < sentinel)
              & (nz_bit(nzw, ev.ins_events) == 0)).sum(dtype=torch.int32)
    lost = torch.zeros((), dtype=torch.int32, device=planes.device)
    if spec.has_sub:
        lost = (ev.sub_heads & (ev.sub_events < sentinel)
                & (nz_bit(nzw, ev.sub_events) == 1)
                & (nz_bit(new_nz, ev.sub_events) == 0)
                ).sum(dtype=torch.int32)
    return new, dup, load + gained - lost


def _need(t, name):
    if t is None:
        raise ValueError(f"counter_step_plain needs ev.{name}: build the "
                         f"events with build_planes=True")
    return t


def _check_counter(cfg, spec, planes, pos, valid, seen, load, ev):
    d, w, k = cfg.n_planes, cfg.s_words, cfg.k
    b = pos.shape[0] if pos.dim() == 2 else -1
    if spec.family != "counter" or spec.name not in COUNTER_SKETCHES:
        raise ValueError(f"counter_step runs {COUNTER_SKETCHES}, not "
                         f"{spec.name!r}")
    if not 1 <= d <= MAX_PLANES:
        raise ValueError(f"counter_step takes 1 <= d <= {MAX_PLANES} "
                         f"planes, got {d}")
    if 32 * w >= 1 << 31:
        raise ValueError(f"counter_step needs cells below 2^31; the "
                         f"sentinel 32·W = {32 * w} is not")
    want = {"planes": (planes, torch.int32, (d, w)),
            "pos": (pos, torch.int32, (b, k)),
            "valid": (valid, torch.bool, (b,)),
            "load": (load, torch.int32, (1,))}
    if spec.uses_seen:
        want["seen"] = (seen, torch.bool, (b,))
    lists = [("ins", ev.ins_events, ev.ins_heads)]
    if spec.has_sub:
        lists.append(("sub", ev.sub_events, ev.sub_heads))
    for name, events, heads in lists:
        n = events.shape[0] if events is not None and events.dim() == 1 \
            else -1
        want[f"{name}_events"] = (events, torch.int64, (n,))
        want[f"{name}_heads"] = (heads, torch.bool, (n,))
    _check_tensors("counter_step", want, planes.device)


def _head_operands(events, heads, cmax: int, sentinel: int):
    """A sorted event list -> the kernel's operands: the run heads' cells,
    moved to the front in order with the rest filled by the sentinel, and
    each head's run length clamped to ``cmax`` (None for cmax == 0, the
    set-to-Max form, which has no count). Static shapes: no host sync."""
    n = events.shape[0]
    keep = heads & (events < sentinel)
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, n)
    cells = torch.full((n + 1,), sentinel, dtype=torch.int32,
                       device=events.device)
    cells.scatter_(0, slot, events.to(torch.int32))
    if cmax == 0:
        return cells[:n], None
    _, cnt = _packed.clamped_run_counts(events, cmax)
    counts = torch.zeros((n + 1,), dtype=torch.int32, device=events.device)
    counts.scatter_(0, slot, cnt.to(torch.int32))
    return cells[:n], counts[:n]


@functools.lru_cache(maxsize=None)
def _counter_entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("counter_step").counter_step_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, i, i, i, p, p, p, i, i, p, p, p,
                   p, p, i, p, p, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def counter_step(cfg, spec, planes, pos, valid, seen, load, ev):
    """One counter-family step on the (d, W) int32 ``planes``, updated in
    place. pos (B, k) int32 cells; valid (B,) bool; seen (B,) bool where
    the spec joins the batch, else None; load (1,) int32 batch-entry
    nonzero-cell count; ``ev`` the step's ``CounterStepDeltas`` (int64
    sorted event lists and their run heads). Returns (dup (B,) bool, load
    (1,) int32). On CUDA the kernel reads only the event lists, whatever
    ``cfg.kernel_accumulate`` says; ``counter_step.launches`` counts its
    launches: one per step, two grid launches each."""
    _check_counter(cfg, spec, planes, pos, valid, seen, load, ev)
    if planes.device.type == "cpu":
        new, dup, new_load = counter_step_plain(cfg, spec, planes, pos,
                                                valid, seen, load, ev)
        planes.copy_(new)
        return dup, new_load
    if planes.device.type != "cuda":
        raise ValueError(f"counter_step runs on cpu or cuda, not "
                         f"{planes.device}")
    d, w = planes.shape
    sentinel = 32 * w
    set_mode = spec.combine == "set"
    sub_cells = sub_counts = None
    if spec.has_sub:
        sub_cells, sub_counts = _head_operands(
            ev.sub_events, ev.sub_heads,
            cfg.sbf_max if set_mode else (1 << d) - 1, sentinel)
    ins_cells, ins_counts = _head_operands(
        ev.ins_events, ev.ins_heads, 0 if set_mode else (1 << d) - 1,
        sentinel)
    b = pos.shape[0]
    dup = torch.empty((b,), dtype=torch.bool, device=planes.device)
    load_out = load.clone()

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _counter_entry()(
        planes.data_ptr(), w, d, b, cfg.k, pos.data_ptr(), valid.data_ptr(),
        ptr(seen if spec.uses_seen else None), int(spec.probe == "value"),
        cfg.count_threshold if spec.thresholded else 1, load.data_ptr(),
        load_out.data_ptr(), dup.data_ptr(), ptr(sub_cells), ptr(sub_counts),
        0 if sub_cells is None else sub_cells.shape[0], ins_cells.data_ptr(),
        ptr(ins_counts), ins_cells.shape[0], int(set_mode), cfg.sbf_max,
        torch.cuda.current_stream(planes.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"counter_step kernel launch failed: CUDA error "
                           f"{err}")
    counter_step.launches += 1
    return dup, load_out


counter_step.launches = 0
