"""The fused steps — the port of ``repro/kernels/fused_template.py``.

Two families, each one function in two forms with the same outputs bit for
bit:

* **bitset** (``_make_bitset_kernel_step``): ``bitset_step`` is the
  wrapper — on CUDA tensors it launches the hand-written kernel in
  ``csrc/bitset_step.cu``, which hashes the keys itself, or raises; on CPU
  tensors it hashes with the plain hashmix and runs
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
  event, on the sorted int64 event lists as the step builds them: it never
  builds a (d, W) delta plane, derives the run heads and clamped run
  lengths itself, and one thread owns each touched word, found by a merge
  path over the two lists (its source note says why and what bounds it).
  So ``cfg.kernel_accumulate`` — the reference's switch between
  delta-plane and per-event operands — changes nothing here: on CUDA both
  values launch this one per-event kernel.

Both take a leading tenant axis (DESIGN §4.6): a fleet's T filters step
in one launch of each kernel, whose grid carries the tenant axis where the
reference vmaps its kernel over it, and one filter is a fleet of one. The
counter step is also the reference kernel's ``params_aware=True`` form:
each tenant's threshold and set-to-Max value are (T,) device rows that the
kernel reads itself.

Every step updates its filter tensor in place; the caller computes the
intra-batch join, the randomness and the sorted event lists first, as the
reference does outside its ``pallas_call``, and the counter step's
positions; the bitset kernel hashes its keys inside its launches.
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
from .common import COUNTER_TILE, DEFAULT_CHUNK_B, DEFAULT_TILE_W
from .hashmix import (check_hash_operands, launch_seeds, positions_plain,
                      ptr)
from .scope import plain_region

VARIANT_CODES = {"rsbf": 0, "bsbf": 1, "bsbfsd": 2, "rlbsbf": 3}
# the counter sketches whose decision the kernel computes: a min over the k
# probed cells against a threshold (1 for the nonzero probe), OR'd with the
# intra-batch join where the spec uses it
COUNTER_SKETCHES = ("sbf", "swbf", "cms", "hh")
MAX_PLANES = 32                   # csrc/counter_step.cu::kMaxPlanes
INT_MAX = (1 << 31) - 1


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


def make_fused_step(cfg, spec=None, *, tile_w: int = DEFAULT_TILE_W,
                    chunk_b: int = DEFAULT_CHUNK_B,
                    interpret: bool | None = None,
                    params_aware: bool = False, device=None):
    """The reference's kernel-step generator, over
    ``core.batched.make_templated_step``: the step of ``cfg``'s
    ``SketchSpec`` (or an explicit ``spec``) on ``device`` (``cuda`` unless
    the caller passes ``"cpu"``), whose fused step is ``bitset_step`` or
    ``counter_step`` above. ``tile_w``, ``chunk_b`` and ``interpret`` are
    accepted and change nothing: they were the TPU kernel's W tile, its
    event chunk and its interpret switch, and the CUDA kernels tile
    nothing, take their events whole, and run only on the card (the CPU
    runs the plain versions). ``params_aware=True`` returns the fleet step
    over the stacked (T, ...) state, ``step(state, keys (T, C), valid (T,
    C), TenantStepParams)``, where the reference's takes one tenant under
    ``jax.vmap``. A counter-family spec needs the plane layout, as the
    reference says."""
    cfg = cfg.validate()
    if spec is None:
        from ..core.sketch import get_spec
        spec = get_spec(cfg.variant)
    if spec.family == "counter" and not cfg.is_planes:
        raise ValueError(
            f"the fused {cfg.variant} kernel needs the bit-plane layout "
            f"(cfg.layout='planes'); got {cfg.effective_layout!r}")
    return _batched.make_templated_step(cfg, spec, device,
                                        params_aware=params_aware)


# ---------------- bitset family ------------------------------------------ //

def bitset_step_plain(cfg, words, pos, rnd, valid, seen, i_t, load):
    """-> (new words, dup, inserted, load). One filter: words (k, W), pos
    (B, k), load (k,). A fleet: words (T, k, W) and every other operand
    with a leading T axis, all tenants at once (their rows are disjoint:
    the (T, k) rows are stepped as T·k rows of one filter)."""
    k, w = words.shape[-2:]
    decide = _batched.make_decision_fn(cfg)
    p = pos.to(torch.int64)
    lead = torch.arange(words.numel() // (k * w), device=words.device)
    rows = torch.arange(k, device=words.device)
    got = words.reshape(-1, k, w)[lead[:, None, None], rows,
                                  (p >> 5).reshape(-1, *p.shape[-2:])]
    vals = ((u32.to_u64(got.reshape(p.shape)) >> (p & 31)) & 1).to(
        torch.uint8)
    dup, insert, del_mask = decide(vals, valid, seen, i_t, load, rnd)
    sentinel = 32 * w
    spi = _batched.sorted_enabled_positions(
        pos, insert[..., None].expand(pos.shape), sentinel)    # (..., k, B)
    spd = _batched.sorted_enabled_positions(rnd.del_pos, del_mask, sentinel)

    def flat(sp):                                              # (T·k, B)
        return sp.reshape(-1, sp.shape[-1])

    old = words.reshape(-1, w)
    delta_i = _packed.delta_from_sorted_positions(flat(spi), w)
    delta_d = _packed.delta_from_sorted_positions(flat(spd), w)
    new = (old & ~delta_d) | delta_i
    pre_i = _packed.probe_sorted_packed(old, flat(spi)).view(spi.shape)
    pre_d = _packed.probe_sorted_packed(old, flat(spd)).view(spd.shape)
    post_d = _packed.probe_sorted_packed(new, flat(spd)).view(spd.shape)
    new_load = load + _batched.load_delta_from_sorted(
        spi, pre_i, spd, pre_d, post_d, cfg.s)
    return new.view(words.shape), dup, insert, new_load


def _check(cfg, words, keys, seeds, block_seeds, rnd, valid, seen, i_t,
           load):
    k, w = cfg.k, cfg.s_words
    t = words.shape[0] if words.dim() == 3 else -1
    b = valid.shape[1] if valid.dim() == 2 else -1
    check_hash_operands("bitset_step", keys, seeds, cfg.s,
                                 cfg.block_bits, block_seeds)
    if seeds.shape[0] != k:
        raise ValueError(f"bitset_step: seeds must be ({k},), got "
                         f"{tuple(seeds.shape)}")
    _check_tensors("bitset_step", {
        "words": (words, torch.int32, (t, k, w)),
        "keys": (keys, torch.int32, (t, b)),
        "del_pos": (rnd.del_pos, torch.int32, (t, b, k)),
        "u_bern": (rnd.u_bern, torch.float32, (t, b)),
        "u_aux": (rnd.u_aux, torch.float32, (t, b, k)),
        "which": (rnd.which, torch.int32, (t, b)),
        "valid": (valid, torch.bool, (t, b)),
        "seen": (seen, torch.bool, (t, b)),
        "i_t": (i_t, torch.int32, (t, b)),
        "load": (load, torch.int32, (t, k)),
    }, words.device)
    if cfg.variant not in VARIANT_CODES:
        raise ValueError(f"bitset_step runs {tuple(VARIANT_CODES)}, "
                         f"not {cfg.variant!r}")


@functools.lru_cache(maxsize=None)
def _entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("bitset_step").bitset_step_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, i, i, i, p, p, p, p, i,
                   p, p, p, p, p, p, p, p, p, p, p, p,
                   i, i, ctypes.c_float, ctypes.c_float, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(cfg, words, keys, seeds, block_seeds, rnd, valid, seen, i_t,
            load, dup, ins, del_rows, load_out):
    stream = torch.cuda.current_stream(words.device).cuda_stream
    t, k, w = words.shape
    hs, hb, dev = launch_seeds(
        seeds, block_seeds if cfg.block_bits > 0 else None, words.device)
    err = _entry()(words.data_ptr(), w, k, t, valid.shape[1],
                   keys.data_ptr(), hs.data_ptr(), ptr(hb),
                   ptr(dev), max(cfg.block_bits, 0),
                   rnd.del_pos.data_ptr(),
                   valid.data_ptr(), seen.data_ptr(), i_t.data_ptr(),
                   rnd.u_bern.data_ptr(), rnd.u_aux.data_ptr(),
                   rnd.which.data_ptr(), load.data_ptr(),
                   load_out.data_ptr(), dup.data_ptr(), ins.data_ptr(),
                   del_rows.data_ptr(), VARIANT_CODES[cfg.variant], cfg.s,
                   float(np.float32(cfg.s)), float(np.float32(cfg.p_star)),
                   stream)
    if err != 0:
        raise RuntimeError(f"bitset_step kernel launch failed: CUDA error "
                           f"{err}")


def bitset_step(cfg, words, keys, rnd, valid, seen, i_t, load, *, seeds,
                block_seeds=None):
    """One bitset-family step on the int32 ``words``, updated in place.
    One filter: words (k, W), keys (B,) int32 words, ``rnd`` the step's
    ``BatchRandomness``, valid/seen (B,) bool, i_t (B,) int32 stream
    positions, load (k,) int32 batch-entry load; the probe ``seeds`` (k,),
    plus ``block_seeds`` (k,) when ``cfg.block_bits`` > 0, int32 words. A
    fleet of T tenants: words (T, k, W) and every batch operand with a
    leading T axis; the kernel's grid carries the tenant axis, so T filters
    are one launch. Returns (dup bool, inserted bool, load int32).

    On CUDA the kernel's probe and insert launches hash each key in
    registers (``csrc/hashmix.cuh``): no hashmix launch, no positions in
    device memory; the seeds are read on the host and must be CPU tensors
    (``hashmix.launch_seeds``: in the argument block up to 32 rows, copied
    to the card without a host wait past that). On the CPU the wrapper
    computes the positions
    with the plain hashmix and runs ``bitset_step_plain``.
    ``bitset_step.launches`` counts kernel launches: one per step, three
    grid launches each."""
    if words.dim() == 2:
        dup, ins, new_load = bitset_step(
            cfg, words[None], keys[None],
            _batched.BatchRandomness(*(x[None] for x in rnd)), valid[None],
            seen[None], i_t[None], load[None], seeds=seeds,
            block_seeds=block_seeds)
        return dup[0], ins[0], new_load[0]
    _check(cfg, words, keys, seeds, block_seeds, rnd, valid, seen, i_t,
           load)
    if words.device.type == "cpu":
        with plain_region("bitset_step"):
            pos = positions_plain(
                keys.reshape(-1), seeds, cfg.s, cfg.block_bits,
                block_seeds).view(*keys.shape, cfg.k)
            new, dup, ins, new_load = bitset_step_plain(
                cfg, words, pos, rnd, valid, seen, i_t, load)
            words.copy_(new)
        return dup, ins, new_load
    if words.device.type != "cuda":
        raise ValueError(f"bitset_step runs on cpu or cuda, not "
                         f"{words.device}")
    dup = torch.empty(valid.shape, dtype=torch.bool, device=words.device)
    ins = torch.empty(valid.shape, dtype=torch.bool, device=words.device)
    # the rows each element deletes, 32 to a mask word
    del_rows = torch.empty((*valid.shape, -(-cfg.k // 32)),
                           dtype=torch.int32, device=words.device)
    load_out = load.clone()
    _launch(cfg, words, keys, seeds, block_seeds, rnd, valid, seen, i_t,
            load, dup, ins, del_rows, load_out)
    bitset_step.launches += 1
    return dup, ins, load_out


bitset_step.launches = 0


# ---------------- counter family ----------------------------------------- //

def _tenant_events(ev, t):
    """Tenant t's rows of a fleet step's ``CounterStepDeltas`` (the ring
    payload, which the step itself does not read, left out)."""
    return ev._replace(ring_payload=None, **{
        f: getattr(ev, f)[t] for f in ev._fields
        if f != "ring_payload" and getattr(ev, f) is not None})


def counter_step_plain(cfg, spec, planes, pos, valid, seen, load, ev,
                       threshold=None, max_value=None):
    """-> (new planes, dup bool, load int32), as the reference's jnp
    counter step computes them: probe, decide, subtract the
    ``ev.sub_planes``, set ``ev.set_delta`` to Max or add
    ``ev.add_planes``, and the exact nonzero-cell load from the sorted
    event lists. ``ev`` must carry its delta planes (events built with
    ``build_planes=True``). One filter: planes (d, W), pos (B, k), load
    (1,); ``threshold`` and ``max_value`` default to ``cfg.count_threshold``
    and ``cfg.sbf_max``. A fleet: planes (T, d, W), every operand with a
    leading T axis and the two knobs (T,) rows, each tenant stepped on its
    own (this is the check on the kernel, not the path)."""
    if planes.dim() == 3:
        outs = [counter_step_plain(
            cfg, spec, planes[t], pos[t], valid[t],
            None if seen is None else seen[t], load[t],
            _tenant_events(ev, t),
            None if threshold is None else threshold[t],
            None if max_value is None else max_value[t])
            for t in range(planes.shape[0])]
        return tuple(torch.stack(x) for x in zip(*outs))
    w = planes.shape[1]
    nzw = _packed.planes_nonzero(planes)
    if spec.probe == "value":
        vals = _packed.probe_cell_values(planes, pos)
    else:
        p = pos.to(torch.int64)
        vals = ((u32.to_u64(nzw[p >> 5]) >> (p & 31)) & 1) != 0
    decide = spec.make_decide(cfg)
    if spec.thresholded and threshold is not None:
        dup = decide(vals, valid, seen, t=threshold)
    else:
        dup = decide(vals, valid, seen)
    new = planes
    if spec.has_sub:
        new = _packed.planes_saturating_sub(new, _need(ev.sub_planes,
                                                       "sub_planes"))
    if spec.combine == "set":
        # set-to-Max writes the counter ceiling, which may sit below the
        # plane capacity 2^d - 1
        new = _packed.planes_set_value(
            new, _need(ev.set_delta, "set_delta"),
            cfg.sbf_max if max_value is None else max_value)
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


def _check_counter(cfg, spec, planes, pos, valid, seen, load, ev,
                   threshold, max_value):
    d, w, k = cfg.n_planes, cfg.s_words, cfg.k
    t = planes.shape[0] if planes.dim() == 3 else -1
    b = pos.shape[1] if pos.dim() == 3 else -1
    if spec.family != "counter" or spec.name not in COUNTER_SKETCHES:
        raise ValueError(f"counter_step runs {COUNTER_SKETCHES}, not "
                         f"{spec.name!r}")
    if not 1 <= d <= MAX_PLANES:
        raise ValueError(f"counter_step takes 1 <= d <= {MAX_PLANES} "
                         f"planes, got {d}")
    if 32 * w >= 1 << 31:
        raise ValueError(f"counter_step needs cells below 2^31; the "
                         f"sentinel 32·W = {32 * w} is not")
    want = {"planes": (planes, torch.int32, (t, d, w)),
            "pos": (pos, torch.int32, (t, b, k)),
            "valid": (valid, torch.bool, (t, b)),
            "load": (load, torch.int32, (t, 1)),
            "threshold": (threshold, torch.int32, (t,)),
            "max_value": (max_value, torch.int32, (t,))}
    if spec.uses_seen:
        want["seen"] = (seen, torch.bool, (t, b))
    lists = [("ins", ev.ins_events, ev.ins_heads)]
    if spec.has_sub:
        lists.append(("sub", ev.sub_events, ev.sub_heads))
    n_events = 0
    for name, events, heads in lists:
        n = events.shape[1] if events is not None and events.dim() == 2 \
            else -1
        n_events += n
        # the kernel reads the sorted int64 lists themselves; the run heads
        # are the plain step's (built with the delta planes)
        want[f"{name}_events"] = (events, torch.int64, (t, n))
        if heads is not None:
            want[f"{name}_heads"] = (heads, torch.bool, (t, n))
    _check_tensors("counter_step", want, planes.device)
    if n_events >= 1 << 31:
        raise ValueError(f"counter_step takes fewer than 2^31 events per "
                         f"tenant row, got {n_events}")


def counter_caps(cfg, spec) -> tuple:
    """(subtract cap, add cap): where the counter kernel clamps the run
    length of equal cells in each sorted event list, as the reference
    clamps its events before it builds count planes. sbf's decrements clamp
    at the fleet-wide ``cfg.sbf_max`` (a tenant's lower Max saturates the
    same cells to 0), swbf's expiring counts and every add at the plane
    capacity 2^d - 1; 0 where the list is absent or, in set-to-Max mode,
    where only each cell's bit is read."""
    full = (1 << cfg.n_planes) - 1
    set_mode = spec.combine == "set"
    sub_cap = (cfg.sbf_max if set_mode else full) if spec.has_sub else 0
    # a row holds fewer than 2^31 events, so no run is longer than INT_MAX:
    # clamping there changes no count (d = 32 caps would overflow an int)
    return min(sub_cap, INT_MAX), 0 if set_mode else min(full, INT_MAX)


@functools.lru_cache(maxsize=None)
def _counter_entry():
    """The C entry point, built at first use, its signature set once."""
    fn = build.load("counter_step").counter_step_launch
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p, ctypes.c_longlong, i, i, i, i, p, p, p, i, p, p, p,
                   p, i, i, p, i, i, i, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def int32_rows(value: int, t: int, device) -> torch.Tensor:
    """(t,) int32 rows holding ``value``'s low 32 bits: a set-to-Max value
    of 2^31 or more (d = 32 planes) travels as its bit pattern, which the
    kernel and ``planes_set_value`` read bit by bit."""
    return u32.to_i32(torch.full((t,), int(value), dtype=torch.int64,
                                 device=device))


def _knob(v, default: int, t: int, device):
    return int32_rows(default, t, device) if v is None else v


def counter_step(cfg, spec, planes, pos, valid, seen, load, ev,
                 threshold=None, max_value=None):
    """One counter-family step on the int32 ``planes``, updated in place.
    One filter: planes (d, W), pos (B, k) int32 cells, valid (B,) bool,
    seen (B,) bool where the spec joins the batch (else None), load (1,)
    int32 batch-entry nonzero-cell count, ``ev`` the step's
    ``CounterStepDeltas`` (int64 sorted event lists; their run heads and
    delta planes only where the plain step needs them). A fleet of T
    tenants: planes (T, d, W) and every operand with a leading T axis, the
    event lists sorted per row; the kernel's grids carry the tenant axis,
    so T filters are one call. ``threshold`` and ``max_value`` are (T,)
    int32 rows on the planes' device (default: the config's values), read
    by the kernel itself. Returns (dup bool, load int32). On CUDA the
    kernel reads only the sorted event lists, whatever
    ``cfg.kernel_accumulate`` says, and clamps their run lengths at
    ``counter_caps``; ``counter_step.launches`` counts its launches: one
    per step, two grid launches each (probe + decide beside the merge-path
    partition, then the apply)."""
    if planes.dim() == 2:
        lists = ("sub_events", "sub_heads", "ins_events", "ins_heads",
                 "sub_planes", "add_planes", "set_delta")
        ev1 = ev._replace(ring_payload=None, **{
            f: getattr(ev, f)[None] for f in lists
            if getattr(ev, f) is not None})
        dup, new_load = counter_step(
            cfg, spec, planes[None], pos[None], valid[None],
            None if seen is None else seen[None], load[None], ev1,
            None if threshold is None else threshold.reshape(1),
            None if max_value is None else max_value.reshape(1))
        return dup[0], new_load[0]
    t, device = planes.shape[0], planes.device
    threshold = _knob(threshold, cfg.count_threshold, t, device)
    max_value = _knob(max_value, cfg.sbf_max, t, device)
    _check_counter(cfg, spec, planes, pos, valid, seen, load, ev, threshold,
                   max_value)
    if device.type == "cpu":
        with plain_region("counter_step"):
            new, dup, new_load = counter_step_plain(
                cfg, spec, planes, pos, valid, seen, load, ev, threshold,
                max_value)
            planes.copy_(new)
        return dup, new_load
    if device.type != "cuda":
        raise ValueError(f"counter_step runs on cpu or cuda, not {device}")
    d, w = planes.shape[1:]
    sub_cap, ins_cap = counter_caps(cfg, spec)
    sub = ev.sub_events if spec.has_sub else None
    n_events = ev.ins_events.shape[1] + (0 if sub is None else sub.shape[1])
    dup = torch.empty(valid.shape, dtype=torch.bool, device=device)
    load_out = load.clone()
    # the merge-path partition's scratch: where each tile starts
    splits = torch.empty((t * -(-n_events // COUNTER_TILE),),
                         dtype=torch.int32, device=device)

    def ptr(x):
        return None if x is None else x.data_ptr()

    err = _counter_entry()(
        planes.data_ptr(), w, d, t, pos.shape[1], cfg.k, pos.data_ptr(),
        valid.data_ptr(), ptr(seen if spec.uses_seen else None),
        int(spec.probe == "value"),
        ptr(threshold if spec.thresholded else None), load_out.data_ptr(),
        dup.data_ptr(), ptr(sub), 0 if sub is None else sub.shape[1],
        sub_cap, ev.ins_events.data_ptr(), ev.ins_events.shape[1], ins_cap,
        int(spec.combine == "set"), ptr(max_value), splits.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"counter_step kernel launch failed: CUDA error "
                           f"{err}")
    counter_step.launches += 1
    return dup, load_out


counter_step.launches = 0
