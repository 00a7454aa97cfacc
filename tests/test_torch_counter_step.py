"""The counter step of the port against the JAX package, per batch: the
port's step (``counter_step_plain`` on the CPU) against JAX's jnp step and
its Pallas kernel (interpret mode here) with ``kernel_accumulate`` off and
on, for sbf, sbf at Max 1 and at Max 2, swbf, cms and hh, exactly — and
what the CUDA kernel derives from the sorted event lists under the count
caps its wrapper passes against the reference's accumulate-mode
operands."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_engine as jax_engine
from repro.core import DedupConfig as JConfig
from repro.core import packed as jp
from repro.kernels.fused_template import _event_operands
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import Dedup, DedupConfig, hashing, packed, u32
from repro_torch.core import batched as tb
from repro_torch.core.sketch import get_spec
from repro_torch.kernels import fused_template as ft

COUNTER = ("sbf", "sbf_d1", "sbf_max2", "swbf", "cms", "hh")
SMALL = dict(memory_bits=1 << 12, batch_size=256)


def _installed_layout():
    return bool(jax.config.jax_threefry_partitionable)


def _kw(name):
    return {"sbf": ("sbf", dict(layout="planes")),
            "sbf_d1": ("sbf", dict(layout="planes", sbf_max=1)),
            "sbf_max2": ("sbf", dict(layout="planes", sbf_max=2)),
            "swbf": ("swbf", dict(window=4)),
            "cms": ("cms", {}), "hh": ("hh", {})}[name]


def configs(name, **over):
    variant, kw = _kw(name)
    kw = dict(SMALL, **kw, **over)
    return (JConfig.for_variant(variant, **kw),
            DedupConfig.for_variant(variant, **kw))


def jax_leaves(state):
    out = {"bits": np.asarray(state.bits),
           "position": np.asarray(state.position),
           "load": np.asarray(state.load),
           "rng": np.asarray(jax.random.key_data(state.rng))}
    if state.ring is not None:
        out["ring_events"] = np.asarray(state.ring.events)
        out["ring_slot"] = np.asarray(state.ring.slot)
    return out


def assert_same_state(js, ts, ctx=""):
    a, b = jax_leaves(js), state_to_numpy(ts)
    assert a.keys() == b.keys(), ctx
    for key in a:
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


def _streams():
    r = np.random.default_rng(23)
    return {
        "dup_heavy": r.integers(0, 60, 2000).astype(np.uint32),
        "unique_heavy": r.integers(0, 1 << 30, 2000).astype(np.uint32),
        "ragged": r.integers(0, 300, 2000 - 97).astype(np.uint32),
    }


@pytest.mark.parametrize("name", COUNTER)
def test_steps_match_jnp_and_pallas_per_batch(name):
    """Every batch of the three stream shapes (the ragged tail padded with
    invalid lanes): dup, inserted, planes, load, position, rng key data and
    the ring equal JAX's jnp step and its Pallas kernel with
    ``kernel_accumulate`` off and on."""
    jc, tc = configs(name)
    engines = [jax_engine(jc),
               jax_engine(dataclasses.replace(jc, backend="pallas")),
               jax_engine(dataclasses.replace(jc, backend="pallas",
                                              kernel_accumulate=True))]
    td = Dedup(tc, "cpu", partitionable=_installed_layout())
    for sname, keys in _streams().items():
        js = [e.init() for e in engines]
        st = td.init()
        for i in range(0, len(keys), 256):
            kb = np.zeros(256, np.uint32)
            kb[:len(keys[i:i + 256])] = keys[i:i + 256]
            valid = np.arange(256) < len(keys[i:i + 256])
            st, rt = td.process(st, kb, valid)
            for j, eng in enumerate(engines):
                js[j], rj = eng.process(js[j], jnp.asarray(kb),
                                        jnp.asarray(valid))
                ctx = (name, sname, i, j)
                assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), ctx
                assert np.array_equal(rt.inserted.numpy(),
                                      np.asarray(rj.inserted)), ctx
                assert_same_state(js[j], st, ctx)


def _random_state(jeng, jc, r):
    """A JAX counter state with random cells in [0, cap] (half of them
    zero), its exact load, a position mid-stream, and for swbf a ring of
    random sorted slots."""
    d, w = jc.n_planes, jc.s_words
    cap = jc.sbf_max if jc.variant == "sbf" else (1 << d) - 1
    cells = r.integers(0, cap + 1, 32 * w)
    cells[r.random(32 * w) < 0.5] = 0
    cells[jc.s:] = 0
    planes = jp.pack_cells(jnp.asarray(cells), d)            # (d, W)
    load = jp.popcount(jp.planes_nonzero(planes)[None])
    st = jeng.init()
    bits = planes[:, None, :] if d > 1 else planes
    ring = st.ring
    if ring is not None:
        e = ring.events.shape[1]
        ev = r.integers(0, jc.s, (jc.window, e))
        ev[r.random((jc.window, e)) < 0.3] = 32 * w
        ring = ring._replace(events=jnp.asarray(np.sort(ev, 1), jnp.int32),
                             slot=jnp.asarray(2, jnp.int32))
    return st._replace(bits=bits, load=load, ring=ring,
                       position=jnp.asarray(5000, jnp.int32))


@pytest.mark.parametrize("name", COUNTER)
def test_plain_counter_step_on_a_random_state(name):
    """``counter_step_plain`` on the inputs the port's step builds, from a
    random full state handed over from JAX: the same planes, dup and load
    as one step of JAX's jnp step and Pallas kernel, through collisions and
    saturation, at batch 1024 over 2^12 bits."""
    jc, tc = configs(name, batch_size=1024)
    jd = jax_engine(jc)
    jk = jax_engine(dataclasses.replace(jc, backend="pallas"))
    r = np.random.default_rng(7)
    js = _random_state(jd, jc, r)
    keys = r.integers(0, 400, 1024).astype(np.uint32)
    valid = np.arange(1024) < 900
    ts = state_from_numpy(jax_leaves(js), tc, "cpu")
    spec = get_spec(tc.variant)
    kw_ = u32.from_numpy_u32(keys, "cpu")
    v = torch.from_numpy(valid)
    pos = hashing.hash_positions(
        kw_, u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), "cpu"),
        tc.s)
    seen = tb.intra_batch_seen(kw_, v) if spec.uses_seen else None
    rnd = (spec.draw(tc, ts.rng, 1024, _installed_layout())[1]
           if spec.draw else None)
    ev = spec.make_events(tc)(ts, pos, v, rnd)
    planes = tb.sbf_planes_3d(ts.bits)[:, 0, :]
    new, dup, load = ft.counter_step_plain(tc, spec, planes, pos, v, seen,
                                           ts.load, ev)
    assert torch.equal(load, packed.popcount(packed.planes_nonzero(new)[None]))
    for eng in (jd, jk):
        sj, rj = eng.process(js, jnp.asarray(keys), jnp.asarray(valid))
        want = np.asarray(sj.bits).reshape(-1, tc.s_words)
        assert np.array_equal(u32.to_numpy_u32(new), want), name
        assert np.array_equal(dup.numpy(), np.asarray(rj.dup)), name
        assert np.array_equal(load.numpy(), np.asarray(sj.load)), name


def kernel_walk(events, cap, d, w):
    """What the CUDA counter kernel derives from one sorted event row, as
    its owners walk it: each distinct cell's run length clamped at ``cap``
    (each cell once in set mode, cap 0), written bit by bit into (d, W)
    per-plane word masks; sentinel cells (>= 32·W) dropped. -> (masks
    (d, W) uint32, {cell: clamped count})."""
    masks = np.zeros((d, w), np.uint32)
    counts = {}
    cells, runs = np.unique(np.asarray(events), return_counts=True)
    for cell, run in zip(cells.tolist(), runs.tolist()):
        if cell >= 32 * w:
            continue
        cnt = 1 if cap == 0 else min(run, cap)
        counts[cell] = cnt
        for q in range(d):
            if (cnt >> q) & 1:
                masks[q, cell >> 5] |= np.uint32(1 << (cell & 31))
    return masks, counts


@pytest.mark.parametrize("name", ("sbf", "swbf", "cms", "hh"))
def test_kernel_caps_rebuild_the_reference_event_operands(name):
    """The count caps the wrapper hands the CUDA kernel, applied to the
    sorted event lists as the kernel walks them, rebuild what the reference
    hands its kernel: per plane, the OR of the accumulate-mode
    ``_event_operands`` masks over each word, and the port's delta planes;
    the clamped counts are ``clamped_run_counts`` at the run heads."""
    jc, tc = configs(name, batch_size=512)
    spec = get_spec(tc.variant)
    d, w = tc.n_planes, tc.s_words
    st = Dedup(tc, "cpu").init()
    r = np.random.default_rng(len(name))
    # a crowded batch: runs of equal cells longer than any cap
    hi = min(600, tc.s)
    cells = r.integers(0, hi, (512, tc.k))
    cells[r.random((512, tc.k)) < 0.3] = 77
    pos = torch.from_numpy(cells.astype(np.int32))
    v = torch.from_numpy(r.random(512) < 0.8)
    rnd = (torch.from_numpy(np.where(r.random(512) < 0.5, 70,
                                     r.integers(0, tc.s, 512))
                            .astype(np.int32)) if name == "sbf" else None)
    if st.ring is not None:
        ring = np.sort(np.where(r.random(st.ring.events.shape) < 0.4, 77,
                                r.integers(0, hi, st.ring.events.shape)),
                       axis=-1)
        st = st._replace(ring=st.ring._replace(
            events=torch.from_numpy(ring.astype(np.int32))))
    ev = spec.make_events(tc)(st, pos, v, rnd)
    sub_cap, ins_cap = ft.counter_caps(tc, spec)
    set_mode = spec.combine == "set"
    lists = [(ev.ins_events, ev.ins_heads, ins_cap,
              ev.set_delta[None] if set_mode else ev.add_planes)]
    if spec.has_sub:
        lists.append((ev.sub_events, ev.sub_heads, sub_cap, ev.sub_planes))
    else:
        assert sub_cap == 0
    for events, heads, cap, planes in lists:
        sp = events.numpy()
        masks, counts = kernel_walk(sp, cap, 1 if cap == 0 else d, w)
        assert np.array_equal(masks, u32.to_numpy_u32(planes))
        rows = 1 if cap == 0 else d
        widx, jm = _event_operands(jnp.asarray(sp, jnp.int32),
                                   jnp.asarray(heads.numpy()), cap, rows, w,
                                   8)
        want = np.zeros((rows, w + 1), np.uint32)
        for q in range(rows):
            np.bitwise_or.at(want[q], np.minimum(np.asarray(widx), w),
                             np.asarray(jm[q]))
        assert np.array_equal(masks, want[:, :w])
        if cap > 0:
            _, cnt = packed.clamped_run_counts(events, cap)
            keep = (heads & (events < 32 * w)).numpy()
            assert counts == dict(zip(sp[keep].tolist(),
                                      cnt.numpy()[keep].tolist()))
            assert max(counts.values()) == cap     # some run hit the cap


@pytest.mark.parametrize("fault", ("dtype", "length", "strided", "cells"))
def test_wrapper_refuses_event_lists_the_kernel_cannot_read(fault):
    """The CUDA kernel reads each tenant's sorted int64 event row in place,
    rows n apart, cells below 2^31: the wrapper refuses an int32 list, a
    list whose rows disagree with its heads' length, a strided list and a
    planes row of 2^31 cells or more, before either form runs."""
    name = "cms" if fault == "cells" else "swbf"
    _, tc = configs(name)
    spec = get_spec(tc.variant)
    st = Dedup(tc, "cpu").init()
    keys = u32.from_numpy_u32(np.arange(64, dtype=np.uint32), "cpu")
    pos = hashing.hash_positions(
        keys, u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), "cpu"),
        tc.s)
    v = torch.ones(64, dtype=torch.bool)
    seen = tb.intra_batch_seen(keys, v)
    ev = spec.make_events(tc)(st, pos, v, None)
    planes = tb.sbf_planes_3d(st.bits)[:, 0, :].clone()
    if fault == "dtype":
        ev, match = ev._replace(sub_events=ev.sub_events.int()), "sub_events"
    elif fault == "length":
        ev, match = ev._replace(sub_heads=ev.sub_heads[:-1]), "sub_heads"
    elif fault == "strided":
        wide = torch.stack([ev.ins_events, ev.ins_events], -1)
        ev, match = ev._replace(ins_events=wide[..., 0]), "contiguous"
    else:
        big = dataclasses.replace(tc, memory_bits=1 << 34)
        with pytest.raises(ValueError, match="below 2\\^31"):
            ft.counter_step(big, spec, planes, pos, v, seen, st.load, ev)
        return
    with pytest.raises(ValueError, match=match):
        ft.counter_step(tc, spec, planes, pos, v, seen, st.load, ev)


def test_wrapper_on_cpu_updates_in_place_without_launch():
    _, tc = configs("swbf")
    spec = get_spec("swbf")
    eng = Dedup(tc, "cpu")
    st = eng.init()
    keys = u32.from_numpy_u32(np.arange(64, dtype=np.uint32), "cpu")
    pos = hashing.hash_positions(
        keys, u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), "cpu"),
        tc.s)
    v = torch.ones(64, dtype=torch.bool)
    seen = tb.intra_batch_seen(keys, v)
    ev = spec.make_events(tc)(st, pos, v, None)
    planes = tb.sbf_planes_3d(st.bits)[:, 0, :]
    got = planes.clone()
    before = ft.counter_step.launches
    dup, load = ft.counter_step(tc, spec, got, pos, v, seen, st.load, ev)
    new, dup_p, load_p = ft.counter_step_plain(tc, spec, planes, pos, v,
                                               seen, st.load, ev)
    assert ft.counter_step.launches == before
    assert torch.equal(got, new) and torch.equal(dup, dup_p)
    assert torch.equal(load, load_p) and int(load) > 0
    with pytest.raises(ValueError, match="pos"):
        ft.counter_step(tc, spec, got, pos.long(), v, seen, st.load, ev)
    with pytest.raises(ValueError, match="seen is missing"):
        ft.counter_step(tc, spec, got, pos, v, None, st.load, ev)
    with pytest.raises(ValueError, match="planes"):
        ft.counter_step(tc, spec, got[:1], pos, v, seen, st.load, ev)
    with pytest.raises(ValueError, match="ins_events"):
        ft.counter_step(tc, spec, got, pos, v, seen, st.load,
                        ev._replace(ins_events=ev.ins_events.int()))
    with pytest.raises(ValueError, match="counter_step runs"):
        ft.counter_step(tc, get_spec("rlbsbf"), got, pos, v, seen, st.load,
                        ev)
    # the CUDA form of the events carries no planes; the plain step says so
    bare = spec.make_events(tc)(st, pos, v, None, build_planes=False)
    assert bare.sub_planes is None and bare.add_planes is None
    assert torch.equal(bare.ins_events, ev.ins_events)
    with pytest.raises(ValueError, match="build_planes=True"):
        ft.counter_step(tc, spec, got, pos, v, seen, st.load, bare)


@pytest.mark.parametrize("name", ("sbf", "cms"))
def test_event_builders_match_reference(name):
    """The sorted event lists and delta planes the port builds equal the
    reference's ``sbf_event_deltas`` / ``count_event_deltas``."""
    from repro.core import batched as jb
    jc, tc = configs(name)
    r = np.random.default_rng(3)
    pos = r.integers(0, tc.s, (256, tc.k)).astype(np.int32)
    valid = np.arange(256) < 200
    if name == "sbf":
        start = r.integers(0, tc.s, 256).astype(np.int32)
        want = jb.sbf_event_deltas(jc, jnp.asarray(pos), jnp.asarray(start),
                                   jnp.asarray(valid))
        got = tb.sbf_event_deltas(tc, torch.from_numpy(pos),
                                  torch.from_numpy(start),
                                  torch.from_numpy(valid))
    else:
        want = jb.count_event_deltas(jc, jnp.asarray(pos),
                                     jnp.asarray(valid), 1100)
        got = tb.count_event_deltas(tc, torch.from_numpy(pos),
                                    torch.from_numpy(valid), 1100)
        with pytest.raises(ValueError, match="event width"):
            tb.count_event_deltas(tc, torch.from_numpy(pos),
                                  torch.from_numpy(valid), 1000)
    for a, b in zip(want, got):
        if a.dtype == jnp.uint32:
            assert np.array_equal(np.asarray(a), u32.to_numpy_u32(b))
        else:
            assert np.array_equal(np.asarray(a), b.numpy())
