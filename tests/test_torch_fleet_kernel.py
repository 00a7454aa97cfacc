"""The fused steps' tenant axis against the JAX package's Pallas fleet: the
port's ``FleetDedup`` on the CPU runs the plain tenant-axis forms of the
bitset and counter steps (``bitset_step_plain`` / ``counter_step_plain``
over a leading T axis, the counter step with per-tenant threshold and Max
rows — the params-aware kernel's check), and must equal
``repro.core.fleet.FleetDedup(backend="pallas")``, whose kernels run in
interpret mode here, exactly: on ``tests/test_tenants.py``'s heterogeneous
grid (sbf Max, cms thresholds, swbf windows) and its bitset Pallas rows.
Also: the kernel's event rows per tenant, the wrappers' checks, and a
fleet's state carried across by ``convert.py`` both ways."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.core import fleet as jfleet
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import DedupConfig, u32
from repro_torch.core import batched as tbat
from repro_torch.core import fleet as tfleet
from repro_torch.core.sketch import get_spec
from repro_torch.kernels import fused_template as ft
from test_torch_counter_step import kernel_walk

SEED = 11


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def configs(variant, backend="pallas", T=4, **kw):
    """tests/test_tenants.py's fleet sizes."""
    kw = dict(dict(memory_bits=4096, k=4, batch_size=16, layout="planes",
                   n_tenants=T, seed=SEED), **kw)
    if variant == "swbf":
        kw.setdefault("window", 4)
    if variant in ("cms", "hh"):
        kw.setdefault("count_threshold", 2)
    jc = JConfig(variant=variant, backend=backend, **kw).validate()
    return jc, DedupConfig(variant=variant, **kw).validate()


def mixed_stream(T, B, steps, key_space=64, seed=SEED):
    rng = np.random.default_rng(seed)
    kb = rng.integers(0, key_space, size=(steps, B)).astype(np.uint32)
    tb = rng.integers(0, T, size=(steps, B)).astype(np.int32)
    kb[steps // 2:] = kb[:steps - steps // 2]
    return kb, tb


def key_data(k):
    try:
        return np.asarray(jax.random.key_data(k))
    except TypeError:              # legacy uint32 keys are plain arrays
        return np.asarray(k)


def jax_leaves(state):
    out = {"bits": np.asarray(state.bits),
           "position": np.asarray(state.position),
           "load": np.asarray(state.load), "rng": key_data(state.rng)}
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


def hetero_rows(variant, cfg, cap):
    rows = dict(max_value=[cfg.sbf_max] * 4,
                threshold=[cfg.count_threshold] * 4,
                window=[max(cfg.window, 1)] * 4, capacity=[cap] * 4)
    if variant == "sbf":
        lo, hi = 1 << (cfg.sbf_max.bit_length() - 1), cfg.sbf_max
        rows["max_value"] = [hi, lo, hi, max(lo, hi - 1)]
    elif variant == "cms":
        rows["threshold"] = [1, 2, 3, 2]
    elif variant == "swbf":
        rows["window"] = [4, 1, 2, 3]
    return rows


# tests/test_tenants.py's HETERO_GRID on Pallas, and its bitset Pallas rows
GRID = [("sbf", True), ("cms", True), ("swbf", True), ("bsbf", False),
        ("rlbsbf", False)]


@pytest.mark.parametrize("variant,hetero", GRID,
                         ids=[f"{v}-{'hetero' if h else 'same'}"
                              for v, h in GRID])
def test_plain_fleet_steps_match_pallas_fleet(variant, hetero):
    """Per step: verdicts, routing and overflow; at the end: the stacked
    bits, position, load, rng key data and ring — all equal to the Pallas
    fleet's."""
    kw = {"sbf_p": 7} if variant == "sbf" else {}
    jc, tc = configs(variant, **kw)
    cap = jc.batch_size
    rows = hetero_rows(variant, jc, cap)
    jp = jfleet.TenantParams(**{n: jnp.asarray(v, jnp.int32)
                                for n, v in rows.items()})
    tp = tfleet.TenantParams(**{n: torch.tensor(v, dtype=torch.int32)
                                for n, v in rows.items()})
    jf = jfleet.FleetDedup(jc, capacity=cap, params=jp)
    tf = tfleet.FleetDedup(tc, capacity=cap, params=tp, device="cpu",
                           partitionable=_layout())
    kb, tb = mixed_stream(4, 16, steps=8)
    js, ts = jf.init(SEED), tf.init(SEED)
    launches = (ft.bitset_step.launches, ft.counter_step.launches)
    for i in range(kb.shape[0]):
        js, rj = jf.process(js, jnp.asarray(kb[i]), jnp.asarray(tb[i]))
        ts, rt = tf.process(ts, kb[i], tb[i])
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), i
        assert np.array_equal(rt.routed.numpy(), np.asarray(rj.routed)), i
        assert int(rt.overflow) == int(rj.overflow) == 0, i
    assert_same_state(js, ts, variant)
    # on the CPU the wrappers ran the plain versions: no launch counted
    assert (ft.bitset_step.launches, ft.counter_step.launches) == launches


def _fleet_inputs(tc, st, keys, valid):
    """What the fleet step hands the counter step, from the port's own
    pieces: (T, C) keys -> positions, join, draws and events."""
    from repro_torch.core import hashing
    spec = get_spec(tc.variant)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), "cpu")
    kw = u32.from_numpy_u32(keys, "cpu")
    v = torch.from_numpy(valid)
    pos = hashing.hash_positions(kw, seeds, tc.s)
    seen = tbat.intra_batch_seen(kw, v) if spec.uses_seen else None
    rnd = (spec.draw(tc, st.rng, keys.shape[1], _layout())[1]
           if spec.draw else None)
    ev = spec.make_events(tc)(st, pos, v, rnd)
    return spec, pos, v, seen, ev


@pytest.mark.parametrize("variant", ("sbf", "swbf", "cms", "hh"))
def test_counter_step_over_tenants_equals_each_tenant(variant):
    """The tenant-axis counter step with hetero knobs equals the one-filter
    step on each tenant's rows with that tenant's knobs; a tenant whose
    slot row is empty keeps its planes and load. Each tenant's row of the
    sorted event lists, walked under the kernel's count caps, rebuilds that
    tenant's delta planes."""
    kw = {"sbf_p": 7} if variant == "sbf" else {}
    _, tc = configs(variant, **kw)
    tf = tfleet.FleetDedup(tc, capacity=16, device="cpu")
    r = np.random.default_rng(5)
    st = tf.init(SEED)
    for _ in range(3):                   # fill the fleet a little first
        st, _ = tf.process(st, r.integers(0, 40, 16).astype(np.uint32),
                           r.integers(0, 4, 16).astype(np.int32))
    keys = r.integers(0, 40, (4, 16)).astype(np.uint32)
    valid = r.random((4, 16)) < 0.7
    valid[2] = False                     # tenant 2: an empty slot row
    spec, pos, v, seen, ev = _fleet_inputs(tc, st, keys, valid)
    thr = torch.tensor([1, 2, 3, 2], dtype=torch.int32)
    cmax = torch.tensor([3, 2, 3, 2], dtype=torch.int32)
    planes = tbat.fleet_planes(st.bits)
    got = planes.clone()
    dup, load = ft.counter_step(tc, spec, got, pos, v, seen, st.load, ev,
                                threshold=thr, max_value=cmax)
    for t in range(4):
        one = ft._tenant_events(ev, t)
        new, dup_t, load_t = ft.counter_step_plain(
            tc, spec, planes[t], pos[t], v[t],
            None if seen is None else seen[t], st.load[t], one, thr[t],
            cmax[t])
        assert torch.equal(got[t], new) and torch.equal(dup[t], dup_t)
        assert torch.equal(load[t], load_t)
    assert torch.equal(got[2], planes[2]) and torch.equal(load[2],
                                                          st.load[2])
    # what the kernel reads: each row's sorted int64 list in place, rows n
    # apart; walked under the wrapper's caps, each row rebuilds that
    # tenant's delta planes
    sub_cap, ins_cap = ft.counter_caps(tc, spec)
    lists = [(ev.ins_events, ins_cap, ev.set_delta[:, None]
              if spec.combine == "set" else ev.add_planes)]
    if spec.has_sub:
        lists.append((ev.sub_events, sub_cap, ev.sub_planes))
    for events, cap, planes_t in lists:
        assert events.dtype == torch.int64 and events.is_contiguous()
        for t in range(4):
            row = events[t].numpy()
            assert (np.diff(row) >= 0).all()
            masks, _ = kernel_walk(row, cap, planes_t.shape[1],
                                   tc.s_words)
            assert np.array_equal(masks, u32.to_numpy_u32(planes_t[t]))


def test_tenant_axis_wrappers_check_their_operands():
    _, tc = configs("cms")
    tf = tfleet.FleetDedup(tc, capacity=16, device="cpu")
    st = tf.init(SEED)
    keys = np.arange(64, dtype=np.uint32).reshape(4, 16)
    spec, pos, v, seen, ev = _fleet_inputs(tc, st, keys,
                                           np.ones((4, 16), bool))
    planes = tbat.fleet_planes(st.bits).clone()
    with pytest.raises(ValueError, match="threshold"):
        ft.counter_step(tc, spec, planes, pos, v, seen, st.load, ev,
                        threshold=torch.ones(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="load"):
        ft.counter_step(tc, spec, planes, pos, v, seen, st.load[:, 0], ev)
    with pytest.raises(ValueError, match="pos"):
        ft.counter_step(tc, spec, planes, pos[:2], v, seen, st.load, ev)
    _, bc = configs("rlbsbf")
    bs = tfleet.FleetDedup(bc, capacity=16, device="cpu").init(SEED)
    rng, rnd = tbat.draw_randomness(bc, bs.rng, 16)
    kw = u32.from_numpy_u32(keys, "cpu")
    from repro_torch.core import hashing
    seeds = u32.from_numpy_u32(hashing.derive_seeds(bc.seed, bc.k), "cpu")
    vv = torch.ones((4, 16), dtype=torch.bool)
    i_t = bs.position[:, None] + torch.arange(16, dtype=torch.int32)
    with pytest.raises(ValueError, match="load"):
        ft.bitset_step(bc, bs.bits, kw, rnd, vv, vv, i_t, bs.load[0],
                       seeds=seeds)
    with pytest.raises(ValueError, match="u_aux"):
        ft.bitset_step(bc, bs.bits, kw, rnd._replace(u_aux=rnd.u_aux[:1]),
                       vv, vv, i_t, bs.load, seeds=seeds)


@pytest.mark.parametrize("variant", ("swbf", "rlbsbf", "sbf"))
def test_fleet_state_carried_across_both_ways(variant):
    """A reference fleet's stacked leaves — its (T, 2) rng key data and
    stacked ring included — become the port's state and come back byte for
    byte; then both fleets go on from that state to the same verdicts and
    the same state."""
    kw = {"sbf_p": 7} if variant == "sbf" else {}
    jc, tc = configs(variant, backend="jnp", **kw)
    jf = jfleet.FleetDedup(jc)
    tf = tfleet.FleetDedup(tc, device="cpu", partitionable=_layout())
    kb, tb = mixed_stream(4, 16, steps=6)
    js = jf.init(SEED)
    for i in range(3):
        js, _ = jf.process(js, jnp.asarray(kb[i]), jnp.asarray(tb[i]))
    leaves = jax_leaves(js)
    ts = state_from_numpy(leaves, tc, "cpu", fleet=True)
    back = state_to_numpy(ts)
    assert back.keys() == leaves.keys()
    for key in leaves:
        assert back[key].dtype == leaves[key].dtype, key
        assert np.array_equal(back[key], leaves[key]), key
    for i in range(3, 6):
        js, rj = jf.process(js, jnp.asarray(kb[i]), jnp.asarray(tb[i]))
        ts, rt = tf.process(ts, kb[i], tb[i])
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), i
    assert_same_state(js, ts, variant)
    with pytest.raises(ValueError, match="bits"):
        state_from_numpy(leaves, tc, "cpu")            # not one filter
    with pytest.raises(ValueError, match="rng"):
        state_from_numpy(dict(leaves, rng=leaves["rng"][:2]), tc, "cpu",
                         fleet=True)
