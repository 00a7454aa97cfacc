"""Tenant fleets of the port against the JAX package (DESIGN §4.6): the
port's ``FleetDedup`` on the CPU equals ``repro.core.fleet.FleetDedup``
(jnp backend) bit for bit — verdicts, ``routed`` and ``overflow`` per step,
and the whole stacked state at the end — on the plane rows of
``tests/test_tenants.py``'s grid, at its sizes. The same file holds the
isolation theorem inside the port, the routing helpers, the parameter
refusals, the tenant-folded rng and the batched threefry against
``jax.vmap`` of ``jax.random``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.core import fleet as jfleet
from repro.core.state import init_state as jinit_state
from repro_torch.convert import state_to_numpy
from repro_torch.core import Dedup, DedupConfig, prng, u32
from repro_torch.core import fleet as tfleet
from repro_torch.core.state import init_state

SEED = 11
PLANES_GRID = ("rsbf", "bsbf", "bsbfsd", "rlbsbf", "sbf", "swbf", "cms",
               "hh")


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _kw(variant, **kw):
    """tests/test_tenants.py's fleet sizes."""
    kw.setdefault("memory_bits", 4096)
    kw.setdefault("k", 4)
    kw.setdefault("batch_size", 16)
    kw.setdefault("layout", "planes")
    if variant == "swbf":
        kw.setdefault("window", 4)
    if variant in ("cms", "hh"):
        kw.setdefault("count_threshold", 2)
    return dict(variant=variant, seed=SEED, **kw)


def configs(variant, T=4, **kw):
    kw = _kw(variant, n_tenants=T, **kw)
    return JConfig(**kw).validate(), DedupConfig(**kw).validate()


def mixed_stream(T, B, steps, key_space=64, seed=SEED):
    """tests/test_tenants.py's ``_mixed_stream``: interleaved per-tenant
    traffic whose second half replays the first half's keys."""
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


def run_both(jf, tf, kb, tb):
    """Step both fleets over the mixed batches, comparing each step's
    verdicts, routing and overflow; -> the two final states."""
    js, ts = jf.init(SEED), tf.init(SEED)
    for i in range(kb.shape[0]):
        js, rj = jf.process(js, jnp.asarray(kb[i]), jnp.asarray(tb[i]))
        ts, rt = tf.process(ts, kb[i], tb[i])
        ctx = i
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), ctx
        assert np.array_equal(rt.routed.numpy(), np.asarray(rj.routed)), ctx
        assert int(rt.overflow) == int(rj.overflow), ctx
        assert rt.overflow.dtype == torch.int32
    return js, ts


@pytest.mark.parametrize("variant", PLANES_GRID)
def test_fleet_matches_reference_fleet(variant):
    """The port's fleet equals the reference's, step by step and in the
    final stacked state (bits, position, load, rng key data, ring), at the
    default slot width C = max(8, ceil(2B/T)) = 8, where a tenant can
    overflow its row — so routing and overflow are held too."""
    jc, tc = configs(variant)
    jf = jfleet.FleetDedup(jc)
    tf = tfleet.FleetDedup(tc, device="cpu", partitionable=_layout())
    assert tf.capacity == jf.capacity == 8
    kb, tb = mixed_stream(4, 16, steps=6)
    js, ts = run_both(jf, tf, kb, tb)
    assert_same_state(js, ts, variant)


HETERO = ("sbf", "cms", "swbf")


def hetero_params(variant, cfg, cap, make):
    """tests/test_tenants.py's heterogeneous rows: sbf Max at both values
    of its bit_length, cms thresholds {1, 2, 3, 2}, swbf windows
    {4, 1, 2, 3}; ``make`` builds the rows' arrays."""
    rows = dict(max_value=[cfg.sbf_max] * 4,
                threshold=[cfg.count_threshold] * 4,
                window=[max(cfg.window, 1)] * 4, capacity=[cap] * 4)
    if variant == "sbf":
        lo, hi = 1 << (cfg.sbf_max.bit_length() - 1), cfg.sbf_max
        rows["max_value"] = [hi, lo, hi, max(lo, hi - 1)]
    elif variant == "cms":
        rows["threshold"] = [1, 2, 3, 2]
    else:
        rows["window"] = [4, 1, 2, 3]
    return {name: make(v) for name, v in rows.items()}


@pytest.mark.parametrize("variant", HETERO)
def test_fleet_heterogeneous_params_match_reference(variant):
    """Per-tenant Max / threshold / window in one launch: the port's fleet
    equals the reference's with the same rows."""
    kw = {"sbf_p": 7} if variant == "sbf" else {}
    jc, tc = configs(variant, **kw)
    cap = jc.batch_size
    jp = hetero_params(variant, jc, cap,
                       lambda v: jnp.asarray(v, jnp.int32))
    tp = hetero_params(variant, tc, cap,
                       lambda v: torch.tensor(v, dtype=torch.int32))
    jf = jfleet.FleetDedup(jc, capacity=cap,
                           params=jfleet.TenantParams(**jp))
    tf = tfleet.FleetDedup(tc, capacity=cap,
                           params=tfleet.TenantParams(**tp), device="cpu",
                           partitionable=_layout())
    kb, tb = mixed_stream(4, 16, steps=8)
    js, ts = run_both(jf, tf, kb, tb)
    assert_same_state(js, ts, variant)


def isolated_verdicts(tc, cap, kb, tb, params=None):
    """T separate port engines, tenant t's rng folded on t, every global
    step run at the fleet's slot width through ``process_padded``."""
    T, steps = tc.n_tenants, kb.shape[0]
    out = [np.zeros_like(k, dtype=bool) for k in kb]
    for t in range(T):
        over = {} if params is None else {
            "sbf_max": params["max_value"][t],
            "count_threshold": params["threshold"][t],
            "window": (params["window"][t] if tc.variant == "swbf"
                       else tc.window)}
        scfg = dataclasses.replace(tc, n_tenants=1, **over).validate()
        eng = Dedup(scfg, "cpu")
        kw = {"event_capacity": cap} if tc.variant == "swbf" else {}
        st = init_state(scfg, SEED, device="cpu", **kw)
        st = st._replace(rng=prng.fold_in(st.rng, t))
        for i in range(steps):
            sel = tb[i] == t
            st, res = eng.process_padded(st, kb[i][sel], width=cap)
            out[i][sel] = res.dup.numpy()
    return np.stack(out)


ISOLATION = [(v, False) for v in PLANES_GRID] + [(v, True) for v in HETERO]


@pytest.mark.parametrize("variant,hetero", ISOLATION,
                         ids=[f"{v}-{'hetero' if h else 'same'}"
                              for v, h in ISOLATION])
def test_fleet_equals_isolated_port_engines(variant, hetero):
    """The isolation theorem inside the port: the fleet's verdicts equal T
    isolated one-filter engines, each fed only its tenant's lanes."""
    kw = {"sbf_p": 7} if variant == "sbf" else {}
    _, tc = configs(variant, **kw)
    cap = tc.batch_size
    rows = (hetero_params(variant, tc, cap, list) if hetero else None)
    params = (None if rows is None else tfleet.TenantParams(
        **{n: torch.tensor(v, dtype=torch.int32) for n, v in rows.items()}))
    tf = tfleet.FleetDedup(tc, capacity=cap, params=params, device="cpu")
    kb, tb = mixed_stream(4, 16, steps=8)
    st, got = tf.init(SEED), []
    for i in range(kb.shape[0]):
        st, res = tf.process(st, kb[i], tb[i])
        assert int(res.overflow) == 0
        got.append(res.dup.numpy())
    want = isolated_verdicts(tc, cap, kb, tb, rows)
    assert np.array_equal(np.stack(got), want)


# ------------------------------------------------- routing & mechanics //
def test_tenant_rank_and_tagged_keys_match_reference():
    r = np.random.default_rng(0)
    for b, T in ((64, 8), (16, 4), (8192, 32), (1, 1)):
        tenant = r.integers(0, T, b).astype(np.int32)
        valid = r.random(b) < 0.8
        want = np.asarray(jfleet.tenant_rank(jnp.asarray(tenant),
                                             jnp.asarray(valid), T))
        got = tfleet.tenant_rank(torch.from_numpy(tenant),
                                 torch.from_numpy(valid), T)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy()[valid], want[valid]), (b, T)
        keys = r.integers(0, 2 ** 32, b, dtype=np.uint64).astype(np.uint32)
        want = np.asarray(jfleet.tenant_tagged_keys(
            jnp.asarray(keys), jnp.asarray(tenant), T))
        got = tfleet.tenant_tagged_keys(u32.from_numpy_u32(keys, "cpu"),
                                        torch.from_numpy(tenant), T)
        assert np.array_equal(u32.to_numpy_u32(got), want), (b, T)
    with pytest.raises(ValueError, match="composite key overflow"):
        tfleet.tenant_rank(torch.zeros(256, dtype=torch.int32),
                           torch.ones(256, dtype=torch.bool), 1 << 30)


def _message(fn):
    with pytest.raises(ValueError) as err:
        fn()
    return str(err.value)


def test_validate_params_refusals_match_reference():
    """Each refusal of ``validate_params`` says what the reference says."""
    cases = [("sbf", "max_value", [1, 1, 1]), ("sbf", "max_value", [1, 3]),
             ("sbf", "capacity", [0, 1]), ("swbf", "window", [1, 5]),
             ("cms", "threshold", [0, 2]), ("cms", "threshold", [2, 256])]
    for variant, field, bad in cases:
        kw = {"sbf_p": 7} if variant == "sbf" else {}
        jc, tc = configs(variant, T=2, **kw)
        cap = jfleet.FleetDedup(jc).capacity
        jgood = jfleet.default_tenant_params(jc, cap)
        tgood = tfleet.default_tenant_params(tc, cap, "cpu")
        want = _message(lambda: jfleet.validate_params(
            jc, jgood._replace(**{field: jnp.asarray(bad, jnp.int32)}), cap))
        got = _message(lambda: tfleet.validate_params(
            tc, tgood._replace(**{field: torch.tensor(bad)}), cap, "cpu"))
        assert got == want, (variant, field)
    _, tc = configs("sbf", T=2, sbf_p=7)
    good = tfleet.default_tenant_params(tc, 8, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tfleet.validate_params(tc, good, 8, "cpu"), good))


def test_fleet_refusals_and_device_rule(monkeypatch):
    _, tc = configs("sbf", layout="dense8")
    with pytest.raises(ValueError, match="dense8"):
        tfleet.FleetDedup(tc, device="cpu")
    _, tc = configs("rlbsbf")
    fleet = tfleet.FleetDedup(tc, device="cpu")
    assert fleet.device.type == "cpu" and fleet.init().bits.device.type == \
        "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfleet.FleetDedup(tc)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfleet.init_fleet_state(tc, SEED)


@pytest.mark.parametrize("variant", ("rlbsbf", "swbf"))
def test_init_fleet_state_rows_are_tenant_folds(variant):
    """Stacked rng row t == ``jax.random.fold_in(base, t)``; every other
    leaf is the one-filter template repeated."""
    jc, tc = configs(variant)
    st = tfleet.init_fleet_state(tc, SEED, event_capacity=8, device="cpu")
    base = jinit_state(jc, SEED)
    for t in range(4):
        assert np.array_equal(u32.to_numpy_u32(st.rng[t]),
                              key_data(jax.random.fold_in(base.rng, t)))
    want = jfleet.init_fleet_state(jc, SEED, event_capacity=8)
    assert_same_state(want, st, variant)


def test_run_stream_matches_stepwise():
    """``run_stream`` over a ragged stream equals the per-batch loop, with
    its per-batch overflow on the device."""
    _, tc = configs("rlbsbf")
    kb, tb = mixed_stream(4, 16, steps=6)
    a = tfleet.FleetDedup(tc, device="cpu")
    st, step_dups, step_ovf = a.init(SEED), [], []
    for i in range(kb.shape[0]):
        st, res = a.process(st, kb[i], tb[i])
        step_dups.append(res.dup)
        step_ovf.append(int(res.overflow))
    b = tfleet.FleetDedup(tc, device="cpu")
    st2, dups, ovfs = b.run_stream(b.init(SEED), kb.reshape(-1),
                                   tb.reshape(-1))
    assert torch.equal(dups, torch.cat(step_dups))
    assert ovfs.dtype == torch.int32 and ovfs.tolist() == step_ovf
    for x, y in zip(st, st2):
        assert torch.equal(x, y)
    assert b.stream_cache_size() == 1 and a.process_cache_size() == 1
    # a ragged tail rides as invalid lanes; the state the caller passed to
    # process is left as it was, run_stream updates it in place
    c = tfleet.FleetDedup(tc, device="cpu")
    s0 = c.init(SEED)
    before = s0.bits.clone()
    c.process(s0, kb[0], tb[0])
    assert torch.equal(s0.bits, before)
    s1, d1, o1 = c.run_stream(s0, kb.reshape(-1)[:-5], tb.reshape(-1)[:-5])
    assert d1.shape == (16 * 6 - 5,) and o1.shape == (6,)
    assert s1.bits is s0.bits
    assert torch.equal(d1, dups[:-5])


def test_fleet_overflow_is_counted_and_distinct():
    """Lanes beyond a tenant's capacity are reported distinct, counted, and
    written nowhere — as in the reference."""
    jc, tc = configs("bsbf", T=2)
    tf = tfleet.FleetDedup(tc, capacity=8, device="cpu", params=tfleet
                           .TenantParams(*(torch.tensor(v) for v in (
                               [1, 1], [1, 1], [1, 1], [2, 8]))),
                           partitionable=_layout())
    jf = jfleet.FleetDedup(jc, capacity=8, params=jfleet.FleetDedup(
        jc, capacity=8).params._replace(capacity=jnp.asarray([2, 8],
                                                              jnp.int32)))
    keys = np.arange(16, dtype=np.uint32)
    tens = np.zeros(16, np.int32)
    st, res = tf.process(tf.init(SEED), keys, tens)
    assert int(res.overflow) == 14
    assert res.routed[:2].all() and not res.routed[2:].any()
    assert not res.dup[2:].any()
    js, rj = jf.process(jf.init(SEED), jnp.asarray(keys), jnp.asarray(tens))
    assert np.array_equal(res.routed.numpy(), np.asarray(rj.routed))
    assert_same_state(js, st)
    # the same keys again: the two routed lanes are now duplicates
    st, res = tf.process(st, keys, tens)
    assert res.dup[:2].all() and not res.dup[2:].any()


@pytest.mark.parametrize("partitionable", (True, False))
def test_batched_threefry_matches_vmapped_jax(partitionable):
    """Every draw over (T, 2) keys equals ``jax.vmap`` of the one-key
    ``jax.random`` call, in both counter layouts (odd counts included,
    which the original layout pads per row)."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        base = jax.random.PRNGKey(SEED)
        keys = jax.vmap(jax.random.fold_in, (None, 0))(base, jnp.arange(5))
        tk = prng.fold_in(u32.from_numpy_u32(key_data(base), "cpu"),
                          torch.arange(5))
        assert np.array_equal(u32.to_numpy_u32(tk), key_data(keys))
        part = partitionable

        def vm(fn):
            return np.asarray(jax.vmap(fn)(keys))

        assert np.array_equal(u32.to_numpy_u32(prng.split(tk, 4, part)),
                              vm(lambda k: jax.random.split(k, 4)))
        assert np.array_equal(u32.to_numpy_u32(prng.fold_in(tk, 9)),
                              vm(lambda k: jax.random.fold_in(k, 9)))
        for shape in ((7,), (3, 4), (16, 3), (1,)):
            assert np.array_equal(
                prng.randint(tk, shape, 0, 1000, part).numpy(),
                vm(lambda k: jax.random.randint(k, shape, 0, 1000,
                                                jnp.int32)))
            assert np.array_equal(
                prng.uniform(tk, shape, part).numpy(),
                vm(lambda k: jax.random.uniform(k, shape)))
        # the step's own draws over the stacked keys, row by row
        from repro_torch.core import batched as tb
        from repro.core import batched as jb
        for variant in ("rsbf", "bsbfsd", "rlbsbf", "sbf"):
            jc, tc = configs(variant)
            draw = (tb.draw_sbf_randomness if variant == "sbf"
                    else tb.draw_randomness)
            jdraw = (jb.draw_sbf_randomness if variant == "sbf"
                     else jb.draw_randomness)
            rng, got = draw(tc, tk, 8, part)
            for t in range(5):
                jr, want = jdraw(jc, keys[t], 8)
                assert np.array_equal(u32.to_numpy_u32(rng[t]), key_data(jr))
                for x, y in zip(jax.tree.leaves(want),
                                [got] if variant == "sbf" else got):
                    assert np.array_equal(y[t].numpy(), np.asarray(x))
    finally:
        jax.config.update("jax_threefry_partitionable", old)
