"""The port's engine end to end on the CPU: the reference's pinned digests,
batch-for-batch parity with ``repro.Dedup`` (jnp and Pallas backends),
padding, state hand-over in both directions mid-stream, the device rule,
and the stream generators and read-out it ships with."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_engine as jax_engine
from repro.core import DedupConfig as JConfig
from repro.data import streams as jstreams
from repro.dedup.metrics import StreamMetrics, truth_from_stream as jtruth
from repro.dedup.pipeline import DedupPipeline as JPipeline
from repro_torch.convert import (config_from_dict, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import Dedup, DedupConfig, get_engine, next_pow2
from repro_torch.data import streams as tstreams
from repro_torch.dedup import DedupPipeline
from repro_torch.dedup.metrics import fpr_fnr, truth_from_stream

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")
SMALL = dict(memory_bits=1 << 12, batch_size=256, packed=True)

# tests/test_sketch_template.py: sha256 over per-batch dup + inserted and
# the final bits/load/position/rng key data at memory_bits=1<<14,
# batch=256, 1024 mixed keys with a ragged final batch — captured under
# JAX's original threefry counter layout
PINNED_DIGESTS = {
    "bsbf": "4e3f72a324d1eb32",
    "bsbfsd": "9936da3ee28dfb25",
    "rlbsbf": "2fa66ecae9583e86",
    "rsbf": "6371d978a8821296",
}


def _installed_layout():
    return bool(jax.config.jax_threefry_partitionable)


def _jax_leaves(state):
    return {"bits": np.asarray(state.bits),
            "position": np.asarray(state.position),
            "load": np.asarray(state.load),
            "rng": np.asarray(jax.random.key_data(state.rng))}


def assert_same_state(js, ts, ctx=""):
    a, b = _jax_leaves(js), state_to_numpy(ts)
    for key in ("bits", "position", "load", "rng"):
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


def _streams():
    r = np.random.default_rng(23)
    return {
        "dup_heavy": r.integers(0, 60, 2000).astype(np.uint32),
        "unique_heavy": r.integers(0, 1 << 30, 2000).astype(np.uint32),
        "ragged": r.integers(0, 300, 2000 - 97).astype(np.uint32),
    }


@pytest.mark.parametrize("name", sorted(PINNED_DIGESTS))
def test_pinned_digests_reproduced(name):
    cfg = DedupConfig.for_variant(name, memory_bits=1 << 14, batch_size=256,
                                  packed=True)
    eng = Dedup(cfg, "cpu", partitionable=False)
    state = eng.init()
    keys = np.random.RandomState(7).randint(0, 400, size=1024) \
        .astype(np.uint32)
    b = cfg.batch_size
    h = hashlib.sha256()
    for i in range(0, len(keys), b):
        valid = np.ones((b,), bool)
        if i + b >= len(keys):
            valid[b // 2:] = False
        state, res = eng.process(state, keys[i:i + b], valid)
        h.update(res.dup.numpy().tobytes())
        h.update(res.inserted.numpy().tobytes())
    leaves = state_to_numpy(state)
    for key in ("bits", "load", "position", "rng"):
        h.update(leaves[key].tobytes())
    assert h.hexdigest()[:16] == PINNED_DIGESTS[name]


@pytest.mark.parametrize("variant", BITSET)
def test_stream_parity_with_reference(variant):
    """run_stream over the three stream shapes: the port's reports and
    final state equal the JAX engine's on the jnp and Pallas backends."""
    jd = jax_engine(JConfig.for_variant(variant, **SMALL))
    jk = jax_engine(JConfig.for_variant(variant, backend="pallas", **SMALL))
    td = Dedup(DedupConfig.for_variant(variant, **SMALL), "cpu",
               partitionable=_installed_layout())
    for sname, keys in _streams().items():
        st, dup = td.run_stream(td.init(), keys)
        assert dup.dtype == torch.bool and dup.shape == keys.shape
        engines = (jd, jk) if sname == "ragged" else (jd,)
        for eng in engines:
            sj, dj = eng.run_stream(eng.init(), jnp.asarray(keys))
            assert np.array_equal(dup.numpy(), np.asarray(dj)), sname
            assert_same_state(sj, st, (variant, sname))
    assert td.stream_cache_size() == 2           # lengths 2000 and 1903


@pytest.mark.parametrize("variant", BITSET)
def test_batch_for_batch_parity(variant):
    jd = jax_engine(JConfig.for_variant(variant, **SMALL))
    td = Dedup(DedupConfig.for_variant(variant, **SMALL), "cpu",
               partitionable=_installed_layout())
    keys = _streams()["dup_heavy"]
    sj, st = jd.init(), td.init()
    for i in range(0, 1792, 256):
        sj, rj = jd.process(sj, jnp.asarray(keys[i:i + 256]))
        st, rt = td.process(st, keys[i:i + 256])
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup))
        assert np.array_equal(rt.inserted.numpy(), np.asarray(rj.inserted))
        assert_same_state(sj, st, (variant, i))


def test_process_padded_equals_padding_by_hand():
    cfg = DedupConfig.for_variant("rlbsbf", **SMALL)
    eng = Dedup(cfg, "cpu")
    keys = np.random.default_rng(1).integers(0, 90, 100).astype(np.uint32)
    valid = np.arange(100) < 80
    sa, ra = eng.process_padded(eng.init(), keys, valid)
    kp = np.pad(keys, (0, 156))
    vp = np.pad(valid, (0, 156))
    sb, rb = eng.process(eng.init(), kp, vp)
    assert ra.dup.shape == (100,)
    assert torch.equal(ra.dup, rb.dup[:100])
    assert torch.equal(ra.inserted, rb.inserted[:100])
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)
    # wider explicit bucket, donation updates the filter in place
    st = eng.init()
    bits = st.bits
    sc, rc = eng.process_padded(st, keys, valid, width=512, donate=True)
    assert sc.bits is bits and rc.dup.shape == (100,)
    assert eng.process_cache_size() == 2        # widths 256 and 512
    with pytest.raises(ValueError, match="exceeds pad width"):
        eng.process_padded(eng.init(), keys, width=64)
    from repro.core.engine import next_pow2 as jnext_pow2
    for n in (0, 1, 2, 3, 255, 256, 257, 8193):
        assert next_pow2(n) == jnext_pow2(n)


def test_process_leaves_input_state_untouched():
    eng = Dedup(DedupConfig.for_variant("bsbf", **SMALL), "cpu")
    st, _ = eng.run_stream(eng.init(), _streams()["dup_heavy"][:512])
    before = [x.clone() for x in st]
    new, _ = eng.process(st, np.arange(256, dtype=np.uint32))
    for x, y in zip(st, before):
        assert torch.equal(x, y)
    assert not torch.equal(new.bits, st.bits)


@pytest.mark.parametrize("variant", BITSET)
def test_state_carried_across_mid_stream(variant):
    """JAX runs 3 batches, the port takes its state over and both continue
    for 3 more: equal. Then the reverse hand-over."""
    jcfg = JConfig.for_variant(variant, **SMALL)
    tcfg = config_from_dict(dataclasses.asdict(jcfg))
    jd = jax_engine(jcfg)
    td = Dedup(tcfg, "cpu", partitionable=_installed_layout())
    keys = _streams()["ragged"]
    head, tail = keys[:768], keys[768:1536]
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(head))
    st = state_from_numpy(_jax_leaves(sj), tcfg, "cpu")
    sj, dj = jd.run_stream(sj, jnp.asarray(tail))
    st, dt = td.run_stream(st, tail)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st, variant)
    # reverse: the port starts, JAX continues
    st, _ = td.run_stream(td.init(), head)
    leaves = state_to_numpy(st)
    from repro.core.state import FilterState as JState
    sj = JState(bits=jnp.asarray(leaves["bits"]),
                position=jnp.asarray(leaves["position"]),
                load=jnp.asarray(leaves["load"]),
                rng=jnp.asarray(leaves["rng"]))
    sj, dj = jd.run_stream(sj, jnp.asarray(tail))
    st, dt = td.run_stream(st, tail)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st, (variant, "reverse"))


def test_state_from_numpy_checks_shapes():
    cfg = DedupConfig.for_variant("rlbsbf", **SMALL)
    good = state_to_numpy(Dedup(cfg, "cpu").init())
    assert good["bits"].dtype == np.uint32 and good["rng"].dtype == np.uint32
    assert good["load"].dtype == np.int32
    assert good["position"].dtype == np.int32 and good["position"].shape == ()
    with pytest.raises(ValueError, match="bits"):
        state_from_numpy(dict(good, bits=good["bits"][:1]), cfg, "cpu")
    with pytest.raises(ValueError, match="bits"):
        state_from_numpy(dict(good, bits=good["bits"].astype(np.int64)),
                         cfg, "cpu")
    with pytest.raises(ValueError, match="rng"):
        state_from_numpy(dict(good, rng=good["rng"][:1]), cfg, "cpu")


def test_device_rule_and_refusals():
    cfg = DedupConfig.for_variant("rlbsbf", **SMALL)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Dedup(cfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            state_from_numpy(state_to_numpy(Dedup(cfg, "cpu").init()), cfg)
    assert Dedup(cfg, "cpu").device.type == "cpu"
    assert get_engine(cfg, "cpu") is get_engine(cfg, "cpu")
    assert get_engine(cfg, "cpu") is not get_engine(cfg, "cpu",
                                                    partitionable=False)
    # sbf and rlbsbf default to dense8, which the port runs (uint8 cells,
    # the oracle beside the batched step); swbf, cms and hh resolve to the
    # plane layout and run
    for variant in ("sbf", "rlbsbf"):
        eng = Dedup(DedupConfig.for_variant(variant, memory_bits=1 << 12),
                    "cpu")
        assert eng.cfg.effective_layout == "dense8"
        st, dup = eng.run_stream(eng.init(), np.arange(300, dtype=np.uint32))
        assert st.bits.dtype == torch.uint8 and dup.shape == (300,)
        assert eng.run_stream_oracle(eng.init(), np.arange(
            3, dtype=np.uint32))[1].shape == (3,)
    for variant in ("swbf", "cms", "hh"):
        eng = Dedup(DedupConfig.for_variant(variant, memory_bits=1 << 12),
                    "cpu")
        assert eng.cfg.is_counter and eng.cfg.is_planes


@pytest.mark.parametrize("layout", ("dense8", "planes"))
@pytest.mark.parametrize("variant", ("rlbsbf", "sbf", "bsbf"))
def test_fleet_config_runs_as_one_filter_as_reference(variant, layout):
    """``n_tenants = 4`` on the single-filter engine and the pipeline: the
    reference ignores it and runs one filter, and so does the port — the
    same dups, words, load and position as the reference, and as the
    port's own ``n_tenants = 1``."""
    kw = dict(memory_bits=1 << 12, batch_size=256)
    if layout == "planes":
        kw.update(layout="planes") if variant == "sbf" else kw.update(
            packed=True)
    keys = _streams()["dup_heavy"]
    jd = jax_engine(JConfig.for_variant(variant, n_tenants=4, **kw))
    sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    states = {}
    for t in (4, 1):
        td = Dedup(DedupConfig.for_variant(variant, n_tenants=t, **kw),
                   "cpu", partitionable=_installed_layout())
        assert td.cfg.effective_layout == layout
        st, dup = td.run_stream(td.init(), keys)
        assert np.array_equal(dup.numpy(), np.asarray(dj)), t
        assert_same_state(sj, st, (variant, layout, t))
        states[t] = state_to_numpy(st)
    for key in ("bits", "load", "position"):
        assert np.array_equal(states[4][key], states[1][key]), key
    jp = JPipeline(JConfig.for_variant(variant, n_tenants=4, **kw))
    tp = DedupPipeline(DedupConfig.for_variant(variant, n_tenants=4, **kw),
                       device="cpu", partitionable=_installed_layout())
    for i in range(0, 1024, 256):
        jb = jp.process({"key": jnp.asarray(keys[i:i + 256])})
        tb = tp.process({"key": keys[i:i + 256]})
        assert np.array_equal(tb.dup.numpy(), np.asarray(jb.dup)), i
        assert np.array_equal(tb.weights.numpy(), np.asarray(jb.weights))
    assert_same_state(jp.state, tp.state, (variant, layout, "pipeline"))


@pytest.mark.parametrize("entry", (
    "Dedup", "get_engine", "init_state", "make_batched_step", "PRNGKey",
    "state_from_numpy"))
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Every entry point that takes a device runs on cuda unless the
    caller passes "cpu": without a card it raises, and never falls back."""
    from repro_torch.core import init_state, make_batched_step, prng
    cfg = DedupConfig.for_variant("rlbsbf", **SMALL)
    leaves = state_to_numpy(Dedup(cfg, "cpu").init())
    calls = {
        "Dedup": lambda d: Dedup(cfg, *d),
        "get_engine": lambda d: get_engine(cfg, *d),
        "init_state": lambda d: init_state(cfg, None, *d),
        "make_batched_step": lambda d: make_batched_step(cfg, *d),
        "PRNGKey": lambda d: prng.PRNGKey(5, *d),
        "state_from_numpy": lambda d: state_from_numpy(leaves, cfg, *d),
    }
    calls[entry](("cpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](("cuda",))


def test_blocked_layout_on_cpu_matches_reference():
    kw = dict(SMALL, block_bits=7)
    jd = jax_engine(JConfig.for_variant("bsbf", **kw))
    td = Dedup(DedupConfig.for_variant("bsbf", **kw), "cpu",
               partitionable=_installed_layout())
    keys = _streams()["dup_heavy"][:700]
    sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, dt = td.run_stream(td.init(), keys)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st)


def test_debug_exact_load_matches_incremental():
    cfg = DedupConfig.for_variant("rlbsbf", **SMALL)
    a, b = Dedup(cfg, "cpu"), Dedup(dataclasses.replace(
        cfg, debug_exact_load=True), "cpu")
    keys = _streams()["unique_heavy"]
    sa, da = a.run_stream(a.init(), keys)
    sb, db = b.run_stream(b.init(), keys)
    assert torch.equal(da, db)
    for x, y in zip(sa, sb):
        assert torch.equal(x, y)


# ------------------------------------------------------ streams and metrics //
def test_streams_equal_reference_generators():
    for n, frac, seed in ((5000, 0.6, 0), (3000, 0.15, 4), (1, 0.9, 2)):
        a = tstreams.controlled_distinct_stream(n, frac, seed)
        b = jstreams.controlled_distinct_stream(n, frac, seed)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    a = tstreams.zipf_stream(4000, 500, seed=3)
    b = jstreams.zipf_stream(4000, 500, seed=3)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_fpr_fnr_readout_matches_stream_metrics():
    keys, truth = tstreams.controlled_distinct_stream(4000, 0.6, seed=1)
    assert np.array_equal(truth_from_stream(keys), jtruth(keys))
    assert np.array_equal(truth_from_stream(keys), truth)
    eng = Dedup(DedupConfig.for_variant("rlbsbf", memory_bits=1 << 13,
                                        batch_size=256, packed=True), "cpu")
    _, dup = eng.run_stream(eng.init(), keys)
    m = StreamMetrics()
    m.update(dup.numpy(), truth)
    fpr, fnr = fpr_fnr(dup, truth)
    assert (fpr, fnr) == (m.fpr, m.fnr)
    assert 0.0 < fnr < 1.0 and 0.0 <= fpr < 1.0


def test_core_exports_every_reference_name():
    import repro.core as jcore
    import repro_torch.core as tcore
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in tcore.__all__:
        assert hasattr(tcore, name), name


@pytest.mark.parametrize("variant", ("rlbsbf", "sbf", "cms"))
def test_core_make_templated_step_matches_reference(variant):
    """``repro_torch.core.make_templated_step`` — one step of the template
    on the plane layout, batch for batch against the reference's."""
    from repro.core import make_templated_step as jstep_of
    from repro.core import init_state as jinit
    from repro_torch.core import init_state, make_templated_step
    kw = dict(memory_bits=1 << 12, batch_size=256)
    kw.update(packed=True) if variant == "rlbsbf" else kw.update(
        layout="planes")
    jcfg = JConfig.for_variant(variant, **kw)
    tcfg = DedupConfig.for_variant(variant, **kw)
    jstep = jax.jit(jstep_of(jcfg))
    tstep = make_templated_step(tcfg, device="cpu",
                                partitionable=_installed_layout())
    sj, st = jinit(jcfg), init_state(tcfg, None, "cpu")
    keys = _streams()["dup_heavy"]
    valid = np.ones((256,), bool)
    valid[200:] = False
    for i in range(0, 1024, 256):
        sj, rj = jstep(sj, jnp.asarray(keys[i:i + 256]), jnp.asarray(valid))
        st, rt = tstep(st, torch.from_numpy(keys[i:i + 256].view(np.int32)),
                       torch.from_numpy(valid))
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), i
        assert np.array_equal(state_to_numpy(st)["bits"],
                              np.asarray(sj.bits)), i


@pytest.mark.parametrize("variant", ("rlbsbf", "sbf"))
def test_core_make_scan_step_and_theory_match_reference(variant):
    """``repro_torch.core.make_scan_step``, the sequential oracle's element
    step, over 48 keys against the reference's; ``core.theory`` is the
    port's model module (its curves are held in test_torch_pipeline)."""
    from repro.core import make_scan_step as jscan
    from repro.core import init_state as jinit
    from repro_torch.core import init_state, make_scan_step, theory
    import repro_torch.core.theory as ttheory
    assert theory is ttheory
    cfg = dict(memory_bits=1 << 10)
    jcfg = JConfig.for_variant(variant, **cfg)
    tcfg = DedupConfig.for_variant(variant, **cfg)
    jstep = jax.jit(jscan(jcfg))
    tstep = make_scan_step(tcfg, _installed_layout())
    sj, st = jinit(jcfg), init_state(tcfg, None, "cpu")
    st = st._replace(bits=st.bits.clone())
    for key in _streams()["dup_heavy"][:48]:
        sj, dj = jstep(sj, jnp.uint32(key))
        st, dt = tstep(st, torch.tensor(int(key.view(np.int32)),
                                        dtype=torch.int32))
        assert bool(dt) == bool(dj)
    assert_same_state(sj, st, variant)
