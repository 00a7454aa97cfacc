"""The stream stage in the port, on the CPU, against the reference:
``DedupPipeline`` in its three modes over ``paper_config``-shaped configs
(dups, weights and the ``StreamMetrics`` summary), ``unique_gather``, the
copied stream generators, the paper configs field for field, and the
theory curves within float32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import paper_dedup as jpaper
from repro.core import theory as jtheory
from repro.core.config import DedupConfig as JConfig
from repro.data import streams as jstreams
from repro.dedup.metrics import StreamMetrics as JMetrics
from repro.dedup.pipeline import DedupPipeline as JPipeline
from repro.dedup.pipeline import unique_gather as j_unique_gather
from repro_torch.configs import paper_dedup as tpaper
from repro_torch.core import theory as ttheory
from repro_torch.core.config import DedupConfig
from repro_torch.data import streams as tstreams
from repro_torch.dedup import DedupPipeline, StreamMetrics, unique_gather

VARIANTS = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")
THEORY_RTOL = 1e-4     # numpy's float32 power against XLA's, n = 20000


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _batches(n_batches=10, b=256, seed=0):
    """Click records with fraud bursts, cut into batches with the truth."""
    recs, truth, _ = tstreams.clickstream(n_batches * b, n_users=200,
                                          n_items=400, seed=seed)
    return [({name: col[i:i + b] for name, col in recs.items()},
             truth[i:i + b]) for i in range(0, n_batches * b, b)]


@pytest.mark.parametrize("mode", ("drop", "downweight", "flag"))
@pytest.mark.parametrize("variant", ("sbf", "rlbsbf"))
def test_pipeline_matches_reference(variant, mode):
    """Per batch the same dup masks and weights as the reference's
    pipeline; the metrics' summary equal except the wall-clock
    throughput; the pipeline's final state equal."""
    kw = dict(batch_size=256)
    jcfg = jpaper.scaled_config(variant, 8, **kw)
    tcfg = tpaper.scaled_config(variant, 8, **kw)
    assert tcfg.effective_layout == "dense8"
    jp = JPipeline(jcfg, mode=mode, duplicate_weight=0.25)
    tp = DedupPipeline(tcfg, mode=mode, duplicate_weight=0.25,
                       device="cpu", partitionable=_layout())
    for batch, truth in _batches():
        jb = jp.process({k: jnp.asarray(v) for k, v in batch.items()},
                        truth)
        tb = tp.process(batch, truth)
        assert np.array_equal(tb.dup.numpy(), np.asarray(jb.dup))
        assert tb.weights.dtype == torch.float32
        assert np.array_equal(tb.weights.numpy(), np.asarray(jb.weights))
        assert np.array_equal(tb.keys.numpy().view(np.uint32),
                              np.asarray(jb.keys))
    js, ts = jp.metrics.summary(), tp.metrics.summary()
    assert ts.pop("throughput_eps") > 0
    js.pop("throughput_eps")
    assert ts == js
    assert tp.metrics.load_history == pytest.approx(
        [float(x) for x in jp.metrics.load_history], rel=0, abs=0)
    assert np.array_equal(tp.state.bits.numpy(), np.asarray(jp.state.bits))


def test_pipeline_key_fn_state_dict_and_iteration():
    """``key_fn`` picks the key, ``__call__`` streams batches, and a
    ``state_dict`` taken mid-stream is a copy that resumes to the same
    reports as the uninterrupted run."""
    cfg = tpaper.scaled_config("rsbf", 8, batch_size=256)
    batches = [b for b, _ in _batches(6, seed=1)]

    def key_fn(b):
        return b["user"] * np.uint32(1000003) + b["item"]

    whole = DedupPipeline(cfg, key_fn=key_fn, device="cpu")
    dups = [out.dup for out in whole(batches)]
    half = DedupPipeline(cfg, key_fn=key_fn, device="cpu")
    for b in batches[:3]:
        half.process(b)
    saved = half.state_dict()
    pos = int(saved["filter_state"].position)
    half.process(batches[3])
    assert int(saved["filter_state"].position) == pos    # a copy
    resumed = DedupPipeline(cfg, key_fn=key_fn, device="cpu")
    resumed.load_state_dict(saved)
    for b, want in zip(batches[3:], dups[3:]):
        assert torch.equal(resumed.process(b).dup, want)
    with pytest.raises(ValueError):
        DedupPipeline(cfg, mode="keep", device="cpu")
    with pytest.raises(KeyError, match="key_fn"):
        DedupPipeline(cfg, device="cpu").process({"user": batches[0]["user"]})


def test_stream_metrics_matches_reference():
    """The device-side accumulator against the reference's: counts, FPR,
    FNR, overflow, the load curve, convergence and the heavy-hitter
    snapshot, with folds inside the stream (a small ``_FOLD_EVERY``)."""
    r = np.random.default_rng(3)
    jm, tm = JMetrics(), StreamMetrics()
    jm._FOLD_EVERY = tm._FOLD_EVERY = 7
    load = 0
    for i in range(40):
        rep = r.random(300) < 0.4
        tru = r.random(300) < 0.5
        load = min(4000, load + int(r.integers(0, 200)))
        ld = np.array([load, load // 2], np.int32)
        ovf = np.array([i % 3], np.int32)
        jm.update(jnp.asarray(rep), tru, load=jnp.asarray(ld), s_bits=8192,
                  overflow=jnp.asarray(ovf))
        tm.update(torch.from_numpy(rep), tru, load=torch.from_numpy(ld),
                  s_bits=8192, overflow=torch.from_numpy(ovf))
        if i == 20:
            assert tm.fpr == jm.fpr and tm.converged() == jm.converged()
    for attr in ("n", "true_distinct", "true_duplicate", "false_pos",
                 "false_neg", "overflow", "fpr", "fnr"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    for window, tol in ((16, 5e-3), (4, 0.05), (8, 1.0)):
        assert tm.converged(window, tol) == jm.converged(window, tol)
        assert tm.convergence_point(window, tol) == \
            jm.convergence_point(window, tol)
    cells, counts = np.array([5, 9, 2]), np.array([7, 7, 3])
    jm.record_heavy_hitters(jnp.asarray(cells), jnp.asarray(counts))
    tm.record_heavy_hitters(torch.from_numpy(cells),
                            torch.from_numpy(counts))
    js, ts = jm.summary(), tm.summary()
    js.pop("throughput_eps"), ts.pop("throughput_eps")
    assert ts == js


@pytest.mark.parametrize("shape", ((37,), (6, 50)))
def test_unique_gather_matches_reference(shape):
    ids = np.random.default_rng(4).integers(0, 20, shape).astype(np.int32)
    ju, ji = j_unique_gather(jnp.asarray(ids))
    tu, ti = unique_gather(torch.from_numpy(ids))
    assert np.array_equal(tu.numpy(), np.asarray(ju))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    table = np.arange(20) * 10
    assert np.array_equal(table[tu.numpy()][ti.numpy()], table[ids])
    big = np.array([2 ** 32 - 1, 5, 2 ** 31, 5], np.uint32)
    ju, _ = j_unique_gather(jnp.asarray(big))
    tu, _ = unique_gather(big)
    assert np.array_equal(tu.numpy(), np.asarray(ju).astype(np.int64))


def test_stream_generators_are_exact_copies():
    for fn, args in ((tstreams.controlled_distinct_stream, (5000, 0.6)),
                     (tstreams.zipf_stream, (5000, 300)),
                     (tstreams.zipf_range_stream, (5000, 300))):
        got = fn(*args, seed=9)
        want = getattr(jstreams, fn.__name__)(*args, seed=9)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w), fn.__name__
    recs, truth, coll = tstreams.clickstream(4000, seed=2)
    jrecs, jtruth, jcoll = jstreams.clickstream(4000, seed=2)
    assert coll == jcoll and np.array_equal(truth, jtruth)
    for key in jrecs:
        assert np.array_equal(recs[key], jrecs[key]), key
    u, i = recs["user"], recs["item"]
    assert np.array_equal(tstreams.pair_truth(u, i),
                          jstreams.pair_truth(u, i))
    k16 = recs["key"] & np.uint32(0xFFFF)
    assert tstreams.key_collision_count(u, i, k16) == \
        jstreams.key_collision_count(u, i, k16) > 0
    got = list(tstreams.batched(np.arange(10), 4))
    want = list(jstreams.batched(np.arange(10), 4))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("variant", VARIANTS)
def test_paper_configs_field_for_field(variant):
    assert tpaper.PAPER_MEMORIES_MB == jpaper.PAPER_MEMORIES_MB
    assert tpaper.PAPER_DISTINCT_FRACS == jpaper.PAPER_DISTINCT_FRACS
    assert tpaper.PAPER_STREAM_SIZES == jpaper.PAPER_STREAM_SIZES
    assert (tpaper.SCALE, tpaper.MB) == (jpaper.SCALE, jpaper.MB)
    assert tpaper.scaled_stream(10 ** 9) == jpaper.scaled_stream(10 ** 9)
    for mb in tpaper.PAPER_MEMORIES_MB:
        for make in ("paper_config", "scaled_config"):
            t = getattr(tpaper, make)(variant, mb, batch_size=4096)
            j = getattr(jpaper, make)(variant, mb, batch_size=4096)
            assert isinstance(t, DedupConfig)
            assert dataclasses.asdict(t) == dataclasses.asdict(j)
            assert t.effective_layout == j.effective_layout == "dense8"
            assert (t.s, t.k, t.sbf_p_effective) == (j.s, j.k,
                                                     j.sbf_p_effective)


@pytest.mark.parametrize("variant, extra", [
    ("rsbf", {}), ("rsbf", {"p_star": 0.3}), ("bsbf", {}), ("bsbfsd", {}),
    ("rlbsbf", {})])
def test_x_series_within_float32(variant, extra):
    """The port's float32 recurrence against the reference's jitted scan
    over n = 20000, within ``THEORY_RTOL``; the closed forms equal."""
    jc = JConfig.for_variant(variant, memory_bits=1 << 12, **extra)
    tc = DedupConfig.for_variant(variant, memory_bits=1 << 12, **extra)
    want = jtheory.x_series(jc, 20000)
    got = ttheory.x_series(tc, 20000)
    np.testing.assert_allclose(got.X, want.X, rtol=THEORY_RTOL, atol=0)
    np.testing.assert_allclose(got.fpr, want.fpr, rtol=THEORY_RTOL, atol=0)
    # fnr = (1 - Y)(1 - X): with X near 1, 1 - X cancels, so its error is
    # bounded absolutely by X's, |dX| <= THEORY_RTOL * X <= THEORY_RTOL
    np.testing.assert_allclose(got.fnr, want.fnr, rtol=0, atol=THEORY_RTOL)
    assert np.array_equal(got.m, want.m) and np.array_equal(got.Y, want.Y)
    if variant == "rlbsbf":
        np.testing.assert_allclose(got.load, want.load, rtol=THEORY_RTOL)
    else:
        assert got.load is None and want.load is None
    assert ttheory.rsbf_closed_form_fpr(tc, 5e4, 1e6) == \
        jtheory.rsbf_closed_form_fpr(jc, 5e4, 1e6)
    assert ttheory.rsbf_fnr_order(tc, 1e6) == jtheory.rsbf_fnr_order(jc, 1e6)
    assert ttheory.standard_bloom_fpr(1e4, 1e5, 3) == \
        jtheory.standard_bloom_fpr(1e4, 1e5, 3)
    sj = JConfig.for_variant("sbf", memory_bits=1 << 12)
    st = DedupConfig.for_variant("sbf", memory_bits=1 << 12)
    assert ttheory.sbf_stable_fpr(st) == jtheory.sbf_stable_fpr(sj)
    a = ttheory.verify_monotone_convergence(tc, 20000)
    b = jtheory.verify_monotone_convergence(jc, 20000)
    assert (a["monotone"], a["bounded"]) == (b["monotone"], b["bounded"])
    assert a["final_X"] == pytest.approx(b["final_X"], rel=THEORY_RTOL)
    with pytest.raises(ValueError, match="closed-form"):
        ttheory.x_series(st, 10)
