"""Serving in the port, on the CPU (DESIGN.md §5.2): the reference's
front-end tests (``tests/test_serving_frontend.py``) and ServeSession tests
(``tests/test_pipeline_serving.py``) run against ``repro_torch.serve``,
and the cross-framework checks hold bit for bit — a recorded schedule
replays to the same ``verdict_digest`` in both packages (dense8, planes,
sbf, swbf, a 4-tenant fleet), a port front-end's live digest equals the
reference's replay of the schedule the port recorded, and both
``ResponseCache``s end equal after the same seeded traffic."""

import asyncio

import jax
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.serve import ResponseCache as JCache
from repro.serve import replay_schedule as j_replay
from repro_torch.core import DedupConfig
from repro_torch.core.engine import Dedup
from repro_torch.data.streams import zipf_stream
from repro_torch.serve import (DEFAULT_BUCKETS, MicroBatchExecutor,
                               ResponseCache, ServeFrontend, ServeSession,
                               VERDICT_OK, VERDICT_RETRY, replay_schedule,
                               verdict_digest)


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


# the configs of the replay parity: (variant, kw); every one at 2^14 –
# 2^16 bits, batch 64
REPLAY_CONFIGS = {
    "rlbsbf-dense8": ("rlbsbf", {}),
    "rlbsbf-planes": ("rlbsbf", dict(packed=True)),
    "sbf-planes": ("sbf", dict(layout="planes")),
    "swbf": ("swbf", dict(window=4)),
    "rlbsbf-fleet4": ("rlbsbf", dict(packed=True, n_tenants=4,
                                     memory_bits=1 << 14)),
}


def _cfg(**kw):
    kw.setdefault("memory_bits", 1 << 16)
    kw.setdefault("batch_size", 64)
    return DedupConfig.for_variant("rlbsbf", **kw)


def _both(variant, **kw):
    """The same config in both packages."""
    kw.setdefault("memory_bits", 1 << 16)
    kw.setdefault("batch_size", 64)
    return (JConfig.for_variant(variant, **kw),
            DedupConfig.for_variant(variant, **kw))


def _double(batch):
    return np.asarray(batch["key"], np.float64) * 2.0


def _kw(**kw):
    """The port's entry points on the CPU, in the installed jax's threefry
    layout."""
    return dict(device="cpu", partitionable=_layout(), **kw)


def _fe(cfg, score=_double, **kw):
    return ServeFrontend(cfg, score, **_kw(**kw))


def _session(cfg, score, **kw):
    return ServeSession(cfg, score, **_kw(**kw))


# ------------------------------------------------------- padded engine step //
def test_process_padded_invalid_lanes_never_inserted():
    """Pad-content invariance: the padded step at width W produces the
    same verdicts AND the same filter bits as a full-width step whose pad
    lanes carry arbitrary keys under valid=False."""
    eng = Dedup(_cfg(), "cpu")
    keys = np.array([3, 1, 4, 1, 5], np.uint32)
    st_a, res_a = eng.process_padded(eng.init(), keys, width=64)
    junk = np.full(64, 0xDEADBEEF, np.uint32)
    junk[:5] = keys
    valid = np.zeros(64, bool)
    valid[:5] = True
    st_b, res_b = eng.process(eng.init(), junk, valid)
    assert torch.equal(res_a.dup, res_b.dup[:5])
    assert torch.equal(st_a.bits, st_b.bits)
    assert int(st_a.position) == int(st_b.position)
    assert res_a.dup.shape == (5,)                 # sliced back to request n
    assert bool(res_a.dup[3])                      # intra-batch replay of 1


def test_process_padded_rejects_overflow_and_checks_ring_capacity():
    eng = Dedup(_cfg(), "cpu")
    with pytest.raises(ValueError, match="exceeds pad width"):
        eng.process_padded(eng.init(), np.arange(9, dtype=np.uint32), width=8)
    sw = Dedup(DedupConfig.for_variant("swbf", memory_bits=1 << 16,
                                       batch_size=64, window=4), "cpu")
    st = sw.init()                                 # ring sized for batch=64
    with pytest.raises(ValueError, match="event capacity"):
        sw.process_padded(st, np.arange(10, dtype=np.uint32), width=256)
    st = sw.init(event_capacity=256)               # widened ring: fine
    st, res = sw.process_padded(st, np.arange(10, dtype=np.uint32), width=256)
    assert res.dup.shape == (10,) and not res.dup.any()


# --------------------------------------------------- one step per bucket //
def test_serve_session_ragged_lengths_one_width_per_bucket():
    """Ragged ``serve`` lengths land in fixed buckets — one step width per
    bucket ever, not one per length."""
    sess = _session(_cfg(), _double, buckets=(64, 256))
    for n in (60, 61, 63, 64, 5, 17, 64, 2, 33):
        keys = np.arange(n, dtype=np.uint32)
        out = sess.serve({"key": keys})
        assert np.array_equal(out, keys * 2.0)
    assert sess._exec.engine.process_cache_size() == 1
    sess.serve({"key": np.arange(100, dtype=np.uint32)})   # second bucket
    assert sess._exec.engine.process_cache_size() == 2
    for n in (65, 200, 256, 7):                    # no further growth, ever
        sess.serve({"key": np.arange(n, dtype=np.uint32)})
    assert sess._exec.engine.process_cache_size() == 2


def test_executor_bucket_for_and_validation():
    ex = MicroBatchExecutor(_cfg(), _double, buckets=(256, 64), **_kw())
    assert ex.buckets == (64, 256)                 # sorted
    assert ex.bucket_for(1) == 64
    assert ex.bucket_for(64) == 64
    assert ex.bucket_for(65) == 256
    with pytest.raises(ValueError, match="exceeds largest bucket"):
        ex.bucket_for(257)
    with pytest.raises(ValueError, match="buckets"):
        MicroBatchExecutor(_cfg(), _double, buckets=(), **_kw())


@pytest.mark.parametrize("entry", ("ServeFrontend", "MicroBatchExecutor",
                                   "ServeSession", "replay_schedule"))
def test_entry_points_default_to_cuda(entry, monkeypatch):
    """Every serving entry point runs on cuda unless the caller passes
    "cpu": without a card it raises, and never falls back."""
    cfg = _cfg()
    calls = {
        "ServeFrontend": lambda d: ServeFrontend(cfg, _double, **d),
        "MicroBatchExecutor": lambda d: MicroBatchExecutor(cfg, _double,
                                                           **d),
        "ServeSession": lambda d: ServeSession(cfg, _double, **d),
        "replay_schedule": lambda d: replay_schedule(
            cfg, [(64, np.arange(3, dtype=np.uint32))], **d),
    }
    calls[entry]({"device": "cpu"})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for d in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            calls[entry](d)


# ----------------------------------------------------------- async frontend //
def test_frontend_coalesces_concurrent_requests():
    """64 concurrent submits over buckets=(64,) coalesce into far fewer
    engine steps than requests, and every answer is exact."""

    async def go():
        fe = _fe(_cfg(), buckets=(64,), max_live_batches=2,
                 flush_timeout=5e-3)
        async with fe:
            keys = list(range(100, 164))
            results = await asyncio.gather(*(fe.submit(k) for k in keys))
        return keys, results, fe

    keys, results, fe = asyncio.run(go())
    assert all(r.verdict == VERDICT_OK for r in results)
    assert [float(r.value) for r in results] == [2.0 * k for k in keys]
    st = fe.stats()
    assert st["completed"] == 64 and st["shed"] == 0
    assert st["batches"] < 64                      # actually coalesced
    assert st["completed"] + st["shed"] == st["submitted"]


def test_frontend_dup_and_cache_flags_propagate():
    async def go():
        fe = _fe(_cfg(), buckets=(64,))
        async with fe:
            first = await asyncio.gather(*(fe.submit(7) for _ in range(8)))
            again = await fe.submit(7)
        return first, again

    first, again = asyncio.run(go())
    assert all(float(r.value) == 14.0 for r in first + [again])
    # the replays of key 7 carry the Bloom dup verdict; the later request
    # is answered straight from the response cache
    assert sum(r.dup for r in first) >= 7
    assert again.cached and again.dup


def test_frontend_backpressure_sheds_with_retry_verdict():
    """Past ``queue_limit`` a submit resolves IMMEDIATELY with
    verdict="retry" (no value); every admitted request still completes
    exactly once."""

    async def go():
        fe = _fe(_cfg(), buckets=(64,), max_live_batches=1, queue_limit=8,
                 flush_timeout=1e-3)
        async with fe:
            results = await asyncio.gather(
                *(fe.submit(k) for k in range(512)))
        return results, fe

    results, fe = asyncio.run(go())
    shed = [r for r in results if r.verdict == VERDICT_RETRY]
    ok = [r for r in results if r.verdict == VERDICT_OK]
    assert shed, "queue_limit=8 under 512 concurrent submits must shed"
    assert all(r.value is None for r in shed)
    for k, r in enumerate(results):                # admitted answers exact
        if r.verdict == VERDICT_OK:
            assert float(r.value) == 2.0 * k
    st = fe.stats()
    assert st["submitted"] == 512
    assert st["completed"] == len(ok) and st["shed"] == len(shed)
    assert st["completed"] + st["shed"] == 512     # nothing lost, nothing hung
    assert 0 < st["shed_rate"] < 1


def test_frontend_partial_batch_flushes_promptly():
    """3 requests (far below the 64-bucket) do not wait for the batch to
    fill — the greedy/flush path dispatches them."""

    async def go():
        fe = _fe(_cfg(), buckets=(64,), flush_timeout=10e-3)
        async with fe:
            results = await asyncio.wait_for(
                asyncio.gather(fe.submit(1), fe.submit(2), fe.submit(3)),
                timeout=30.0)
        return results, fe

    results, fe = asyncio.run(go())
    assert [float(r.value) for r in results] == [2.0, 4.0, 6.0]
    assert fe.executor.mean_fill <= 3              # never held for a full 64


@pytest.mark.parametrize("where", ("scorer", "device step"))
def test_frontend_failure_fails_batch_not_frontend(where):
    """A failing scorer, or a failing device step, fails its batch's
    requests; the front end keeps serving."""
    calls = {"n": 0}

    def flaky(batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient failure")
        return _double(batch)

    async def go():
        fe = _fe(_cfg(), _double if where == "device step" else flaky,
                 buckets=(64,))
        if where == "device step":
            step = fe.executor.dedup_chunk

            def dedup_chunk(keys, tenants=None):
                flaky({"key": keys})
                return step(keys, tenants)
            fe.executor.dedup_chunk = dedup_chunk
        async with fe:
            with pytest.raises(RuntimeError, match="transient"):
                await fe.submit(5)
            res = await fe.submit(6)               # frontend keeps serving
        return res

    res = asyncio.run(go())
    assert res.verdict == VERDICT_OK and float(res.value) == 12.0


def test_frontend_swbf_variant_end_to_end():
    """The windowed variant rides the front-end too: the executor sizes the
    state ring to the LARGEST bucket so any padded width fits."""
    cfg = DedupConfig.for_variant("swbf", memory_bits=1 << 16,
                                  batch_size=64, window=4)

    async def go():
        fe = _fe(cfg, buckets=(64, 256))
        async with fe:
            results = await asyncio.gather(
                *(fe.submit(k % 40) for k in range(200)))
        return results, fe

    results, fe = asyncio.run(go())
    assert all(r.verdict == VERDICT_OK for r in results)
    st = fe.executor.state
    assert st.ring is not None
    assert st.ring.events.shape[-1] // cfg.k >= 256   # ring fits top bucket
    assert fe.stats()["dup"] > 0                   # repeats were flagged


# ----------------------------------------------------------- verdict parity //
@pytest.mark.parametrize("variant,kw", [("rlbsbf", {}),
                                        ("swbf", dict(window=4))],
                         ids=["rlbsbf", "swbf"])
def test_schedule_replay_parity(variant, kw):
    """Replaying the recorded admitted schedule through a fresh synchronous
    engine reproduces the front-end's verdicts bit for bit — in the port,
    and in the reference's replay of the port's schedule."""
    jcfg, cfg = _both(variant, **kw)

    async def go():
        fe = _fe(cfg, buckets=(64,), record_schedule=True)
        async with fe:
            await asyncio.gather(*(fe.submit(k % 50) for k in range(300)))
        return fe

    fe = asyncio.run(go())
    sched = fe.executor.schedule
    assert sched and all(w == 64 for w, _ in sched)
    live = fe.executor.digest()
    assert live == replay_schedule(cfg, sched, **_kw())
    assert live == j_replay(jcfg, sched)
    # tampering with one admitted key breaks the digest — the check has teeth
    w0, k0 = sched[0]
    k0 = k0.copy()
    k0[0] ^= np.uint32(1)
    assert replay_schedule(cfg, [(w0, k0)] + list(sched[1:]),
                           **_kw()) != live


def _schedule(fleet: bool, seed=0):
    """A recorded-schedule-shaped list: ragged batches at bucket widths 64
    and 256 over a small key universe (so verdicts fire), with tenant ids
    for a fleet."""
    r = np.random.default_rng(seed)
    out = []
    for n in (64, 3, 200, 64, 17, 256, 1, 90):
        keys = r.integers(0, 300, n).astype(np.uint32)
        width = 64 if n <= 64 else 256
        out.append((width, keys, r.integers(0, 4, n).astype(np.int32))
                   if fleet else (width, keys))
    return out


@pytest.mark.parametrize("name", sorted(REPLAY_CONFIGS))
def test_replay_digest_equals_reference(name):
    """One recorded schedule, replayed by both packages: the same digest,
    bit for bit."""
    variant, kw = REPLAY_CONFIGS[name]
    jcfg, cfg = _both(variant, **kw)
    sched = _schedule(cfg.n_tenants > 1)
    got = replay_schedule(cfg, sched, **_kw())
    assert got == j_replay(jcfg, sched)
    assert got != replay_schedule(cfg, sched[::-1], **_kw())


def test_fleet_frontend_digest_equals_reference_replay():
    """A 4-tenant port front-end: per-tenant isolation of verdicts and
    cached responses, its live digest equal to both packages' replay of
    the recorded 3-tuples, at most one step width per bucket."""
    variant, kw = REPLAY_CONFIGS["rlbsbf-fleet4"]
    jcfg, cfg = _both(variant, **kw)
    r = np.random.default_rng(3)
    keys = r.integers(0, 60, 400)
    tenants = r.integers(0, 4, 400)

    async def go():
        fe = _fe(cfg, buckets=(64, 256), record_schedule=True)
        async with fe:
            res = await asyncio.gather(*(fe.submit(int(k), tenant=int(t))
                                         for k, t in zip(keys, tenants)))
        return res, fe

    res, fe = asyncio.run(go())
    assert [float(x.value) for x in res] == [2.0 * k for k in keys]
    sched = fe.executor.schedule
    assert sched and all(len(x) == 3 for x in sched)
    live = fe.executor.digest()
    assert live == replay_schedule(cfg, sched, **_kw())
    assert live == j_replay(jcfg, sched)
    assert fe.executor.process_cache_size() <= 2
    # a key new to its tenant is never a cache hit, whichever other
    # tenants asked for it before
    seen = set()
    shared = 0
    for k, t, x in zip(keys, tenants, res):
        if (k, t) not in seen:
            assert not x.cached
            shared += any((k, u) in seen for u in range(4))
        seen.add((k, t))
    assert shared > 0


def test_verdict_digest_is_order_and_shape_sensitive():
    a = np.array([True, False, True])
    b = np.array([False, True])
    assert verdict_digest([a, b]) != verdict_digest([b, a])
    assert verdict_digest([a]) != verdict_digest([a[:2], a[2:]])
    assert verdict_digest([a, b]) == verdict_digest([a.copy(), b.copy()])


def test_default_buckets_are_sane():
    assert DEFAULT_BUCKETS == tuple(sorted(DEFAULT_BUCKETS))
    assert all(b > 0 for b in DEFAULT_BUCKETS)


# ---------------------------------------------------------- response cache //
def test_response_cache_vectorized_semantics():
    c = ResponseCache(4, "fifo")
    hit, vals = c.lookup(np.array([1, 2], np.uint32))
    assert not hit.any()
    c.admit(np.array([1, 2, 2], np.uint32), [10.0, 20.0, 21.0])
    hit, vals = c.lookup(np.array([2, 3, 1], np.uint32))
    assert hit.tolist() == [True, False, True]
    assert vals[0] == 21.0 and vals[2] == 10.0     # duplicate admit: last wins
    c.admit(np.array([3, 4, 5], np.uint32), [30.0, 40.0, 50.0])
    assert len(c) == 4 and c.n_evicted == 1
    assert set(c) == {2, 3, 4, 5}                  # FIFO: oldest (1) evicted
    assert ResponseCache(0).lookup(np.array([1], np.uint32))[0].tolist() == \
        [False]                                    # capacity 0 disables


def test_response_cache_lru_renews_on_hit_fifo_does_not():
    for policy, evicted in (("lru", 2), ("fifo", 1)):
        c = ResponseCache(3, policy)
        for k in (1, 2, 3):                        # distinct admit ticks
            c.admit(np.array([k], np.uint32), [float(k)])
        c.lookup(np.array([1], np.uint32))         # probe hit renews 1 (LRU)
        c.admit(np.array([9], np.uint32), [9.0])   # forces one eviction
        assert set(c) == {1, 2, 3, 9} - {evicted}, policy
    with pytest.raises(ValueError, match="policy"):
        ResponseCache(4, "clock")


@pytest.mark.parametrize("policy", ("fifo", "lru"))
def test_response_cache_equals_reference(policy):
    """The same seeded lookups and admits leave both caches with the same
    keys, values, ages and eviction count."""
    r = np.random.default_rng(11)
    ours, ref = ResponseCache(64, policy), JCache(64, policy)
    for _ in range(200):
        keys = r.integers(0, 300, r.integers(1, 40)).astype(np.uint32)
        if r.random() < 0.5:
            a, b = ours.lookup(keys), ref.lookup(keys)
            assert np.array_equal(a[0], b[0])
            assert list(a[1][a[0]]) == list(b[1][b[0]])
        else:
            vals = list(r.random(keys.shape[0]))
            ours.admit(keys, vals)
            ref.admit(keys, vals)
    assert list(ours) == list(ref) and len(ours) == len(ref) == 64
    assert list(ours._vals) == list(ref._vals)
    assert np.array_equal(ours._seq, ref._seq)
    assert ours.n_evicted == ref.n_evicted > 0


# ---------------------------------------------------------- ServeSession //
def test_serve_session_caches_duplicates():
    calls = {"n": 0}

    def score_fn(batch):
        calls["n"] += len(batch["key"])
        return np.asarray(batch["key"], np.float64) * 2.0

    sess = _session(_cfg(), score_fn)
    keys = np.array([1, 2, 3, 4] * 16, dtype=np.uint32)
    out1 = sess.serve({"key": keys})
    assert np.array_equal(out1, keys * 2.0)       # dedup never changes answers
    out2 = sess.serve({"key": keys})
    assert np.array_equal(out2, keys * 2.0)
    assert sess.hit_rate > 0.3                     # replays served from cache
    assert calls["n"] < 2 * len(keys)


def test_serve_cache_probed_before_bloom_verdict():
    """A cached response answers the request whatever the Bloom verdict —
    the cache is probed first, so a false NEGATIVE never recomputes."""
    calls = {"n": 0}

    def score_fn(batch):
        calls["n"] += len(batch["key"])
        return np.asarray(batch["key"], np.float64) * 3.0

    sess = _session(_cfg(batch_size=4), score_fn)
    sess.cache[7] = np.float64(21.0)
    out = sess.serve({"key": np.array([7, 8, 9, 10], np.uint32)})
    assert out[0] == 21.0
    assert calls["n"] == 3                        # 7 answered from cache
    assert sess.n_cached == 1


def test_serve_cache_fifo_eviction_keeps_admitting():
    """Once ``cache_size`` is reached the oldest entry is FIFO-evicted and
    new responses keep getting cached."""
    sess = _session(_cfg(batch_size=4),
                    lambda b: np.asarray(b["key"], np.float64), cache_size=4)
    sess.serve({"key": np.array([1, 2, 3, 4], np.uint32)})
    sess.serve({"key": np.array([5, 6, 7, 8], np.uint32)})
    assert len(sess.cache) == 4
    assert set(sess.cache) == {5, 6, 7, 8}        # oldest four evicted
    calls = {"n": 0}
    sess.score_fn = lambda b: (calls.__setitem__("n", calls["n"] + len(b["key"]))
                               or np.asarray(b["key"], np.float64))
    out = sess.serve({"key": np.array([5, 6, 7, 8], np.uint32)})
    assert calls["n"] == 0 and np.array_equal(out, [5.0, 6.0, 7.0, 8.0])
    sess.serve({"key": np.array([5, 5, 5, 5], np.uint32)})
    assert set(sess.cache) == {5, 6, 7, 8}        # refresh never evicts
    off = _session(_cfg(batch_size=4),
                   lambda b: np.asarray(b["key"], np.float64), cache_size=0)
    out = off.serve({"key": np.array([1, 2, 3, 4], np.uint32)})
    assert np.array_equal(out, [1.0, 2.0, 3.0, 4.0]) and not off.cache


def test_serve_cache_lru_beats_fifo_on_zipf():
    """On a zipf stream whose working set exceeds the cache, LRU holds the
    hot head at a hit rate >= FIFO's; the default policy stays FIFO."""
    keys, _ = zipf_stream(20_000, universe=4_000, a=1.2, seed=5)
    rate = {}
    for policy in ("fifo", "lru"):
        sess = _session(_cfg(batch_size=64),
                        lambda b: np.asarray(b["key"], np.float64),
                        cache_size=256, cache_policy=policy)
        for i in range(0, len(keys), 64):
            sess.serve({"key": keys[i:i + 64]})
        assert len(sess.cache) <= 256              # bound respected
        rate[policy] = sess.hit_rate
    assert rate["lru"] >= rate["fifo"] > 0
    default = _session(_cfg(batch_size=64),
                       lambda b: np.asarray(b["key"], np.float64))
    assert default._exec.cache.policy == "fifo"    # knob defaults unchanged


def test_serve_session_verdicts_equal_reference_session():
    """A port session and a reference session over the same batches report
    the same per-request dup verdicts (the executor's digest) and answers."""
    from repro.serve import ServeSession as JSession
    jcfg, cfg = _both("rlbsbf", batch_size=64)
    keys, _ = zipf_stream(3000, universe=800, a=1.2, seed=2)
    ours = _session(cfg, _double, buckets=(64, 256))
    ref = JSession(jcfg, _double, buckets=(64, 256))
    for lo, hi in ((0, 50), (50, 700), (700, 730), (730, 3000)):
        b = {"key": keys[lo:hi]}
        assert np.array_equal(ours.serve(b), ref.serve(b))
    assert ours._exec.digest() == ref._exec.digest()
    assert ours.n_flagged_dup == ref.n_flagged_dup
    assert np.array_equal(ours.state.bits.numpy(),
                          np.asarray(ref.state.bits))


def test_fleet_cache_identity_keeps_every_key_bit():
    """A fleet's cached responses are keyed by (tenant, whole key): two
    keys of one tenant that differ only in their top bits get their own
    responses. The reference tags the tenant into the top log2(T) bits of
    the 32-bit key and answers the second from the first's entry; the
    port's uint64 identity does not (a deliberate difference)."""
    from repro.serve import MicroBatchExecutor as JExecutor
    variant, kw = REPLAY_CONFIGS["rlbsbf-fleet4"]
    jcfg, cfg = _both(variant, **kw)
    a, b = 5, 5 | (1 << 30)                        # equal in the low 30 bits
    batch = {"key": np.array([a], np.uint32), "tenant": np.array([1])}
    later = {"key": np.array([b], np.uint32), "tenant": np.array([1])}
    ours = MicroBatchExecutor(cfg, _double, buckets=(64,), **_kw())
    ref = JExecutor(jcfg, _double, buckets=(64,))
    for ex in (ours, ref):
        ex.run(batch)
    (v_ours, _, hit_ours), (v_ref, _, hit_ref) = (ex.run(later)
                                                 for ex in (ours, ref))
    assert float(v_ours[0]) == 2.0 * b and not hit_ours[0]
    assert float(v_ref[0]) == 2.0 * a and hit_ref[0]
    assert ours.cache_keys(np.array([a, b], np.uint32),
                           np.array([1, 1])).tolist() == [(1 << 32) | a,
                                                          (1 << 32) | b]
