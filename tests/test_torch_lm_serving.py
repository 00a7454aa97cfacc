"""LM serving in the port, on the CPU: the LM scorer (``make_lm_scorer``
of ``tests/torch_lm_scorer.py``)
behind ``ServeSession`` and ``ServeFrontend`` against the reference's
serving benchmark scorer (``benchmarks/serving_qps.py``'s
``make_transformer_scorer``) behind ``repro.serve.ServeSession``, from the
same weights (the scorer's seeded model, converted), and the serving steps
``make_prefill_step`` / ``make_decode_step``.

The dup verdicts must agree bit for bit (the dedup engine is the port's
bit-exact one); the scored values, means of fp32 logits from two
frameworks, within the logits' cross-framework tolerance of
``tests/test_torch_transformer.py``, 1e-4 (einsums reduce in another
order)."""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from benchmarks.serving_qps import (BUCKETS, make_transformer_scorer,
                                    request_mix)
from repro.core import DedupConfig as JConfig
from repro.models import transformer as JT
from repro.serve import ServeSession as JSession
from repro_torch import convert
from repro_torch.core import DedupConfig
from repro_torch.models import transformer as TT
from repro_torch.serve import (ServeFrontend, ServeSession, make_decode_step,
                               make_prefill_step, replay_schedule)
from torch_lm_scorer import make_lm_scorer

ATOL = 1e-4


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _dedup(pkg_config):
    """The serving benchmark's dedup config (``serving_qps._dedup_cfg``)."""
    return pkg_config.for_variant("rlbsbf", memory_bits=1 << 20,
                                  batch_size=BUCKETS[0])


@pytest.fixture(scope="module")
def scorers():
    """(reference scorer, port scorer, port cfg, port params) over the
    benchmark scorer's model: its config, its ``PRNGKey(0)`` weights."""
    ref = make_transformer_scorer()
    rc = JT.TransformerConfig(name="serve-bench", n_layers=2, d_model=64,
                              n_heads=4, n_kv_heads=2, d_ff=128, vocab=256,
                              dtype=jax.numpy.float32, attn_q_block=32,
                              attn_k_block=32)
    tree = jax.tree.map(np.asarray, JT.init(rc, jax.random.PRNGKey(0)))
    tc = TT.TransformerConfig(**dataclasses.asdict(rc))
    tp = convert.transformer_params_from_numpy(tc, tree, "cpu")
    return ref, make_lm_scorer(tc, tp), tc, tp


@pytest.mark.parametrize("m", [1, 31, 33, 100])
def test_lm_scorer_matches_reference(scorers, m):
    """Widths 32, 32, 64 and 128: key -> 16 pseudo-tokens -> the mean of
    the last position's first 8 logits, as the reference scores it."""
    ref, ours, _, _ = scorers
    keys = np.random.default_rng(m).integers(0, 1 << 32, m,
                                             dtype=np.uint64).astype(np.uint32)
    got = ours({"key": keys})
    assert got.shape == (m,) and got.dtype == np.float32
    np.testing.assert_allclose(got, np.asarray(ref({"key": keys}),
                                               np.float32), atol=ATOL)


def test_lm_session_matches_reference(scorers):
    """The serving benchmark's traffic (``request_mix``) through both
    sessions, in batches of ragged sizes: the same dup verdicts bit for
    bit, the same responses within ATOL, the same counters."""
    ref_score, our_score, _, _ = scorers
    keys = request_mix(1536, seed=7)
    js = JSession(_dedup(JConfig), ref_score, buckets=BUCKETS)
    ts = ServeSession(_dedup(DedupConfig), our_score, buckets=BUCKETS,
                      device="cpu", partitionable=_layout())
    i, sizes = 0, [1, 63, 64, 200, 1024, 184]
    for n in sizes:
        batch = {"key": keys[i:i + n]}
        i += n
        want_v, want_d, want_h = js._exec.run(batch)
        got_v, got_d, got_h = ts._exec.run(batch)
        np.testing.assert_array_equal(got_d, want_d)
        np.testing.assert_array_equal(got_h, want_h)
        np.testing.assert_allclose(np.asarray(got_v, np.float64),
                                   np.asarray(want_v, np.float64),
                                   atol=ATOL)
    assert i == keys.size
    assert (ts.n_served, ts.n_cached, ts.n_flagged_dup) == \
        (js.n_served, js.n_cached, js.n_flagged_dup)
    assert ts._exec.digest() == js._exec.digest()


def test_lm_frontend_answers_from_its_scorer_and_cache(scorers):
    """``ServeFrontend`` with the LM scorer under 16 closed-loop clients:
    every answer is the scorer's value for its key (within ATOL of scoring
    it alone), every cached answer is bit for bit an answer the scorer gave
    that key, and the live digest equals ``replay_schedule``'s."""
    _, our_score, _, _ = scorers
    keys = request_mix(512, seed=11)
    results = [None] * keys.size

    async def drive():
        fe = ServeFrontend(_dedup(DedupConfig), our_score, buckets=BUCKETS,
                           max_live_batches=4, flush_timeout=2e-3,
                           record_schedule=True, device="cpu",
                           partitionable=_layout())

        async def client(c):
            for i in range(c, keys.size, 16):
                results[i] = await fe.submit(int(keys[i]))

        async with fe:
            await asyncio.gather(*(client(c) for c in range(16)))
        return fe

    fe = asyncio.run(drive())
    alone = our_score({"key": keys})
    scored = {}
    for k, r in zip(keys, results):
        if not r.cached:
            scored.setdefault(int(k), set()).add(float(r.value))
    for k, r, a in zip(keys, results, alone):
        assert r.verdict == "ok"
        assert abs(float(r.value) - float(a)) <= ATOL
        assert float(r.value) in scored[int(k)]
    ex = fe.executor
    assert replay_schedule(_dedup(DedupConfig), ex.schedule, device="cpu",
                           partitionable=_layout()) == ex.digest()


def test_serving_steps(scorers):
    """``make_prefill_step`` / ``make_decode_step`` are the model's prefill
    and decode, with the decode cache written in place."""
    _, _, tc, tp = scorers
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, tc.vocab, (3, 9)).astype(np.int32))
    full = make_prefill_step(tc)(tp, toks)
    assert torch.equal(full, TT.prefill(tc, tp, toks))
    step = make_decode_step(tc)
    cache = TT.init_cache(tc, 3, 9, "cpu")
    for s in range(9):
        lg, out = step(tp, cache, toks[:, s],
                       torch.full((3,), s, dtype=torch.int32))
        assert out is cache
        np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(),
                                   atol=3e-4)
    assert int(cache["kpos"].max()) == 8
