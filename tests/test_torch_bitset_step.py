"""The bitset step of the port against the JAX package: whole steps
against JAX's jnp step and its Pallas kernel (interpret mode here),
exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_engine as jax_engine
from repro.core import DedupConfig as JConfig
from repro.core import packed as jp
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import Dedup, DedupConfig, packed, u32
from repro_torch.core import batched as tb
from repro_torch.kernels.fused_template import (bitset_step,
                                                bitset_step_plain)

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")


def _installed_layout():
    """The threefry counter layout the installed jax draws with."""
    return bool(jax.config.jax_threefry_partitionable)


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


def _jax_leaves(state):
    return {"bits": np.asarray(state.bits), "position": np.asarray(
        state.position), "load": np.asarray(state.load),
        "rng": np.asarray(jax.random.key_data(state.rng))}


def assert_same_state(js, ts, ctx=""):
    a, b = _jax_leaves(js), state_to_numpy(ts)
    for key in ("bits", "position", "load", "rng"):
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


@pytest.mark.parametrize("variant", BITSET)
def test_plain_step_matches_jax_kernel_and_jnp_step(variant):
    """``bitset_step_plain`` on the inputs JAX's step builds: same words,
    dup, inserted and load as the Pallas kernel (interpret) and the jnp
    step, with a filter already half full so deletions bite."""
    kw = dict(memory_bits=1 << 12, batch_size=256)
    jd = jax_engine(JConfig.for_variant(variant, packed=True, **kw))
    jk = jax_engine(JConfig.for_variant(variant, backend="pallas", packed=True,
                                    **kw))
    tc = DedupConfig.for_variant(variant, packed=True, **kw)
    r = np.random.default_rng(4)
    st = _half_full(jd, tc, 4, 1300)
    keys = r.integers(0, 150, 256).astype(np.uint32)
    valid = np.arange(256) < 190
    sj, rj = jd.process(st, jnp.asarray(keys), jnp.asarray(valid))
    sk, rk = jk.process(st, jnp.asarray(keys), jnp.asarray(valid))
    # the step's inputs, built by the port from the same state
    ts = state_from_numpy(_jax_leaves(st), tc, "cpu")
    from repro_torch.core import hashing
    seeds = _w(hashing.derive_seeds(tc.seed, tc.k))
    kw_ = _w(keys)
    v = torch.from_numpy(valid)
    pos = hashing.hash_positions(kw_, seeds, tc.s)
    seen = tb.intra_batch_seen(kw_, v)
    i_t = ts.position + torch.arange(256, dtype=torch.int32)
    _, rnd = tb.draw_randomness(tc, ts.rng, 256, _installed_layout())
    new, dup, ins, new_load = bitset_step_plain(tc, ts.bits, pos, rnd, v,
                                                seen, i_t, ts.load)
    for sx, rx in ((sj, rj), (sk, rk)):
        assert np.array_equal(u32.to_numpy_u32(new), np.asarray(sx.bits))
        assert np.array_equal(new_load.numpy(), np.asarray(sx.load))
        assert np.array_equal(dup.numpy(), np.asarray(rx.dup))
        assert np.array_equal(ins.numpy(), np.asarray(rx.inserted))


@pytest.mark.parametrize("variant", BITSET)
def test_ragged_steps_match_jnp_and_pallas(variant):
    """Step-level parity with ragged valid masks interleaved mid-stream:
    dup, inserted, bits, load, position and rng key data, every step."""
    kw = dict(memory_bits=1 << 12, batch_size=256, packed=True)
    jd = jax_engine(JConfig.for_variant(variant, **kw))
    jk = jax_engine(JConfig.for_variant(variant, backend="pallas", **kw))
    td = Dedup(DedupConfig.for_variant(variant, **kw), "cpu",
               partitionable=_installed_layout())
    sj, sk, st = jd.init(), jk.init(), td.init()
    keys = np.random.default_rng(3).integers(0, 120, 256 * 4) \
        .astype(np.uint32)
    for i, nv in enumerate((256, 61, 256, 1)):
        kb = keys[i * 256:(i + 1) * 256]
        valid = np.arange(256) < nv
        sj, rj = jd.process(sj, jnp.asarray(kb), jnp.asarray(valid))
        sk, rk = jk.process(sk, jnp.asarray(kb), jnp.asarray(valid))
        st, rt = td.process(st, kb, valid)
        for js, jr in ((sj, rj), (sk, rk)):
            assert np.array_equal(rt.dup.numpy(), np.asarray(jr.dup))
            assert np.array_equal(rt.inserted.numpy(),
                                  np.asarray(jr.inserted))
            assert_same_state(js, st, (variant, i))


def _half_full(jeng, tc, seed, position):
    """A JAX state whose filter is about half set, with its exact load."""
    words = np.random.default_rng(seed).integers(
        0, 2 ** 32, (tc.k, tc.s_words), dtype=np.uint64).astype(np.uint32)
    tail = tc.s - 32 * (tc.s_words - 1)        # bits past s stay clear
    if tail < 32:
        words[:, -1] &= np.uint32((1 << tail) - 1)
    load = np.asarray(jp.popcount(jnp.asarray(words)))
    return jeng.init()._replace(bits=jnp.asarray(words),
                                load=jnp.asarray(load),
                                position=jnp.asarray(position, jnp.int32))


@pytest.mark.parametrize("variant", ("rsbf", "rlbsbf"))
def test_full_width_batch_with_colliding_keys(variant):
    """B = 8192 over a small filter (memory_bits = 2^16), half full, with
    heavily colliding keys: many elements share probe and deletion words."""
    kw = dict(memory_bits=1 << 16, batch_size=8192, packed=True)
    jd = jax_engine(JConfig.for_variant(variant, **kw))
    jk = jax_engine(JConfig.for_variant(variant, backend="pallas", **kw))
    tc = DedupConfig.for_variant(variant, **kw)
    td = Dedup(tc, "cpu", partitionable=_installed_layout())
    st0 = _half_full(jd, tc, 8, tc.s - 3000)
    keys = np.random.default_rng(8).integers(0, 3000, 8192).astype(np.uint32)
    valid = np.arange(8192) < 7000
    st, rt = td.process(state_from_numpy(_jax_leaves(st0), tc, "cpu"), keys,
                        valid)
    for eng in (jd, jk):
        sj, rj = eng.process(st0, jnp.asarray(keys), jnp.asarray(valid))
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup))
        assert np.array_equal(rt.inserted.numpy(), np.asarray(rj.inserted))
        assert_same_state(sj, st, variant)


def test_wrapper_on_cpu_updates_in_place_without_launch():
    tc = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 12, packed=True)
    eng = Dedup(tc, "cpu")
    st = eng.init()
    keys = _w(np.arange(64, dtype=np.uint32))
    from repro_torch.core import hashing
    pos = hashing.hash_positions(keys, _w(hashing.derive_seeds(tc.seed, 2)),
                                 tc.s)
    v = torch.ones(64, dtype=torch.bool)
    seen = tb.intra_batch_seen(keys, v)
    i_t = torch.arange(1, 65, dtype=torch.int32)
    _, rnd = tb.draw_randomness(tc, st.rng, 64)
    words = st.bits.clone()
    seeds = _w(hashing.derive_seeds(tc.seed, 2))
    before = bitset_step.launches
    dup, ins, load = bitset_step(tc, words, keys, rnd, v, seen, i_t, st.load,
                                 seeds=seeds)
    new, dup_p, ins_p, load_p = bitset_step_plain(tc, st.bits, pos, rnd, v,
                                                  seen, i_t, st.load)
    assert bitset_step.launches == before
    assert torch.equal(words, new) and torch.equal(load, load_p)
    assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
    assert torch.equal(load, packed.popcount(words))
    with pytest.raises(ValueError, match="i_t"):
        bitset_step(tc, words, keys, rnd, v, seen, i_t.long(), st.load,
                    seeds=seeds)
    with pytest.raises(ValueError, match="words"):
        bitset_step(tc, words[:1], keys, rnd, v, seen, i_t, st.load,
                    seeds=seeds)
    with pytest.raises(ValueError, match="contiguous"):
        bitset_step(tc, words, keys, rnd._replace(
            u_aux=rnd.u_aux.T.contiguous().T), v, seen, i_t, st.load,
            seeds=seeds)
