"""The dense8 layout — the reference's default — in the port, on the CPU:
each batch of every variant's step bit for bit against ``repro``'s, whole
streams, the state hand-over, bitset dense8 fleets against the reference's
``FleetDedup``, and the refusals the reference makes on this layout."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Dedup as JDedup
from repro.core import DedupConfig as JConfig
from repro.core.fleet import FleetDedup as JFleet
from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.fleet import FleetDedup

VARIANTS = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")
BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _kw(variant, **kw):
    """Small dense8 configs; rsbf at p* = 0.5 so that a few thousand keys
    run through all three of its phases (s = 1365 at 4 Kbit, phase 3 from
    element 2730)."""
    out = dict(memory_bits=1 << 12, batch_size=256, **kw)
    if variant == "rsbf":
        out.setdefault("p_star", 0.5)
    return out


def _leaves(state):
    return {"bits": np.asarray(state.bits),
            "position": np.asarray(state.position),
            "load": np.asarray(state.load),
            "rng": np.asarray(jax.random.key_data(state.rng))}


def assert_same_state(js, ts, ctx=""):
    a, b = _leaves(js), state_to_numpy(ts)
    for key in ("bits", "position", "load", "rng"):
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


def _keys(n=4000, hi=3000, seed=0):
    return np.random.default_rng(seed).integers(0, hi, n).astype(np.uint32)


@pytest.mark.parametrize("block_bits", (0, 5))
@pytest.mark.parametrize("variant", VARIANTS)
def test_dense8_step_parity_per_batch(variant, block_bits):
    """Batch after batch, a ragged (padded) one among them: dup, inserted,
    the uint8 cells, load, position and rng key data equal the reference's
    at every step."""
    kw = _kw(variant, block_bits=block_bits)
    jd = JDedup(JConfig.for_variant(variant, **kw))
    td = Dedup(DedupConfig.for_variant(variant, **kw), "cpu",
               partitionable=_layout())
    assert td.cfg.effective_layout == "dense8"
    keys = _keys()
    sj, st = jd.init(), td.init()
    assert st.bits.dtype == torch.uint8
    for i in range(0, len(keys), 256):
        kk = keys[i:i + 256]
        valid = np.ones(len(kk), bool)
        if i == 512:
            valid[100:] = False
        sj, rj = jd.process(sj, jnp.asarray(kk), jnp.asarray(valid))
        st, rt = td.process(st, kk, valid)
        assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup)), i
        assert np.array_equal(rt.inserted.numpy(), np.asarray(rj.inserted))
        assert_same_state(sj, st, (variant, block_bits, i))


@pytest.mark.parametrize("variant", VARIANTS)
def test_dense8_run_stream_and_padded_parity(variant):
    """``run_stream`` over a ragged stream and ``process_padded`` at a
    wider bucket equal the reference's; process leaves the caller's state
    as it was."""
    kw = _kw(variant)
    jd = JDedup(JConfig.for_variant(variant, **kw))
    td = Dedup(DedupConfig.for_variant(variant, **kw), "cpu",
               partitionable=_layout())
    keys = _keys(3000 - 77, seed=1)
    sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, dt = td.run_stream(td.init(), keys)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st, variant)
    before = state_to_numpy(st)
    sj2, rj = jd.process_padded(sj, keys[:100], width=512)
    st2, rt = td.process_padded(st, keys[:100], width=512)
    assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup))
    assert_same_state(sj2, st2, variant)
    _, _ = td.process(st, keys[:256])
    after = state_to_numpy(st)
    assert all(np.array_equal(before[x], after[x]) for x in before)


@pytest.mark.parametrize("variant", ("sbf", "rlbsbf"))
def test_dense8_debug_exact_load_recounts(variant):
    """``debug_exact_load`` recounts the cells each step; the default exact
    delta gives the same load, and both equal the reference's."""
    kw = _kw(variant, debug_exact_load=True)
    jd = JDedup(JConfig.for_variant(variant, **kw))
    td = Dedup(DedupConfig.for_variant(variant, **kw), "cpu",
               partitionable=_layout())
    plain = Dedup(DedupConfig.for_variant(variant, **_kw(variant)), "cpu",
                  partitionable=_layout())
    keys = _keys(2000, seed=2)
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, _ = td.run_stream(td.init(), keys)
    sp, _ = plain.run_stream(plain.init(), keys)
    assert_same_state(sj, st, variant)
    assert torch.equal(st.load, sp.load)
    want = (st.bits > 0).sum(dim=-1, dtype=torch.int32)
    assert torch.equal(st.load, want.reshape(st.load.shape))


@pytest.mark.parametrize("variant", ("sbf", "rsbf"))
def test_dense8_state_hand_over_mid_stream(variant):
    """A dense8 stream started in the reference continues in the port from
    the numpy leaves, and the reverse, bit for bit."""
    kw = _kw(variant)
    jc = JConfig.for_variant(variant, **kw)
    tc = DedupConfig.for_variant(variant, **kw)
    jd, td = JDedup(jc), Dedup(tc, "cpu", partitionable=_layout())
    keys = _keys(3072, seed=3)
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(keys[:1536]))
    st = state_from_numpy(_leaves(sj), tc, "cpu")
    assert st.bits.dtype == torch.uint8
    sj, dj = jd.run_stream(sj, jnp.asarray(keys[1536:]))
    st, dt = td.run_stream(st, keys[1536:])
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st)
    leaves = state_to_numpy(st)
    assert leaves["bits"].dtype == np.uint8 and leaves["bits"].shape == (
        tc.n_rows, tc.s)
    back = state_to_numpy(state_from_numpy(leaves, tc, "cpu"))
    assert all(np.array_equal(back[x], leaves[x]) for x in leaves)
    with pytest.raises(ValueError, match="uint8"):
        state_from_numpy(dict(leaves, bits=leaves["bits"].astype(
            np.uint32)), tc, "cpu")
    with pytest.raises(ValueError, match="uint32"):
        state_from_numpy(leaves, dataclasses.replace(tc, layout="planes"),
                         "cpu")


@pytest.mark.parametrize("variant", BITSET)
def test_bitset_dense8_fleet_matches_reference(variant):
    """A bitset fleet on dense8 — the dense8 step with the tenant axis
    written out — equals the reference's vmapped ``FleetDedup``: reports,
    overflow and every tenant's state."""
    base = _kw(variant)
    jc = dataclasses.replace(JConfig.for_variant(variant, **base),
                             n_tenants=4)
    tc = dataclasses.replace(DedupConfig.for_variant(variant, **base),
                             n_tenants=4)
    jf = JFleet(jc, capacity=64)
    tf = FleetDedup(tc, capacity=64, device="cpu", partitionable=_layout())
    keys = _keys(3000, seed=4)
    ten = np.random.default_rng(5).integers(0, 4, 3000).astype(np.int32)
    sj, dj, oj = jf.run_stream(jf.init(), jnp.asarray(keys),
                               jnp.asarray(ten))
    st, dt, ot = tf.run_stream(tf.init(), keys, ten)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert np.array_equal(ot.numpy(), np.asarray(oj))
    assert int(ot.sum()) > 0                    # the capacity is exercised
    a, b = _leaves(sj), state_to_numpy(st)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert b["bits"].shape == (4, tc.k, tc.s) and b["bits"].dtype == np.uint8


def test_dense8_refusals_match_reference():
    """What the reference refuses on dense8, the port refuses in the same
    words: the oracle off dense8, counter-family dense8 fleets, and a sbf
    Max past one byte."""
    jd = JDedup(JConfig.for_variant("rlbsbf", memory_bits=1 << 12,
                                    packed=True))
    td = Dedup(DedupConfig.for_variant("rlbsbf", memory_bits=1 << 12,
                                       packed=True), "cpu")
    with pytest.raises(ValueError) as want:
        jd.run_stream_oracle(jd.init(), jnp.arange(4, dtype=jnp.uint32))
    with pytest.raises(ValueError) as got:
        td.run_stream_oracle(td.init(), np.arange(4, dtype=np.uint32))
    assert str(got.value) == str(want.value)
    jc = dataclasses.replace(JConfig.for_variant("sbf", memory_bits=1 << 12),
                             n_tenants=2)
    tc = dataclasses.replace(DedupConfig.for_variant("sbf",
                                                     memory_bits=1 << 12),
                             n_tenants=2)
    with pytest.raises(ValueError) as want:
        JFleet(jc)
    with pytest.raises(ValueError) as got:
        FleetDedup(tc, device="cpu")
    assert str(got.value) == str(want.value)
    kw = dict(memory_bits=1 << 12, batch_size=64, sbf_max=300)
    with pytest.raises(OverflowError) as want:
        jd = JDedup(JConfig.for_variant("sbf", **kw))
        jd.run_stream(jd.init(), jnp.arange(64, dtype=jnp.uint32))
    with pytest.raises(OverflowError) as got:
        Dedup(DedupConfig.for_variant("sbf", **kw), "cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("variant", VARIANTS)
def test_default_configs_run_on_dense8(variant):
    """``for_variant``'s defaults resolve to dense8 for the paper's five
    structures, and the port runs them: the same reports as the reference
    over a short stream."""
    jd = JDedup(JConfig.for_variant(variant, memory_bits=1 << 14))
    td = Dedup(DedupConfig.for_variant(variant, memory_bits=1 << 14), "cpu",
               partitionable=_layout())
    assert td.cfg.effective_layout == "dense8"
    keys = _keys(9000, hi=6000, seed=6)
    _, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    _, dt = td.run_stream(td.init(), keys)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
