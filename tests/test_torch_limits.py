"""The widths the reference takes and the card used to refuse, held on the
CPU against ``repro``: more than 32 hash rows (the bitset step and
``hash_positions``), sbf counter cells past 16 planes up to the 32 the
reference's plane layout holds, and the refusal past that in the
reference's words. The kernels at the same widths are held against these
plain versions by the ``-m gpu`` tests."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import Dedup as JDedup
from repro.core import DedupConfig as JConfig
from repro.core import hashing as jhashing
from repro_torch.convert import state_to_numpy
from repro_torch.core import Dedup, DedupConfig, hashing, u32


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _same(js, ts, ctx=""):
    a = {"bits": np.asarray(js.bits), "position": np.asarray(js.position),
         "load": np.asarray(js.load),
         "rng": np.asarray(jax.random.key_data(js.rng))}
    b = state_to_numpy(ts)
    for key in a:
        assert np.array_equal(a[key], b[key]), (key, ctx)


@pytest.mark.parametrize("block_bits", (0, 5))
@pytest.mark.parametrize("k", (32, 33, 64))
def test_hash_positions_past_32_rows(k, block_bits):
    keys = np.random.default_rng(k).integers(0, 2 ** 32, 1000,
                                             dtype=np.uint64)
    seeds = hashing.derive_seeds(3, k)
    bseeds = hashing.derive_seeds(3, k, 1) if block_bits else None
    s = 3_000_000
    want = jhashing.hash_positions(jnp.asarray(keys.astype(np.uint32)),
                                   jnp.asarray(seeds), s, block_bits,
                                   None if bseeds is None
                                   else jnp.asarray(bseeds))
    got = hashing.hash_positions(
        u32.from_numpy_u32(keys, "cpu"), u32.from_numpy_u32(seeds, "cpu"),
        s, block_bits,
        None if bseeds is None else u32.from_numpy_u32(bseeds, "cpu"))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("packed", (True, False))
@pytest.mark.parametrize("variant", ("rsbf", "bsbfsd", "rlbsbf"))
def test_bitset_step_past_32_rows_matches_reference(variant, packed):
    """k = 40 rows — two delete-mask words per element on the card — on
    both layouts, through rsbf's three phases (p* = 0.5)."""
    kw = dict(memory_bits=40 * 64, k=40, batch_size=64, p_star=0.5)
    jd = JDedup(JConfig(variant=variant, packed=packed, **kw))
    td = Dedup(DedupConfig(variant=variant, packed=packed, **kw), "cpu",
               partitionable=_layout())
    keys = np.random.default_rng(1).integers(0, 300, 640).astype(np.uint32)
    sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, dt = td.run_stream(td.init(), keys)
    assert td.cfg.rsbf_phase3_start < len(keys)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    _same(sj, st, (variant, packed))


@pytest.mark.parametrize("sbf_max", ((1 << 16) - 1, 1 << 16, (1 << 32) - 1))
def test_sbf_planes_past_16_planes_match_reference(sbf_max):
    """sbf on the plane layout at d = 16, 17 and 32 (Max 2^32 - 1, the
    widest cell the reference's planes hold): reports and state per
    stream equal the reference's."""
    kw = dict(memory_bits=1 << 14, batch_size=256, layout="planes",
              sbf_max=sbf_max)
    jd = JDedup(JConfig.for_variant("sbf", **kw))
    td = Dedup(DedupConfig.for_variant("sbf", **kw), "cpu",
               partitionable=_layout())
    assert td.cfg.n_planes == sbf_max.bit_length()
    keys = np.random.default_rng(2).integers(0, 400, 2048).astype(np.uint32)
    sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, dt = td.run_stream(td.init(), keys)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    _same(sj, st, sbf_max)
    want = jd.estimate(sj, jnp.asarray(keys[:64]))
    assert np.array_equal(td.estimate(st, keys[:64]).numpy(),
                          np.asarray(want))


def test_past_32_planes_refused_in_the_references_words():
    kw = dict(memory_bits=1 << 12, batch_size=64, layout="planes",
              sbf_max=1 << 32)
    with pytest.raises(OverflowError) as want:
        jd = JDedup(JConfig.for_variant("sbf", **kw))
        jd.run_stream(jd.init(), jnp.arange(64, dtype=jnp.uint32))
    with pytest.raises(OverflowError) as got:
        Dedup(DedupConfig.for_variant("sbf", **kw), "cpu")
    assert str(got.value) == str(want.value)
