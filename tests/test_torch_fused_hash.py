"""The hash inside the port's kernels, held against the JAX package on the
CPU, exactly: the bitset step that hashes its own keys (``bitset_step``)
against its plain version fed the positions and against ``repro``'s
Pallas bitset kernel (interpret mode here), which hashes with
``repro.core.hashing.hash_positions`` — four variants, one filter and a
fleet of three, a power-of-two s and one that is not, the flat and the
blocked layout; ``ops.fused_probe`` against ``repro.kernels.ops``; and no
launch counter moving on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.core import get_engine as jax_engine
from repro.core import packed as jp
from repro.core.hashing import derive_seeds as jseeds
from repro.kernels import ops as jops
from repro_torch.core import Dedup, DedupConfig, hashing, packed, u32
from repro_torch.core import batched as tb
from repro_torch.kernels import ops
from repro_torch.kernels.bloom_probe import bloom_probe, fused_probe
from repro_torch.kernels.fused_template import (bitset_step,
                                                bitset_step_plain,
                                                counter_step)
from repro_torch.kernels.hashmix import hashmix, positions_plain
from repro_torch.kernels.scatter_delta import scatter_delta

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")
K, B = 3, 64
S_GRID = {"pow2": 1 << 11, "mod": 1365 * 2}     # bits per row


def _w(a):
    return u32.from_numpy_u32(a, "cpu")


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _key_data(k):
    try:
        return np.asarray(jax.random.key_data(k))
    except TypeError:              # legacy uint32 keys are plain arrays
        return np.asarray(k)


def _cfgs(variant, s, block_bits):
    kw = dict(variant=variant, k=K, memory_bits=K * s, batch_size=B,
              packed=True, block_bits=block_bits)
    return (JConfig(backend="pallas", **kw).validate(),
            DedupConfig(**kw).validate())


def _half_full(jeng, tc, seed, position):
    """A reference state with its filter about half set, its exact load and
    its own rng key (``init(seed)``)."""
    words = np.random.default_rng(seed).integers(
        0, 2 ** 32, (tc.k, tc.s_words), dtype=np.uint64).astype(np.uint32)
    tail = tc.s - 32 * (tc.s_words - 1)
    if tail < 32:
        words[:, -1] &= np.uint32((1 << tail) - 1)
    return jeng.init(seed)._replace(
        bits=jnp.asarray(words), load=jp.popcount(jnp.asarray(words)),
        position=jnp.asarray(position, jnp.int32))


@pytest.mark.parametrize("block_bits", (0, 5))
@pytest.mark.parametrize("s_kind", tuple(S_GRID))
@pytest.mark.parametrize("t", (1, 3))
@pytest.mark.parametrize("variant", BITSET)
def test_hashed_step_equals_pos_form_and_pallas_kernel(variant, t, s_kind,
                                                       block_bits):
    """T filters, each a half-full reference state stepped by the Pallas
    kernel on its own keys; the port steps all T at once from the keys
    (one filter: T = 1 without the tenant axis), its plain version steps
    them from the positions ``hash_positions`` gives, and all three agree
    on words, dup, inserted and load. The position sits 20 short of s, so rsbf crosses its phase
    boundary inside the batch."""
    jc, tc = _cfgs(variant, S_GRID[s_kind], block_bits)
    jeng = jax_engine(jc)
    r = np.random.default_rng(t * 10 + block_bits)
    states = [_half_full(jeng, tc, 7 + i, tc.s - 20) for i in range(t)]
    keys = r.integers(0, 90, (t, B)).astype(np.uint32)
    valid = r.random((t, B)) < 0.8
    want = [jeng.process(st, jnp.asarray(keys[i]), jnp.asarray(valid[i]))
            for i, st in enumerate(states)]

    words = _w(np.stack([np.asarray(st.bits) for st in states]))
    load = torch.from_numpy(np.stack([np.asarray(st.load)
                                      for st in states]))
    rng = torch.from_numpy(np.stack([_key_data(st.rng) for st in states])
                           .view(np.int32))
    kw, v = _w(keys), torch.from_numpy(valid)
    seen = tb.intra_batch_seen(kw, v)
    i_t = (tc.s - 20) + torch.arange(B, dtype=torch.int32).expand(t, B)
    _, rnd = tb.draw_randomness(tc, rng, B, _layout())
    seeds, bseeds = tb._seeds(tc)
    pos = hashing.hash_positions(kw, seeds, tc.s, tc.block_bits, bseeds)
    one = t == 1                       # one filter: no tenant axis

    def lead(x):
        return x[0] if one else x

    got_words = lead(words).clone()
    dup, ins, new_load = bitset_step(
        tc, got_words, lead(kw), tb.BatchRandomness(*map(lead, rnd)),
        lead(v), lead(seen), lead(i_t), lead(load), seeds=seeds,
        block_seeds=bseeds)
    pos_words, *outs = bitset_step_plain(
        tc, lead(words), lead(pos), tb.BatchRandomness(*map(lead, rnd)),
        lead(v), lead(seen), lead(i_t), lead(load))
    assert torch.equal(got_words, pos_words)
    for x, y in zip((dup, ins, new_load), outs):
        assert torch.equal(x, y)
    if one:
        got_words, dup, ins, new_load = (x[None] for x in (
            got_words, dup, ins, new_load))
    for i, (sj, rj) in enumerate(want):
        assert np.array_equal(u32.to_numpy_u32(got_words[i]),
                              np.asarray(sj.bits)), i
        assert np.array_equal(new_load[i].numpy(), np.asarray(sj.load)), i
        assert np.array_equal(dup[i].numpy(), np.asarray(rj.dup)), i
        assert np.array_equal(ins[i].numpy(), np.asarray(rj.inserted)), i


@pytest.mark.parametrize("s", (1 << 12, 3 * 1024 + 7))
@pytest.mark.parametrize("k", (1, 2, 3))
def test_fused_probe_on_cpu_equals_reference(k, s):
    """``ops.fused_probe`` (its plain chain here) against
    ``repro.kernels.ops.fused_probe`` on a half-full filter, and the
    one-launch wrapper's CPU branch against the same."""
    r = np.random.default_rng(k * 100 + s % 97)
    keys = r.integers(0, 2 ** 32, 500, dtype=np.uint64).astype(np.uint32)
    seeds = jseeds(42, k)
    w = ((s + 31) // 32 + 511) // 512 * 512    # the reference's tile width
    words = r.integers(0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    words &= r.integers(0, 2 ** 32, (k, w), dtype=np.uint64).astype(
        np.uint32)
    jdup, jhits, jpos = jops.fused_probe(jnp.asarray(keys), jnp.asarray(words),
                                         jnp.asarray(seeds), s)
    for fn in (ops.fused_probe, fused_probe):
        dup, hits, pos = fn(_w(keys), _w(words), _w(seeds), s)
        assert dup.dtype == torch.bool and hits.dtype == torch.uint8
        assert np.array_equal(dup.numpy(), np.asarray(jdup))
        assert np.array_equal(hits.numpy(), np.asarray(jhits))
        assert np.array_equal(pos.numpy(), np.asarray(jpos))
    assert 0 < int(np.asarray(jdup).sum()) < len(keys)


@pytest.mark.parametrize("block_bits", (0, 5))
def test_hashmix_wrapper_either_layout_equals_reference(block_bits):
    """The hashmix wrapper's one call (both layouts, as one launch takes
    them on the card) equals the reference's ``hash_positions`` at a
    power-of-two s and at one that is not."""
    from repro.core import hashing as jh
    keys = np.random.default_rng(block_bits).integers(
        0, 2 ** 32, 700, dtype=np.uint64).astype(np.uint32)
    for s in (1 << 16, 3 * (1 << 15) + 5):
        seeds, bseeds = jh.derive_seeds(3, 4, 0), jh.derive_seeds(3, 4, 1)
        want = np.asarray(jh.hash_positions(jnp.asarray(keys), seeds, s,
                                            block_bits, bseeds))
        got = hashmix(_w(keys), _w(seeds), s=s, block_bits=block_bits,
                      block_seeds=_w(bseeds))
        assert np.array_equal(got.numpy(), want)
        assert torch.equal(got, positions_plain(_w(keys), _w(seeds), s,
                                                block_bits, _w(bseeds)))


def test_no_launch_counter_moves_on_cpu():
    """The engines (flat and blocked layouts), the ops functions and the
    hashing wrappers run their plain versions on the CPU and count no
    launch."""
    counters = (hashmix, bitset_step, counter_step, bloom_probe,
                fused_probe, scatter_delta)
    before = [c.launches for c in counters]
    keys = np.random.default_rng(0).integers(0, 500, 2048).astype(np.uint32)
    for cfg in (DedupConfig.for_variant("rlbsbf", memory_bits=1 << 14,
                                        batch_size=256, packed=True),
                DedupConfig.for_variant("rlbsbf", memory_bits=1 << 14,
                                        batch_size=256, packed=True,
                                        block_bits=5),
                DedupConfig.for_variant("sbf", memory_bits=1 << 14,
                                        batch_size=256, layout="planes")):
        eng = Dedup(cfg, "cpu")
        eng.run_stream(eng.init(), keys)
    seeds = _w(jseeds(1, 2))
    words = torch.zeros((2, 64), dtype=torch.int32)
    dup, _, pos = ops.fused_probe(_w(keys[:100]), words, seeds, 2048)
    w_idx, mask = packed.split_pos(pos)
    ops.scatter_or(words, w_idx, mask)
    ops.probe(words, w_idx, mask)
    ops.hash_positions(_w(keys[:100]), seeds, 2048)
    assert [c.launches for c in counters] == before


def test_hashed_step_checks_its_operands():
    """The hashed step refuses keys of the wrong type or shape, seeds that
    are not (k,), and a blocked layout without block seeds, before any
    work."""
    tc = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 12, packed=True)
    eng = Dedup(tc, "cpu")
    st = eng.init()
    kw = _w(np.arange(64, dtype=np.uint32))
    v = torch.ones(64, dtype=torch.bool)
    i_t = torch.arange(1, 65, dtype=torch.int32)
    _, rnd = tb.draw_randomness(tc, st.rng, 64)
    seeds, _ = tb._seeds(tc)
    args = (rnd, v, v, i_t, st.load)
    with pytest.raises(TypeError, match="keys"):
        bitset_step(tc, st.bits, kw.long(), *args, seeds=seeds)
    with pytest.raises(ValueError, match="keys"):
        bitset_step(tc, st.bits, kw[:32], *args, seeds=seeds)
    with pytest.raises(ValueError, match="seeds"):
        bitset_step(tc, st.bits, kw, *args, seeds=seeds[:1])
    blocked = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 12,
                                      packed=True, block_bits=5)
    with pytest.raises(ValueError, match="block_seeds"):
        bitset_step(blocked, st.bits, kw, *args, seeds=seeds)


def test_launch_seeds_must_be_on_the_host():
    """A launch reads its seeds into the kernel's argument block on the
    host: CPU seeds pass through as they are, seeds anywhere else (here the
    meta device, standing for the card) are refused rather than copied,
    which would wait for the card at every launch. Any k is taken: past 32
    rows ``launch_seeds`` also stages them for the card (``-m gpu``)."""
    from repro_torch.kernels.hashmix import MAX_ROWS, host_seeds, launch_seeds
    seeds = _w(jseeds(3, 4))
    hs, hb = host_seeds(seeds, None)
    assert hb is None and torch.equal(hs, seeds)
    away = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU tensor"):
        host_seeds(away, None)
    with pytest.raises(ValueError, match="block_seeds"):
        host_seeds(seeds, away)
    wide = _w(jseeds(3, 33))
    hs, hb = host_seeds(wide, None)
    assert hb is None and torch.equal(hs, wide)
    assert launch_seeds(seeds, None, "cpu")[2] is None
    with pytest.raises(ValueError, match="CPU tensor"):
        launch_seeds(away, None, "cpu")
    assert MAX_ROWS == 32
