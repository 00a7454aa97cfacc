"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import neither jax nor the JAX package, so they run on a
GPU machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_kernels_gpu.py

Without a CUDA device they skip; the plain versions themselves are held
against the JAX package by the other ``tests/test_torch_*.py`` files."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import DedupConfig, packed, u32
from repro_torch.core import batched as tb
from repro_torch.kernels.fused_template import (bitset_step,
                                                bitset_step_plain,
                                                counter_step,
                                                counter_step_plain)

BITSET = ("rsbf", "bsbf", "bsbfsd", "rlbsbf")
COUNTER = ("sbf", "sbf_d1", "swbf", "cms", "hh")


def counter_cfg(name, **kw):
    """The counter grid's configs: sbf on planes (Max 3), sbf at Max 1
    (d = 1, squeezed), swbf, cms and hh."""
    if name == "sbf":
        return DedupConfig.for_variant("sbf", layout="planes", **kw)
    if name == "sbf_d1":
        return DedupConfig.for_variant("sbf", layout="planes", sbf_max=1,
                                       **kw)
    return DedupConfig.for_variant(name, **kw)


def random_counter_state(cfg, device, r):
    """A counter state with random cells in [0, cap], exact load, and for
    swbf a ring of random sorted slots, built with the port's own
    functions."""
    from repro_torch.core.state import FilterState, WindowRing, init_state
    d, w = cfg.n_planes, cfg.s_words
    cap = cfg.sbf_max if cfg.variant == "sbf" else (1 << d) - 1
    cells = r.integers(0, cap + 1, 32 * w)
    cells[r.random(32 * w) < 0.5] = 0
    cells[cfg.s:] = 0
    planes = packed.pack_cells(torch.from_numpy(cells).to(device), d)
    load = packed.popcount(packed.planes_nonzero(planes)[None])
    st = init_state(cfg, device=device)
    bits = planes[:, None, :].contiguous() if d > 1 else planes
    ring = None
    if st.ring is not None:
        e = st.ring.events.shape[1]
        ev = r.integers(0, cfg.s, (cfg.window, e))
        ev[r.random((cfg.window, e)) < 0.3] = 32 * w
        ring = WindowRing(torch.from_numpy(np.sort(ev, axis=1).astype(
            np.int32)).to(device), torch.tensor(3 % cfg.window,
                                                 dtype=torch.int32,
                                                 device=device))
    return FilterState(bits, st.position, load, st.rng, ring)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BITSET)
def test_kernel_matches_plain_on_card(cuda, variant):
    """The CUDA bitset step equals its plain version bit for bit on a
    half-full filter, over colliding, ragged and fresh batches."""
    from repro_torch.core import hashing, prng
    tc = DedupConfig.for_variant(variant, memory_bits=1 << 22, packed=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    words = torch.randint(-2 ** 31, 2 ** 31, (tc.k, tc.s_words),
                          dtype=torch.int32, device=cuda, generator=gen)
    load = packed.popcount(words)
    rng = prng.PRNGKey(3, cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), cuda)
    r = np.random.default_rng(5)
    position = tc.s - 3000
    for n_valid, hi in ((8192, 200), (5000, 2 ** 32), (8192, 2 ** 32)):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  cuda)
        v = torch.arange(8192, device=cuda) < n_valid
        pos = hashing.hash_positions(keys, seeds, tc.s)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position + torch.arange(8192, dtype=torch.int32, device=cuda)
        rng, rnd = tb.draw_randomness(tc, rng, 8192)
        got = words.clone()
        dup, ins, new_load = bitset_step(tc, got, pos, rnd, v, seen, i_t,
                                         load)
        new, dup_p, ins_p, load_p = bitset_step_plain(tc, words, pos, rnd, v,
                                                      seen, i_t, load)
        torch.cuda.synchronize()
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        words, load, position = got, new_load, position + n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("s", (1 << 30, 715827882, 1 << 12, 1365))
def test_hashmix_kernel_matches_plain_on_card(cuda, s):
    from repro_torch.core import hashing
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    keys = u32.from_numpy_u32(np.random.default_rng(s % 1000).integers(
        0, 2 ** 32, 8192, dtype=np.uint64), cuda)
    for k in (1, 2, 3):
        seeds = u32.from_numpy_u32(hashing.derive_seeds(7, k), cuda)
        assert torch.equal(hashmix(keys, seeds, s=s),
                           hashmix_plain(keys, seeds, s))


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BITSET)
def test_engine_on_card_matches_engine_on_cpu(cuda, variant):
    """The whole engine through the kernels equals the whole engine
    through the plain versions: reports and every state leaf."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    from repro_torch.kernels.hashmix import hashmix
    cfg = DedupConfig.for_variant(variant, memory_bits=1 << 16,
                                  batch_size=1024, packed=True)
    keys = np.random.default_rng(2).integers(0, 5000, 10_000) \
        .astype(np.uint32)
    on_card, on_cpu = Dedup(cfg, cuda), Dedup(cfg, "cpu")
    launches = (hashmix.launches, bitset_step.launches)
    sg, dg = on_card.run_stream(on_card.init(), keys)
    sc, dc = on_cpu.run_stream(on_cpu.init(), keys)
    assert hashmix.launches - launches[0] == 10
    assert bitset_step.launches - launches[1] == 10
    assert torch.equal(dg.cpu(), dc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("accumulate", (False, True))
@pytest.mark.parametrize("name", COUNTER)
def test_counter_kernel_matches_plain_on_card(cuda, name, accumulate):
    """The CUDA counter step equals its plain version bit for bit — planes,
    dup and load, and the load equals the nonzero-cell popcount — on a
    random state, over repeated, ragged and fresh batches; both values of
    ``kernel_accumulate`` launch the same kernel."""
    from repro_torch.core import hashing
    from repro_torch.core.sketch import get_spec
    cfg = dataclasses.replace(counter_cfg(name, memory_bits=1 << 22),
                              kernel_accumulate=accumulate)
    spec = get_spec(cfg.variant)
    events = spec.make_events(cfg)
    r = np.random.default_rng(11)
    st = random_counter_state(cfg, cuda, r)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k), cuda)
    for n_valid, hi in ((8192, 200), (5000, 2 ** 32), (8192, 2 ** 32)):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  cuda)
        v = torch.arange(8192, device=cuda) < n_valid
        pos = hashing.hash_positions(keys, seeds, cfg.s)
        seen = tb.intra_batch_seen(keys, v) if spec.uses_seen else None
        rng, rnd = (spec.draw(cfg, st.rng, 8192) if spec.draw
                    else (st.rng, None))
        ev = events(st, pos, v, rnd)
        planes = tb.sbf_planes_3d(st.bits)[:, 0, :]
        got = planes.clone()
        before = counter_step.launches
        dup, load = counter_step(cfg, spec, got, pos, v, seen, st.load, ev)
        new, dup_p, load_p = counter_step_plain(cfg, spec, planes, pos, v,
                                                seen, st.load, ev)
        torch.cuda.synchronize()
        assert counter_step.launches == before + 1
        assert torch.equal(got, new) and torch.equal(dup, dup_p)
        assert torch.equal(load, load_p)
        assert torch.equal(load, packed.popcount(
            packed.planes_nonzero(got)[None]))
        bits = got[:, None, :] if got.shape[0] > 1 else got
        ring = (tb.ring_push(st.ring, ev.ring_payload, cfg.window)
                if ev.ring_payload is not None else st.ring)
        st = st._replace(bits=bits, load=load, rng=rng, ring=ring)


@pytest.mark.gpu
def test_probe_and_scatter_kernels_match_plain_on_card(cuda):
    """bloom_probe and scatter_delta (OR and AND-NOT, disabled lanes given
    as -1 and as >= W) equal their plain versions on the card."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import bloom_probe_plain
    from repro_torch.kernels.scatter_delta import scatter_delta_plain
    k, w, b = 2, 1 << 16, 8192
    r = np.random.default_rng(4)
    words = u32.from_numpy_u32(r.integers(0, 2 ** 32, (k, w),
                                          dtype=np.uint64), cuda)
    idx = torch.from_numpy(r.integers(0, w, (b, k)).astype(np.int32)
                           ).to(cuda)
    mask = u32.to_i32(1 << torch.from_numpy(r.integers(0, 32, (b, k))
                                            ).to(cuda))
    assert torch.equal(ops.probe(words, idx, mask),
                       bloom_probe_plain(words, idx, mask))
    off = torch.from_numpy(r.random((b, k)) < 0.2).to(cuda)
    for disabled in (-1, w, w + 7):
        di = torch.where(off, disabled, idx).to(torch.int32).contiguous()
        want = scatter_delta_plain(di, mask, w)
        assert torch.equal(ops.scatter_or(words, di, mask), words | want)
        assert torch.equal(ops.scatter_andnot(words, di, mask),
                           words & ~want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", COUNTER)
def test_counter_engine_on_card_matches_engine_on_cpu(cuda, name):
    """The counter engine through the kernels equals it through the plain
    versions: reports and every state leaf, the swbf ring included."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    from repro_torch.kernels.hashmix import hashmix
    cfg = counter_cfg(name, memory_bits=1 << 16, batch_size=1024)
    keys = np.random.default_rng(2).integers(0, 5000, 10_000) \
        .astype(np.uint32)
    on_card, on_cpu = Dedup(cfg, cuda), Dedup(cfg, "cpu")
    launches = (hashmix.launches, counter_step.launches)
    sg, dg = on_card.run_stream(on_card.init(), keys)
    sc, dc = on_cpu.run_stream(on_cpu.init(), keys)
    assert hashmix.launches - launches[0] == 10
    assert counter_step.launches - launches[1] == 10
    assert torch.equal(dg.cpu(), dc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    assert torch.equal(on_card.estimate(sg, keys[:64]).cpu(),
                       on_cpu.estimate(sc, keys[:64]))
    for x, y in zip(on_card.top_cells(sg, 8), on_cpu.top_cells(sc, 8)):
        assert torch.equal(x.cpu(), y)
