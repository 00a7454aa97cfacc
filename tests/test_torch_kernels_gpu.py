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
    from repro_torch.kernels.hashmix import hashmix_plain
    tc = DedupConfig.for_variant(variant, memory_bits=1 << 22, packed=True)
    gen = torch.Generator(device=cuda).manual_seed(1)
    words = torch.randint(-2 ** 31, 2 ** 31, (tc.k, tc.s_words),
                          dtype=torch.int32, device=cuda, generator=gen)
    load = packed.popcount(words)
    rng = prng.PRNGKey(3, cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(tc.seed, tc.k), "cpu")
    r = np.random.default_rng(5)
    position = tc.s - 3000
    for n_valid, hi in ((8192, 200), (5000, 2 ** 32), (8192, 2 ** 32)):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  cuda)
        v = torch.arange(8192, device=cuda) < n_valid
        pos = hashmix_plain(keys, seeds.to(cuda), tc.s)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position + torch.arange(8192, dtype=torch.int32, device=cuda)
        rng, rnd = tb.draw_randomness(tc, rng, 8192)
        got = words.clone()
        dup, ins, new_load = bitset_step(tc, got, keys, rnd, v, seen, i_t,
                                         load, seeds=seeds)
        new, dup_p, ins_p, load_p = bitset_step_plain(tc, words, pos, rnd, v,
                                                      seen, i_t, load)
        torch.cuda.synchronize()
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        words, load, position = got, new_load, position + n_valid


@pytest.mark.gpu
@pytest.mark.parametrize("s", (1 << 30, 715827882, 1 << 12, 1365))
def test_hashmix_kernel_matches_plain_on_card(cuda, s):
    """k from 1 to 32 (the seeds staged per block), B not a multiple of
    the block; the seeds are given on the host, and seeds on the card are
    refused."""
    from repro_torch.core import hashing
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    keys = u32.from_numpy_u32(np.random.default_rng(s % 1000).integers(
        0, 2 ** 32, 8191, dtype=np.uint64), cuda)
    for k in (1, 2, 3, 4, 6, 8, 32):
        seeds = u32.from_numpy_u32(hashing.derive_seeds(7, k), "cpu")
        want = hashmix_plain(keys, seeds.to(cuda), s)
        assert torch.equal(hashmix(keys, seeds, s=s), want)
        with pytest.raises(ValueError, match="CPU tensor"):
            hashmix(keys, seeds.to(cuda), s=s)


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
    # the bitset kernel hashes its keys itself: no hashmix launch
    assert hashmix.launches - launches[0] == 0
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
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k),
                               "cpu")
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


# ------------------------------------------------ the tenant axis (fleets) //
TENANTS = (1, 4, 32)


def fleet_cfg(variant, t, **kw):
    """A fleet config of ``t`` tenants on the plane layout."""
    kw.setdefault("memory_bits", 1 << 20)
    if variant == "sbf":
        kw["layout"] = "planes"
    elif variant in BITSET:
        kw["packed"] = True
    return dataclasses.replace(DedupConfig.for_variant(variant, **kw),
                               n_tenants=t).validate()


def fleet_lanes(cfg, t, c, r, device, hi=200):
    """(T, C) slot keys from a small key space (repeats across and inside
    rows, many CTAs per row), about a third of them invalid, and the last
    tenant's row empty (all invalid) when T > 1."""
    keys = u32.from_numpy_u32(r.integers(0, hi, (t, c), dtype=np.uint64),
                              device)
    valid = torch.from_numpy(r.random((t, c)) < 0.66).to(device)
    if t > 1:
        valid[-1] = False
    return keys, valid


@pytest.mark.gpu
@pytest.mark.parametrize("t", TENANTS)
@pytest.mark.parametrize("variant", BITSET)
def test_tenant_axis_bitset_kernel_matches_plain_on_card(cuda, variant, t):
    """The bitset step over a leading tenant axis (one launch for all T
    filters) equals its plain version, tenant by tenant, on half-full
    filters over three batches; the empty row's filter and load stay."""
    from repro_torch.core import hashing, prng
    cfg = fleet_cfg(variant, t)
    k, w, c = cfg.k, cfg.s_words, 2048
    gen = torch.Generator(device=cuda).manual_seed(t)
    words = torch.randint(-2 ** 31, 2 ** 31, (t, k, w), dtype=torch.int32,
                          device=cuda, generator=gen)
    load = packed.popcount(words)
    rng = prng.fold_in(prng.PRNGKey(3, cuda),
                       torch.arange(t, device=cuda))
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, k), "cpu")
    r = np.random.default_rng(t)
    position = torch.full((t,), cfg.s - 3000, dtype=torch.int32,
                          device=cuda)
    for hi in (200, 2 ** 32, 2 ** 32):
        keys, v = fleet_lanes(cfg, t, c, r, cuda, hi)
        pos = hashing.hash_positions(keys, seeds, cfg.s)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=cuda)
        rng, rnd = tb.draw_randomness(cfg, rng, c)
        got = words.clone()
        before = bitset_step.launches
        dup, ins, new_load = bitset_step(cfg, got, keys, rnd, v, seen, i_t,
                                         load, seeds=seeds)
        new, dup_p, ins_p, load_p = bitset_step_plain(cfg, words, pos, rnd,
                                                      v, seen, i_t, load)
        torch.cuda.synchronize()
        assert bitset_step.launches == before + 1
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        assert torch.equal(new_load, packed.popcount(got))
        if t > 1:
            assert torch.equal(got[-1], words[-1])
        words, load = got, new_load
        position = position + v.sum(dim=1, dtype=torch.int32)


def random_fleet_counter_state(cfg, device, r):
    """A stacked counter state: per tenant random cells in [0, 2^d - 1]
    (half of them zero) with their exact load, and for swbf random sorted
    ring slots and per-tenant slot positions."""
    from repro_torch.core.fleet import init_fleet_state
    from repro_torch.core.state import FilterState, WindowRing
    t, d, w = cfg.n_tenants, cfg.n_planes, cfg.s_words
    cells = r.integers(0, 1 << d, (t, 32 * w))
    cells[r.random((t, 32 * w)) < 0.5] = 0
    cells[:, cfg.s:] = 0
    planes = torch.stack([packed.pack_cells(
        torch.from_numpy(x).to(device), d) for x in cells])     # (T, d, W)
    load = torch.stack([packed.popcount(packed.planes_nonzero(p)[None])
                        for p in planes])
    st = init_fleet_state(cfg, event_capacity=2048, device=device)
    bits = planes[:, :, None, :].contiguous() if d > 1 else planes
    ring = None
    if st.ring is not None:
        e = st.ring.events.shape[-1]
        ev = r.integers(0, cfg.s, (t, cfg.window, e))
        ev[r.random(ev.shape) < 0.3] = 32 * w
        ring = WindowRing(
            torch.from_numpy(np.sort(ev, axis=-1).astype(np.int32)).to(
                device),
            torch.from_numpy((np.arange(t) % cfg.window).astype(np.int32))
            .to(device))
    return FilterState(bits, st.position, load, st.rng, ring)


def hetero_knobs(cfg, t, device):
    """Per-tenant rows: sbf Max alternating 3 and 2, cms/hh thresholds
    1, 2, 3, 2, ..., swbf windows cycling through 1..window."""
    tt = np.arange(t)
    rows = {"max_value": np.where(tt % 2 == 0, cfg.sbf_max,
                                  max(1 << (cfg.sbf_max.bit_length() - 1),
                                      cfg.sbf_max - 1)),
            "threshold": np.array([1, 2, 3, 2])[tt % 4],
            "window": 1 + tt % max(cfg.window, 1)}
    return {n: torch.from_numpy(v.astype(np.int32)).to(device)
            for n, v in rows.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("t", TENANTS)
@pytest.mark.parametrize("variant", ("sbf", "swbf", "cms", "hh"))
def test_params_aware_counter_kernel_matches_plain_on_card(cuda, variant, t):
    """The counter step over a leading tenant axis with per-tenant
    threshold and set-to-Max rows read on the device (the params-aware
    form) equals its plain version tenant by tenant — planes, dup and load,
    the load equal to each tenant's nonzero-cell popcount — over three
    batches of colliding keys; the empty row's tenant changes only by its
    expiring ring slot."""
    from repro_torch.core import hashing
    from repro_torch.core.sketch import get_spec
    cfg = fleet_cfg(variant, t, **({"window": 4} if variant == "swbf"
                                   else {}))
    spec = get_spec(cfg.variant)
    events = spec.make_events(cfg)
    r = np.random.default_rng(11 + t)
    st = random_fleet_counter_state(cfg, cuda, r)
    knobs = hetero_knobs(cfg, t, cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k),
                               "cpu")
    c = 2048
    for hi in (200, 2 ** 32, 2 ** 32):
        keys, v = fleet_lanes(cfg, t, c, r, cuda, hi)
        pos = hashing.hash_positions(keys, seeds, cfg.s)
        seen = tb.intra_batch_seen(keys, v) if spec.uses_seen else None
        rng, rnd = (spec.draw(cfg, st.rng, c) if spec.draw
                    else (st.rng, None))
        ev = events(st, pos, v, rnd)
        planes = tb.fleet_planes(st.bits)
        got = planes.clone()
        before = counter_step.launches
        dup, load = counter_step(cfg, spec, got, pos, v, seen, st.load, ev,
                                 threshold=knobs["threshold"],
                                 max_value=knobs["max_value"])
        new, dup_p, load_p = counter_step_plain(
            cfg, spec, planes, pos, v, seen, st.load, ev,
            knobs["threshold"], knobs["max_value"])
        torch.cuda.synchronize()
        assert counter_step.launches == before + 1
        assert torch.equal(got, new) and torch.equal(dup, dup_p)
        assert torch.equal(load, load_p)
        for i in range(t):
            assert torch.equal(load[i], packed.popcount(
                packed.planes_nonzero(got[i])[None]))
        if t > 1 and variant != "swbf":
            assert torch.equal(got[-1], planes[-1])
        bits = got[:, :, None, :].contiguous() if got.shape[1] > 1 else got
        ring = (tb.ring_push(st.ring, ev.ring_payload, knobs["window"])
                if ev.ring_payload is not None else st.ring)
        st = st._replace(bits=bits, load=load, rng=rng, ring=ring)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("rlbsbf", "bsbfsd", "sbf", "swbf",
                                     "cms"))
def test_fleet_on_card_matches_fleet_on_cpu(cuda, variant):
    """The whole fleet through the kernels equals it through the plain
    versions, with one step launch per fleet step, and one hashmix launch
    per step on the counter paths only (the bitset kernel hashes its
    keys itself)."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.fleet import FleetDedup, default_tenant_params
    from repro_torch.kernels.hashmix import hashmix
    cfg = fleet_cfg(variant, 8, memory_bits=1 << 16, batch_size=1024,
                    **({"window": 4} if variant == "swbf" else {}))
    r = np.random.default_rng(3)
    keys = r.integers(0, 3000, 10_000).astype(np.uint32)
    tens = r.integers(0, 8, 10_000).astype(np.int32)
    fleets = []
    for dev in (cuda, "cpu"):
        p = default_tenant_params(cfg, 256, dev)
        knobs = hetero_knobs(cfg, 8, dev)
        if variant in ("sbf", "cms", "swbf"):
            field = {"sbf": "max_value", "cms": "threshold",
                     "swbf": "window"}[variant]
            p = p._replace(**{field: knobs[field]})
        fleets.append(FleetDedup(cfg, capacity=256, params=p, device=dev))
    launches = (hashmix.launches, bitset_step.launches,
                counter_step.launches)
    sg, dg, og = fleets[0].run_stream(fleets[0].init(), keys, tens)
    sc, dc, oc = fleets[1].run_stream(fleets[1].init(), keys, tens)
    step = bitset_step if variant in BITSET else counter_step
    assert hashmix.launches - launches[0] == (0 if step is bitset_step
                                              else 10)
    assert step.launches - launches[1 if step is bitset_step else 2] == 10
    assert torch.equal(dg.cpu(), dc) and torch.equal(og.cpu(), oc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    assert a.keys() == b.keys()
    for key in a:
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.gpu
@pytest.mark.parametrize("block_bits", (5, 9))
def test_blocked_layout_on_card_matches_plain(cuda, block_bits):
    """The blocked layout on the card (one hashmix launch) equals the
    formula of two plain hashmix calls, at a power-of-two s and at one
    that is not."""
    from repro_torch.core import hashing
    from repro_torch.kernels.hashmix import hashmix, hashmix_plain
    keys = u32.from_numpy_u32(np.random.default_rng(block_bits).integers(
        0, 2 ** 32, 8192, dtype=np.uint64), cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(9, 3, 0), "cpu")
    bseeds = u32.from_numpy_u32(hashing.derive_seeds(9, 3, 1), "cpu")
    for s in (1 << 20, 3_000_000):
        before = hashmix.launches
        got = hashing.hash_positions(keys, seeds, s, block_bits, bseeds)
        assert hashmix.launches == before + 1
        bsize = 1 << block_bits
        want = (hashmix_plain(keys.cpu(), bseeds.cpu(), max(1, s // bsize))
                .long() * bsize + hashmix_plain(keys.cpu(), seeds.cpu(),
                                                bsize))
        assert torch.equal(got.cpu(), want.to(torch.int32))
        assert int(got.max()) < s


# ---------------------------------- the designs' edges (merge path, grid) //

def dense_counter_inputs(cfg, t, c, r, device):
    """(T, C) lanes whose cells crowd a few words: per tenant, 60% of the
    cells fall in 64 neighbouring words (more than 32 events on a word),
    30% on one hot cell (runs far past any count cap), the rest anywhere;
    sbf's decrement runs start in the same words (words both lists touch)
    and often at one cell; swbf's expiring slot repeats cells the same way.
    Each row's merged events span many 128-event tiles, so words straddle
    tile edges. About a third of the lanes are invalid and the last
    tenant's row is sentinel-only when T > 1. -> (state, pos, valid, seen,
    events)."""
    from repro_torch.core.state import WindowRing
    from repro_torch.core.sketch import get_spec
    spec = get_spec(cfg.variant)
    st = random_fleet_counter_state(cfg, device, r)
    k, s = cfg.k, cfg.s
    base = r.integers(0, s - 64 * 32, (t, 1, 1))
    crowd = base + r.integers(0, 64 * 32, (t, c, k))
    hot = base + r.integers(0, 64 * 32, (t, 1, 1))
    pick = r.random((t, c, k))
    cells = np.where(pick < 0.6, crowd,
                     np.where(pick < 0.9, hot, r.integers(0, s, (t, c, k))))
    pos = torch.from_numpy(cells.astype(np.int32)).to(device)
    keys, valid = fleet_lanes(cfg, t, c, r, device)
    seen = tb.intra_batch_seen(keys, valid) if spec.uses_seen else None
    rnd = None
    if cfg.variant == "sbf":
        start = np.where(r.random((t, c)) < 0.5, hot[:, :, 0],
                         crowd[:, :, 0])
        rnd = torch.from_numpy(start.astype(np.int32)).to(device)
    if st.ring is not None:
        e = st.ring.events.shape[-1]
        ring = np.where(r.random((t, cfg.window, e)) < 0.5, hot,
                        base + r.integers(0, 64 * 32, (t, cfg.window, e)))
        ring[r.random(ring.shape) < 0.2] = 32 * cfg.s_words
        st = st._replace(ring=WindowRing(
            torch.from_numpy(np.sort(ring, axis=-1).astype(np.int32)).to(
                device), st.ring.slot))
    return st, pos, valid, seen, spec.make_events(cfg)(st, pos, valid, rnd)


@pytest.mark.gpu
@pytest.mark.parametrize("c", (1000, 0))
@pytest.mark.parametrize("t", TENANTS)
@pytest.mark.parametrize("variant", ("sbf", "swbf", "cms", "hh"))
def test_counter_kernel_merge_path_edges_on_card(cuda, variant, t, c):
    """The merge-path counter kernel equals its plain version where its
    design has edges: words both lists touch, more than 32 events on one
    word, runs longer than the count cap, words whose events straddle a
    tile edge, a sentinel-only tenant row, a batch of C = 1000 lanes (not
    a multiple of the block) and an empty one (C = 0), at T = 1, 4, 32."""
    from repro_torch.core.sketch import get_spec
    cfg = fleet_cfg(variant, t, **({"window": 4} if variant == "swbf"
                                   else {}))
    spec = get_spec(cfg.variant)
    r = np.random.default_rng(17 + t + c)
    st, pos, v, seen, ev = dense_counter_inputs(cfg, t, c, r, cuda)
    knobs = hetero_knobs(cfg, t, cuda)
    planes = tb.fleet_planes(st.bits)
    got = planes.clone()
    before = counter_step.launches
    dup, load = counter_step(cfg, spec, got, pos, v, seen, st.load, ev,
                             threshold=knobs["threshold"],
                             max_value=knobs["max_value"])
    new, dup_p, load_p = counter_step_plain(
        cfg, spec, planes, pos, v, seen, st.load, ev, knobs["threshold"],
        knobs["max_value"])
    torch.cuda.synchronize()
    assert counter_step.launches == before + 1
    assert torch.equal(got, new) and torch.equal(dup, dup_p)
    assert torch.equal(load, load_p)
    if c > 0:
        assert not torch.equal(got, planes)      # the batch changed cells


@pytest.mark.gpu
@pytest.mark.parametrize("t, c", ((32, 16384), (4, 1000), (1, 8191)))
@pytest.mark.parametrize("variant", ("rsbf", "rlbsbf"))
def test_bitset_kernel_large_and_ragged_grids_on_card(cuda, variant, t, c):
    """The bitset step equals its plain version on more lanes than the card
    holds resident at once (T = 32 x 16384: 2^19 lanes) and on lanes that
    are not a multiple of the block."""
    from repro_torch.core import hashing, prng
    cfg = fleet_cfg(variant, t, memory_bits=1 << 18)
    k = cfg.k
    gen = torch.Generator(device=cuda).manual_seed(t)
    words = torch.randint(-2 ** 31, 2 ** 31, (t, k, cfg.s_words),
                          dtype=torch.int32, device=cuda, generator=gen)
    load = packed.popcount(words)
    rng = prng.fold_in(prng.PRNGKey(5, cuda), torch.arange(t, device=cuda))
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, k), "cpu")
    r = np.random.default_rng(c)
    position = torch.full((t,), cfg.s - 3000, dtype=torch.int32,
                          device=cuda)
    for hi in (500, 2 ** 32):
        keys, v = fleet_lanes(cfg, t, c, r, cuda, hi)
        pos = hashing.hash_positions(keys, seeds, cfg.s)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=cuda)
        rng, rnd = tb.draw_randomness(cfg, rng, c)
        got = words.clone()
        before = bitset_step.launches
        dup, ins, new_load = bitset_step(cfg, got, keys, rnd, v, seen, i_t,
                                         load, seeds=seeds)
        new, dup_p, ins_p, load_p = bitset_step_plain(cfg, words, pos, rnd,
                                                      v, seen, i_t, load)
        torch.cuda.synchronize()
        assert bitset_step.launches == before + 1
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        assert torch.equal(new_load, packed.popcount(got))
        words, load = got, new_load
        position = position + v.sum(dim=1, dtype=torch.int32)


# ------------------------- the hash inside the kernels (hashmix.cuh users) //

def random_filter(cfg, device, seed):
    """(k, W) words at ~50% density with the bits past s clear, and their
    load."""
    gen = torch.Generator(device=device).manual_seed(seed)
    words = torch.randint(-2 ** 31, 2 ** 31, (cfg.k, cfg.s_words),
                          dtype=torch.int32, device=device, generator=gen)
    tail = cfg.s - 32 * (cfg.s_words - 1)
    if tail < 32:
        words[:, -1] &= (1 << tail) - 1
    return words, packed.popcount(words)


def hashed_step_case(device, k, s, block_bits, variant="rlbsbf",
                     position=1):
    """The bitset step hashing its keys in the kernel equals the plain
    hashmix (``positions_plain``) feeding ``bitset_step_plain``, over a
    colliding and a fresh batch with a ragged valid mask, the stream at
    ``position``; it launches no hashmix."""
    from repro_torch.core import prng
    from repro_torch.kernels.hashmix import hashmix, positions_plain
    cfg = DedupConfig(variant=variant, k=k, memory_bits=k * s, packed=True,
                      block_bits=block_bits).validate()
    words, load = random_filter(cfg, device, k)
    seeds, bseeds = tb._seeds(cfg)
    rng = prng.PRNGKey(k, device)
    r = np.random.default_rng(s % 1009 + k)
    for hi in (200, 2 ** 32):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  device)
        v = torch.from_numpy(r.random(8192) < 0.9).to(device)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position + torch.arange(8192, dtype=torch.int32, device=device)
        rng, rnd = tb.draw_randomness(cfg, rng, 8192)
        pos = positions_plain(keys, seeds.to(device), s, block_bits,
                              None if bseeds is None else bseeds.to(device))
        got = words.clone()
        before = (hashmix.launches, bitset_step.launches)
        dup, ins, new_load = bitset_step(
            cfg, got, keys, rnd, v, seen, i_t, load, seeds=seeds,
            block_seeds=bseeds)
        assert (hashmix.launches, bitset_step.launches) == (before[0],
                                                            before[1] + 1)
        new, dup_p, ins_p, load_p = bitset_step_plain(cfg, words, pos, rnd,
                                                      v, seen, i_t, load)
        torch.cuda.synchronize()
        assert torch.equal(got, new)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        assert torch.equal(new_load, load_p)
        words, load = got, new_load
        position += 8192
        del new, pos


@pytest.mark.gpu
@pytest.mark.parametrize("s", (1 << 30, 715827882, 1365))
@pytest.mark.parametrize("k", (1, 2, 3, 8, 32))
def test_hashed_bitset_step_matches_hashmix_plus_plain_on_card(cuda, k, s):
    hashed_step_case(cuda, k, s, 0)
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("block_bits, s", ((5, 1 << 20), (9, 3_000_000)))
def test_hashed_bitset_step_blocked_layout_on_card(cuda, block_bits, s):
    hashed_step_case(cuda, 3, s, block_bits)


@pytest.mark.gpu
@pytest.mark.parametrize("s", (1 << 30, 715827882, 1365))
@pytest.mark.parametrize("k", (1, 2, 3, 8, 9, 32))
def test_fused_probe_matches_plain_chain_on_card(cuda, k, s):
    fused_probe_case(cuda, k, s)


def fused_probe_case(cuda, k, s):
    """``ops.fused_probe``'s one launch equals the chain of plain versions
    (hashmix, split, bloom_probe, AND) on a half-full filter; it moves
    only its own launch counter."""
    from repro_torch.core import hashing
    from repro_torch.kernels import ops
    from repro_torch.kernels.bloom_probe import (bloom_probe, fused_probe,
                                                 fused_probe_plain)
    from repro_torch.kernels.hashmix import hashmix
    cfg = DedupConfig(variant="rlbsbf", k=k, memory_bits=k * s,
                      packed=True).validate()
    words, _ = random_filter(cfg, cuda, k + 1)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(5, k), "cpu")
    keys = u32.from_numpy_u32(np.random.default_rng(k).integers(
        0, 2 ** 32, 8191, dtype=np.uint64), cuda)
    before = (fused_probe.launches, hashmix.launches, bloom_probe.launches)
    got = ops.fused_probe(keys, words, seeds, s)
    assert (fused_probe.launches, hashmix.launches,
            bloom_probe.launches) == (before[0] + 1, *before[1:])
    want = fused_probe_plain(keys, words, seeds.to(cuda), s)
    torch.cuda.synchronize()
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    del words
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("k", (1, 2, 3, 4, 8, 12))
def test_bloom_probe_kernel_on_views_and_every_k_on_card(cuda, k):
    """bloom_probe at k from 1 to 12, on operands that start at their
    allocation and on views that start one element in, with indices
    outside [0, W) clamped."""
    from repro_torch.kernels.bloom_probe import bloom_probe, bloom_probe_plain
    w, b = 1 << 16, 8191
    r = np.random.default_rng(k)
    words = u32.from_numpy_u32(r.integers(0, 2 ** 32, (k, w),
                                          dtype=np.uint64), cuda)
    idx = torch.from_numpy(r.integers(-5, w + 5, (b + 1) * k)
                           .astype(np.int32)).to(cuda)
    mask = u32.to_i32(1 << torch.from_numpy(r.integers(0, 32, (b + 1) * k))
                      .to(cuda))
    for start in (0, 1):
        i = idx[start:start + b * k].view(b, k)
        m = mask[start:start + b * k].view(b, k)
        assert torch.equal(bloom_probe(words, i, m),
                           bloom_probe_plain(words, i, m))


# ------- the card takes every k, tenant count and plane count (any k past
# the argument block's 32 seeds, bitset fleets past the 65535 a grid axis
# held, counter cells of up to 32 planes) //

@pytest.mark.gpu
@pytest.mark.parametrize("block_bits", (0, 9))
@pytest.mark.parametrize("k", (32, 33, 64))
def test_hashmix_any_k_on_card(cuda, k, block_bits):
    """hashmix at 32 rows (seeds in the argument block) and past them
    (seeds staged on the card), both layouts: one launch, equal to the
    plain positions."""
    from repro_torch.core import hashing
    from repro_torch.kernels.hashmix import hashmix, positions_plain
    s = 3_000_000
    keys = u32.from_numpy_u32(np.random.default_rng(k).integers(
        0, 2 ** 32, 8191, dtype=np.uint64), cuda)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(7, k), "cpu")
    bseeds = (u32.from_numpy_u32(hashing.derive_seeds(7, k, 1), "cpu")
              if block_bits else None)
    before = hashmix.launches
    got = hashmix(keys, seeds, s=s, block_bits=block_bits,
                  block_seeds=bseeds)
    assert hashmix.launches == before + 1
    want = positions_plain(keys, seeds.to(cuda), s, block_bits,
                           None if bseeds is None else bseeds.to(cuda))
    assert torch.equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", BITSET)
@pytest.mark.parametrize("k", (32, 33, 64))
def test_hashed_bitset_step_any_k_on_card(cuda, k, variant):
    """The bitset step at 32 rows and past them (two delete-mask words per
    element), every variant; rsbf's batches cross into phase 3, where the
    rows to delete are the probe's clear rows."""
    s = 1 << 16
    position = 1
    if variant == "rsbf":
        position = int(np.ceil(s / 0.03)) - 4000
    hashed_step_case(cuda, k, s, 0, variant, position)


@pytest.mark.gpu
def test_hashed_bitset_step_blocked_past_32_rows_on_card(cuda):
    hashed_step_case(cuda, 33, 1 << 20, 5)


@pytest.mark.gpu
@pytest.mark.parametrize("k", (32, 33, 64))
def test_fused_probe_any_k_on_card(cuda, k):
    fused_probe_case(cuda, k, 1 << 20)
    fused_probe_case(cuda, k, 1365)


@pytest.mark.gpu
@pytest.mark.parametrize("t", (65536, 131072))
@pytest.mark.parametrize("variant", ("rsbf", "rlbsbf"))
def test_bitset_fleet_past_65535_tenants_on_card(cuda, variant, t):
    """A bitset fleet of 2^16 and 2^17 tenants at a tiny s (one launch of
    the folded grid) equals the plain step over all tenants at once."""
    from repro_torch.core import hashing, prng
    from repro_torch.kernels.hashmix import positions_plain
    cfg = fleet_cfg(variant, t, memory_bits=1 << 9)
    k, w, s, c = cfg.k, cfg.s_words, cfg.s, 8
    gen = torch.Generator(device=cuda).manual_seed(t)
    words = torch.randint(-2 ** 31, 2 ** 31, (t, k, w), dtype=torch.int32,
                          device=cuda, generator=gen)
    tail = s - 32 * (w - 1)
    if tail < 32:
        words[..., -1] &= (1 << tail) - 1
    load = packed.popcount(words)
    rng = prng.fold_in(prng.PRNGKey(3, cuda), torch.arange(t, device=cuda))
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, k), "cpu")
    r = np.random.default_rng(t)
    position = torch.full((t,), s - 4, dtype=torch.int32, device=cuda)
    for hi in (50, 2 ** 32):
        keys, v = fleet_lanes(cfg, t, c, r, cuda, hi)
        seen = tb.intra_batch_seen(keys, v)
        i_t = position[:, None] + torch.arange(c, dtype=torch.int32,
                                               device=cuda)
        rng, rnd = tb.draw_randomness(cfg, rng, c)
        pos = positions_plain(keys.reshape(-1), seeds.to(cuda),
                              s).view(t, c, k)
        got = words.clone()
        before = bitset_step.launches
        dup, ins, new_load = bitset_step(cfg, got, keys, rnd, v, seen, i_t,
                                         load, seeds=seeds)
        new, dup_p, ins_p, load_p = bitset_step_plain(cfg, words, pos, rnd,
                                                      v, seen, i_t, load)
        torch.cuda.synchronize()
        assert bitset_step.launches == before + 1
        assert torch.equal(got, new) and torch.equal(new_load, load_p)
        assert torch.equal(dup, dup_p) and torch.equal(ins, ins_p)
        assert torch.equal(new_load, packed.popcount(got))
        words, load = got, new_load
        position = position + v.sum(dim=1, dtype=torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("sbf_max", ((1 << 16) - 1, 1 << 16, (1 << 32) - 1))
def test_counter_step_past_16_planes_on_card(cuda, sbf_max):
    """sbf at d = 16, 17 and 32 planes (Max up to 2^32 - 1, the widest
    the reference's planes hold): the counter step equals its plain
    version over three batches."""
    from repro_torch.core import hashing
    from repro_torch.core.sketch import get_spec
    cfg = DedupConfig.for_variant("sbf", layout="planes", sbf_max=sbf_max,
                                  memory_bits=1 << 20)
    assert cfg.n_planes == sbf_max.bit_length()
    spec = get_spec("sbf")
    events = spec.make_events(cfg)
    r = np.random.default_rng(sbf_max % 1000)
    st = random_counter_state(cfg, cuda, r)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(cfg.seed, cfg.k), "cpu")
    for n_valid, hi in ((8192, 200), (5000, 2 ** 32), (8192, 2 ** 32)):
        keys = u32.from_numpy_u32(r.integers(0, hi, 8192, dtype=np.uint64),
                                  cuda)
        v = torch.arange(8192, device=cuda) < n_valid
        pos = hashing.hash_positions(keys, seeds, cfg.s)
        rng, rnd = spec.draw(cfg, st.rng, 8192)
        ev = events(st, pos, v, rnd)
        planes = tb.sbf_planes_3d(st.bits)[:, 0, :]
        got = planes.clone()
        dup, load = counter_step(cfg, spec, got, pos, v, None, st.load, ev)
        new, dup_p, load_p = counter_step_plain(cfg, spec, planes, pos, v,
                                                None, st.load, ev)
        torch.cuda.synchronize()
        assert torch.equal(got, new) and torch.equal(dup, dup_p)
        assert torch.equal(load, load_p)
        st = st._replace(bits=got[:, None, :], load=load, rng=rng)


# ------------------------------------ the dense8 layout on the card //

@pytest.mark.gpu
@pytest.mark.parametrize("variant", ("sbf", "rsbf", "bsbf", "bsbfsd",
                                     "rlbsbf"))
def test_dense8_engine_on_card_matches_engine_on_cpu(cuda, variant):
    """The dense8 engine (the reference's default layout) on the card
    equals it on the CPU, reports and every leaf, with one hashmix launch
    per step and no step kernel; the oracle too, one hashmix launch per
    element."""
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    from repro_torch.kernels.hashmix import hashmix
    kw = dict(memory_bits=1 << 16, batch_size=1024)
    if variant == "rsbf":
        kw["p_star"] = 0.5
    cfg = DedupConfig.for_variant(variant, **kw)
    assert cfg.effective_layout == "dense8"
    keys = np.random.default_rng(4).integers(0, 5000, 10_000) \
        .astype(np.uint32)
    on_card, on_cpu = Dedup(cfg, cuda), Dedup(cfg, "cpu")
    before = (hashmix.launches, bitset_step.launches, counter_step.launches)
    sg, dg = on_card.run_stream(on_card.init(), keys)
    assert (hashmix.launches, bitset_step.launches,
            counter_step.launches) == (before[0] + 10, *before[1:])
    sc, dc = on_cpu.run_stream(on_cpu.init(), keys)
    assert torch.equal(dg.cpu(), dc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    before = hashmix.launches
    og, odg = on_card.run_stream_oracle(on_card.init(), keys[:300])
    assert hashmix.launches == before + 300
    oc, odc = on_cpu.run_stream_oracle(on_cpu.init(), keys[:300])
    assert torch.equal(odg.cpu(), odc)
    a, b = state_to_numpy(og), state_to_numpy(oc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key


@pytest.mark.gpu
def test_dense8_fleet_and_pipeline_on_card(cuda):
    """A bitset dense8 fleet and ``DedupPipeline`` on the card equal the
    same on the CPU."""
    from repro_torch.configs import scaled_config
    from repro_torch.convert import state_to_numpy
    from repro_torch.core.fleet import FleetDedup
    from repro_torch.data.streams import clickstream
    from repro_torch.dedup import DedupPipeline
    cfg = dataclasses.replace(DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 16, batch_size=1024), n_tenants=8)
    r = np.random.default_rng(5)
    keys = r.integers(0, 3000, 10_000).astype(np.uint32)
    tens = r.integers(0, 8, 10_000).astype(np.int32)
    out = [FleetDedup(cfg, capacity=256, device=d) for d in (cuda, "cpu")]
    (sg, dg, og), (sc, dc, oc) = (f.run_stream(f.init(), keys, tens)
                                  for f in out)
    assert torch.equal(dg.cpu(), dc) and torch.equal(og.cpu(), oc)
    a, b = state_to_numpy(sg), state_to_numpy(sc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    recs, truth, _ = clickstream(8 * 1024, seed=1)
    pipes = [DedupPipeline(scaled_config("sbf", 8, batch_size=1024),
                           device=d) for d in (cuda, "cpu")]
    for i in range(0, 8 * 1024, 1024):
        batch = {n: col[i:i + 1024] for n, col in recs.items()}
        got, want = (p.process(batch, truth[i:i + 1024]) for p in pipes)
        assert torch.equal(got.dup.cpu(), want.dup)
        assert torch.equal(got.weights.cpu(), want.weights)
    sg, sc = (p.metrics.summary() for p in pipes)
    sg.pop("throughput_eps"), sc.pop("throughput_eps")
    assert sg == sc


@pytest.mark.gpu
def test_ops_take_seeds_on_the_card(cuda):
    """``ops.hash_positions`` and ``ops.fused_probe`` take seeds on the
    card, as the reference's ops do (copied to the host per call), and
    give what they give with host seeds; the kernel wrappers below them
    keep refusing card seeds."""
    from repro_torch.core import hashing
    from repro_torch.kernels import ops
    from repro_torch.kernels.hashmix import hashmix
    s = 1 << 20
    cfg = DedupConfig(variant="rlbsbf", k=3, memory_bits=3 * s,
                      packed=True).validate()
    words, _ = random_filter(cfg, cuda, 9)
    seeds = u32.from_numpy_u32(hashing.derive_seeds(5, 3), "cpu")
    keys = u32.from_numpy_u32(np.random.default_rng(9).integers(
        0, 2 ** 32, 4096, dtype=np.uint64), cuda)
    assert torch.equal(ops.hash_positions(keys, seeds.to(cuda), s),
                       ops.hash_positions(keys, seeds, s))
    for x, y in zip(ops.fused_probe(keys, words, seeds.to(cuda), s),
                    ops.fused_probe(keys, words, seeds, s)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="CPU tensor"):
        hashmix(keys, seeds.to(cuda), s=s)


# ------------------------------------- serving and checkpoints on the card //

@pytest.mark.gpu
@pytest.mark.parametrize("fleet", (False, True), ids=("dense8", "fleet4"))
def test_serve_frontend_replay_parity_on_card(cuda, fleet):
    """A small front end on the card: exact answers, its live digest equal
    to ``replay_schedule`` on the card and on the CPU; a dense8 executor
    launches one hashmix per micro-batch, a plane fleet one bitset step."""
    import asyncio
    from repro_torch.serve import ServeFrontend, replay_schedule
    from repro_torch.kernels.hashmix import hashmix
    kw = dict(memory_bits=1 << 16, batch_size=64)
    if fleet:
        kw.update(packed=True, n_tenants=4)
    cfg = DedupConfig.for_variant("rlbsbf", **kw)
    r = np.random.default_rng(2)
    keys = r.integers(0, 200, 600)
    tens = r.integers(0, 4, 600) if fleet else np.zeros(600, np.int64)
    counter = bitset_step if fleet else hashmix

    def double(b):
        return np.asarray(b["key"], np.float64) * 2.0

    async def go():
        fe = ServeFrontend(cfg, double, buckets=(64, 256),
                           record_schedule=True, device=cuda)
        async with fe:
            res = await asyncio.gather(*(fe.submit(int(k), tenant=int(t))
                                         for k, t in zip(keys, tens)))
        return res, fe

    before = counter.launches
    res, fe = asyncio.run(go())
    assert counter.launches - before == fe.executor.n_batches
    assert [float(x.value) for x in res] == [2.0 * k for k in keys]
    sched = fe.executor.schedule
    live = fe.executor.digest()
    assert live == replay_schedule(cfg, sched, device=cuda)
    assert live == replay_schedule(cfg, sched, device="cpu")
    assert fe.executor.process_cache_size() <= 2


@pytest.mark.gpu
def test_checkpoint_restores_onto_template_device(cuda, tmp_path):
    """A card state saved and restored into a card template lands on the
    card, equal leaf for leaf; restored into a CPU template it lands on
    the CPU; a dense8 -> planes migration on the card equals it on the
    CPU and resumes as the plane engine does."""
    from repro_torch.checkpoint import (CheckpointManager, layout_meta,
                                        migrate_filter_state)
    from repro_torch.convert import state_to_numpy
    from repro_torch.core import Dedup
    kw = dict(memory_bits=1 << 16, batch_size=1024)
    c8 = DedupConfig.for_variant("sbf", **kw)
    cp = DedupConfig.for_variant("sbf", layout="planes", **kw)
    keys = np.random.default_rng(6).integers(0, 9000, 8192).astype(np.uint32)
    eng = Dedup(c8, cuda)
    st, _ = eng.run_stream(eng.init(), keys[:4096])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"filter": st}, extra_meta=layout_meta(c8))
    on_card = mgr.restore(1, {"filter": eng.init()})["filter"]
    on_cpu = mgr.restore(1, {"filter": Dedup(c8, "cpu").init()})["filter"]
    assert all(x.device.type == "cuda" for x in on_card)
    assert all(x.device.type == "cpu" for x in on_cpu)
    a, b, c = (state_to_numpy(x) for x in (st, on_card, on_cpu))
    for key in a:
        assert np.array_equal(a[key], b[key]) and np.array_equal(
            a[key], c[key]), key
    mg, mc = (migrate_filter_state(x, c8, cp) for x in (on_card, on_cpu))
    assert mg.bits.device.type == "cuda"
    a, b = state_to_numpy(mg), state_to_numpy(mc)
    for key in a:
        assert np.array_equal(a[key], b[key]), key
    _, d8 = eng.run_stream(on_card, keys[4096:])
    _, dp = Dedup(cp, cuda).run_stream(mg, keys[4096:])
    assert torch.equal(d8, dp)
