"""The kernel package's other names against the reference's
(``repro/kernels/common.py``, ``fused_step.py``, ``fused_counter_step.py``,
``ref.py``, ``fused_template.make_fused_step``, ``__init__``):

* the VMEM budget model, ported as it is, equals the reference's over a
  sweep of configs (variants, planes d, accumulate mode, batch, fleets);
* the Hopper model's device bytes equal what the step's kernel wrappers
  are handed and return on the CPU, and the state the engine allocates;
* the deprecated factories warn and refuse as the reference's do, and
  step bit for bit as the reference's do on seeded inputs;
* ``ref_*`` equal the reference's ``ref_*``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.core.state import init_state as jinit_state
from repro.kernels import common as jcommon
from repro.kernels import ref as jref
from repro_torch.convert import state_to_numpy
from repro_torch.core import DedupConfig, u32
from repro_torch.core.engine import Dedup
from repro_torch.core.fleet import FleetDedup
from repro_torch.core.state import init_state, state_memory_bytes
from repro_torch.kernels import common, ref

SEED = 19


# ------------------------------------------------ the reference's VMEM model

VMEM_CASES = [
    ("rsbf", {}), ("bsbf", {}), ("bsbfsd", {}), ("rlbsbf", {}),
    ("rlbsbf", {"k": 5}),
    ("sbf", {"sbf_max": 1}), ("sbf", {"sbf_max": 3}), ("sbf", {"sbf_max": 7}),
    ("sbf", {"sbf_max": 255, "sbf_p": 4}),
    ("swbf", {"window": 4}), ("swbf", {"window": 3, "cbf_bits": 2}),
    ("cms", {}), ("cms", {"count_bits": 4}), ("hh", {}),
]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("batch", [64, 1000])
@pytest.mark.parametrize("variant,kw", VMEM_CASES,
                         ids=[f"{v}-{'-'.join(map(str, kw.values()))}"
                              for v, kw in VMEM_CASES])
def test_vmem_model_equals_reference(variant, kw, batch, accumulate):
    args = dict(memory_bits=3 * 5120 if batch == 1000 else 1 << 16,
                batch_size=batch, packed=True, kernel_accumulate=accumulate,
                **kw)
    jc = JConfig.for_variant(variant, **args)
    tc = DedupConfig.for_variant(variant, **args)
    assert (common.fused_resident_bytes(tc)
            == jcommon.fused_resident_bytes(jc))
    for b, cap in ((32, None), (batch, 3 * batch)):
        assert (common.fused_resident_bytes(tc, b, cap)
                == jcommon.fused_resident_bytes(jc, b, cap))
    import dataclasses
    jf = dataclasses.replace(jc, n_tenants=4)
    tf = dataclasses.replace(tc, n_tenants=4)
    assert (common.fleet_resident_bytes(tf, 32)
            == jcommon.fleet_resident_bytes(jf, 32))


def test_vmem_helpers_equal_reference():
    assert (common.DEFAULT_TILE_W, common.DEFAULT_CHUNK_B,
            common.VMEM_FILTER_BYTES_LIMIT) == (
        jcommon.DEFAULT_TILE_W, jcommon.DEFAULT_CHUNK_B,
        jcommon.VMEM_FILTER_BYTES_LIMIT)
    for d in range(1, 9):
        for has_sub in (False, True):
            for set_mode in (False, True):
                for acc in (False, True):
                    kw = dict(has_sub=has_sub, set_mode=set_mode,
                              accumulate=acc)
                    assert (common.counter_vmem_words(d, **kw)
                            == jcommon.counter_vmem_words(d, **kw))
    for w in (1, 7, 160, 512, 1000, 4096, 5120, 65537):
        for limit in (1, 8, 100, 512):
            assert (common.largest_tile(w, limit)
                    == jcommon.largest_tile(w, limit))
    common.check_vmem_budget(common.VMEM_FILTER_BYTES_LIMIT, "x")
    with pytest.raises(ValueError) as mine:
        common.check_vmem_budget(common.VMEM_FILTER_BYTES_LIMIT + 1, "w")
    with pytest.raises(ValueError) as theirs:
        jcommon.check_vmem_budget(jcommon.VMEM_FILTER_BYTES_LIMIT + 1, "w")
    assert str(mine.value) == str(theirs.value)


# ------------------------------------------------------- the Hopper model


def _capture(monkeypatch):
    """Record the tensors the step's kernel wrappers are handed and return
    — besides the state and the host seeds — as {(address, bytes)}: what a
    launch on the card reads and writes. The counter step's run heads and
    delta planes are the plain version's alone (the card builds none)."""
    import repro_torch.core.hashing as hashing
    import repro_torch.kernels.fused_template as ft
    seen = set()

    def note(*xs):
        for x in xs:
            if isinstance(x, torch.Tensor):
                seen.add((x.data_ptr(), x.numel() * x.element_size()))

    orig_b, orig_c, orig_h = ft.bitset_step, ft.counter_step, \
        hashing._hashmix_kernel

    def bitset(cfg, words, keys, rnd, valid, seen_, i_t, load, **kw):
        note(keys, *rnd, valid, seen_, i_t)
        out = orig_b(cfg, words, keys, rnd, valid, seen_, i_t, load, **kw)
        note(*out)
        return out

    def counter(cfg, spec, planes, pos, valid, seen_, load, ev, **kw):
        note(pos, valid, seen_, ev.ins_events, ev.sub_events,
             kw["threshold"], kw["max_value"])
        out = orig_c(cfg, spec, planes, pos, valid, seen_, load, ev, **kw)
        note(*out)
        return out

    def hashmix(keys, seeds, **kw):
        out = orig_h(keys, seeds, **kw)
        note(keys, out)
        return out

    monkeypatch.setattr(ft, "bitset_step", bitset)
    monkeypatch.setattr(ft, "counter_step", counter)
    monkeypatch.setattr(hashing, "_hashmix_kernel", hashmix)
    return seen


DEVICE_CASES = {
    "rlbsbf": ("rlbsbf", {"packed": True}, 0),
    "rsbf": ("rsbf", {"packed": True}, 0),
    "bsbfsd-k40": ("bsbfsd", {"packed": True, "k": 40}, 0),
    "sbf": ("sbf", {"layout": "planes"}, 0),
    "swbf": ("swbf", {"window": 3}, 0),
    "cms": ("cms", {}, 0),
    "hh": ("hh", {}, 0),
    "rlbsbf-dense8": ("rlbsbf", {}, 0),
    "sbf-dense8": ("sbf", {}, 0),
    "fleet-rlbsbf": ("rlbsbf", {"packed": True}, 4),
    "fleet-sbf": ("sbf", {"layout": "planes"}, 4),
    "fleet-swbf": ("swbf", {"window": 2}, 4),
}


@pytest.mark.parametrize("case", list(DEVICE_CASES))
def test_step_device_bytes_equal_what_the_wrappers_take(case, monkeypatch):
    variant, kw, tenants = DEVICE_CASES[case]
    cfg = DedupConfig.for_variant(variant, memory_bits=1 << 15,
                                  batch_size=96, **kw)
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 500, cfg.batch_size).astype(np.uint32)
    seen = _capture(monkeypatch)
    if tenants:
        import dataclasses
        cfg = dataclasses.replace(cfg, n_tenants=tenants)
        fleet = FleetDedup(cfg, capacity=40, device="cpu")
        state = fleet.init()
        fleet.process(state, keys, rng.integers(0, tenants, keys.shape[0]))
        b = fleet.capacity
    else:
        eng = Dedup(cfg, "cpu")
        state = eng.init()
        eng.process(state, keys)
        b = cfg.batch_size
    got = common.step_device_breakdown(cfg, b)
    assert got["operands"] == sum(n for _, n in seen), case
    assert got["state"] == state_memory_bytes(state) \
        == common.state_bytes(cfg, b)
    assert common.step_device_bytes(cfg, b) == sum(got.values())
    assert got["scratch"] >= 0


def test_hopper_limits_and_l2():
    assert common.SHARED_BYTES_PER_BLOCK_LIMIT == 227 * 1024
    small = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20,
                                    packed=True)
    paper = DedupConfig.for_variant("rlbsbf", memory_bits=256 << 23,
                                    packed=True)
    assert common.fits_l2(small) and not common.fits_l2(paper)
    import dataclasses
    fleet = dataclasses.replace(
        DedupConfig.for_variant("rlbsbf", memory_bits=8 << 23, packed=True),
        n_tenants=32)
    assert common.fits_l2(dataclasses.replace(fleet, n_tenants=1))
    assert not common.fits_l2(fleet)
    assert common.block_shared_bytes("counter_merge_apply<4>") == 528
    assert common.block_shared_bytes("probe_decide<true, false>") == 0
    with pytest.raises(KeyError):
        common.block_shared_bytes("no_such_kernel")


# ------------------------------------------------------- the other names


def test_package_exports_what_the_reference_does():
    import repro.kernels as jk
    import repro_torch.kernels as tk
    from repro_torch.kernels import build
    assert tk.__all__ == jk.__all__
    for name in tk.__all__:
        assert callable(getattr(tk, name)) or name in ("ops", "ref")
    assert tk.hashmix.__name__ == "hashmix"
    assert build._libs == {}               # importing built nothing


ALIAS_CASES = {
    "make_fused_batched_step": ("fused_step", "make_fused_batched_step",
                                "rlbsbf", {}),
    "make_fused_counter_step": ("fused_counter_step",
                                "make_fused_counter_step", "sbf", {}),
    "make_fused_swbf_step": ("fused_counter_step", "make_fused_swbf_step",
                             "swbf", {"window": 4}),
}


def _jleaves(st):
    out = {"bits": np.asarray(st.bits), "position": np.asarray(st.position),
           "load": np.asarray(st.load),
           "rng": np.asarray(jax.random.key_data(st.rng))}
    if st.ring is not None:
        out["ring_events"] = np.asarray(st.ring.events)
        out["ring_slot"] = np.asarray(st.ring.slot)
    return out


@pytest.mark.parametrize("case", list(ALIAS_CASES))
def test_aliases_warn_and_step_as_the_reference(case):
    """Each deprecated factory warns as the reference's (the package name
    changed) and its step reproduces the reference's — the Pallas kernel in
    interpret mode — bit for bit over three seeded batches, the last
    ragged."""
    import importlib
    mod, fn, variant, kw = ALIAS_CASES[case]
    tfac = getattr(importlib.import_module(f"repro_torch.kernels.{mod}"), fn)
    jfac = getattr(importlib.import_module(f"repro.kernels.{mod}"), fn)
    args = dict(memory_bits=1 << 13, batch_size=64, packed=True,
                backend="pallas", **kw)
    jc, tc = JConfig.for_variant(variant, **args), \
        DedupConfig.for_variant(variant, **args)
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        with pytest.warns(DeprecationWarning, match="fused_template"):
            jstep = jax.jit(jfac(jc))
        with pytest.warns(DeprecationWarning,
                          match="repro_torch.kernels.fused_template"):
            tstep = tfac(tc, device="cpu")
        js, ts = jinit_state(jc), init_state(tc, device="cpu")
        rng = np.random.default_rng(SEED)
        for i in range(3):
            keys = rng.integers(0, 300, 64).astype(np.uint32)
            valid = np.arange(64) < (64 if i < 2 else 37)
            js, jres = jstep(js, jnp.asarray(keys), jnp.asarray(valid))
            ts, tres = tstep(ts, u32.from_numpy_u32(keys, "cpu"),
                             torch.from_numpy(valid))
            assert np.array_equal(np.asarray(jres.dup), tres.dup.numpy())
            assert np.array_equal(np.asarray(jres.inserted),
                                  tres.inserted.numpy())
        want, got = _jleaves(js), state_to_numpy(ts)
        for leaf in want:
            assert np.array_equal(want[leaf], got[leaf]), leaf
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def test_aliases_refuse_as_the_reference():
    from repro.kernels import fused_counter_step as jfc
    from repro.kernels import fused_step as jfs
    from repro.kernels.fused_template import make_fused_step as jmake
    from repro_torch.kernels import fused_counter_step as tfc
    from repro_torch.kernels import fused_step as tfs
    from repro_torch.kernels.fused_template import make_fused_step
    kw = dict(memory_bits=1 << 13, batch_size=64, packed=True)

    def both(variant, **extra):
        return (JConfig.for_variant(variant, **kw, **extra),
                DedupConfig.for_variant(variant, **kw, **extra))

    sbf = both("sbf")
    with pytest.warns(DeprecationWarning):
        with pytest.raises(ValueError) as theirs:
            jfs.make_fused_batched_step(sbf[0])
        with pytest.raises(ValueError) as mine:
            tfs.make_fused_batched_step(sbf[1], device="cpu")
    assert str(mine.value) == str(theirs.value)
    for fac, variant in (("make_fused_counter_step", "rlbsbf"),
                         ("make_fused_swbf_step", "sbf")):
        j, t = both(variant)
        with pytest.warns(DeprecationWarning):
            with pytest.raises(AssertionError):
                getattr(jfc, fac)(j)
            with pytest.raises(AssertionError):
                getattr(tfc, fac)(t, device="cpu")
    d8 = (JConfig.for_variant("sbf", memory_bits=1 << 13),
          DedupConfig.for_variant("sbf", memory_bits=1 << 13))
    with pytest.raises(ValueError) as theirs:
        jmake(d8[0])
    with pytest.raises(ValueError) as mine:
        make_fused_step(d8[1], device="cpu")
    assert str(mine.value) == str(theirs.value)


def test_make_fused_step_is_the_templated_step():
    """make_fused_step ignores its TPU knobs: any tile or chunk gives the
    engine's step, and the params-aware form is the fleet step."""
    from repro_torch.core.batched import TenantStepParams
    from repro_torch.core.fleet import init_fleet_state
    from repro_torch.kernels.fused_template import (int32_rows,
                                                    make_fused_step)
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 13,
                                  batch_size=64, packed=True)
    keys = u32.from_numpy_u32(np.random.default_rng(SEED)
                              .integers(0, 200, 64).astype(np.uint32), "cpu")
    valid = torch.ones(64, dtype=torch.bool)
    a = make_fused_step(cfg, tile_w=16, chunk_b=8, interpret=True,
                        device="cpu")
    sa, ra = a(init_state(cfg, device="cpu"), keys, valid)
    sb, rb = Dedup(cfg, "cpu").process(init_state(cfg, device="cpu"), keys)
    assert torch.equal(ra.dup, rb.dup) and torch.equal(sa.bits, sb.bits)
    import dataclasses
    fc = dataclasses.replace(cfg, n_tenants=2)
    fleet_step = make_fused_step(fc, params_aware=True, device="cpu")
    st = init_fleet_state(fc, device="cpu")
    tp = TenantStepParams(*(int32_rows(v, 2, "cpu") for v in (3, 1, 1)))
    new, res = fleet_step(st, keys.view(2, 32), valid.view(2, 32), tp)
    assert res.dup.shape == (2, 32) and new.bits.shape == (2, 2, 128)


# ------------------------------------------------------------------ ref_*


@pytest.mark.parametrize("s", [1 << 12, 3000, (1 << 31) - 1])
def test_ref_hashmix_equals_reference(s):
    rng = np.random.default_rng(SEED)
    keys = rng.integers(0, 1 << 32, 257, dtype=np.uint64).astype(np.uint32)
    seeds = rng.integers(0, 1 << 32, 5, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jref.ref_hashmix(jnp.asarray(keys), jnp.asarray(seeds),
                                       s=s))
    got = ref.ref_hashmix(u32.from_numpy_u32(keys, "cpu"),
                          u32.from_numpy_u32(seeds, "cpu"), s=s)
    assert got.dtype == torch.int32
    assert np.array_equal(want, got.numpy())


def test_ref_bloom_probe_and_scatter_delta_equal_reference():
    rng = np.random.default_rng(SEED)
    k, w, b = 3, 40, 200
    words = rng.integers(0, 1 << 32, (k, w), dtype=np.uint64).astype(
        np.uint32)
    idx = rng.integers(0, w + 6, (b, k)).astype(np.int32)  # some past W
    mask = (np.uint32(1) << rng.integers(0, 32, (b, k)).astype(np.uint32)
            ).astype(np.uint32)
    want = np.asarray(jref.ref_bloom_probe(jnp.asarray(words),
                                           jnp.asarray(idx),
                                           jnp.asarray(mask)))
    got = ref.ref_bloom_probe(u32.from_numpy_u32(words, "cpu"),
                              torch.from_numpy(idx),
                              u32.from_numpy_u32(mask, "cpu"))
    assert np.array_equal(want, got.numpy())
    want = np.asarray(jref.ref_scatter_delta(jnp.asarray(idx),
                                             jnp.asarray(mask), w=w))
    got = ref.ref_scatter_delta(torch.from_numpy(idx),
                                u32.from_numpy_u32(mask, "cpu"), w=w)
    assert np.array_equal(want, u32.to_numpy_u32(got))
