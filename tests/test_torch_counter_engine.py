"""The port's counter-family engine end to end on the CPU: the reference's
sbf, sbf_d1 and swbf pinned digests, ``run_stream`` parity with
``repro.Dedup``, the ``estimate`` and ``top_cells`` read-outs (ties
included), state hand-over in both directions mid-stream with swbf's ring,
the ring-capacity refusals, and the windowed ground truth."""

import dataclasses
import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import get_engine as jax_engine
from repro.core import DedupConfig as JConfig
from repro.core.state import FilterState as JState, WindowRing as JRing
from repro.dedup.metrics import windowed_truth_from_stream as jwindowed
from repro_torch.convert import (config_from_dict, state_from_numpy,
                                 state_to_numpy)
from repro_torch.core import Dedup, DedupConfig, init_ring, state_memory_bytes
from repro_torch.dedup.metrics import windowed_truth_from_stream

COUNTER = ("sbf", "sbf_d1", "swbf", "cms", "hh")
SMALL = dict(memory_bits=1 << 12, batch_size=256)

# tests/test_sketch_template.py: sha256 over per-batch dup + inserted and
# the final bits/load/position/rng key data/ring at memory_bits=1<<14,
# batch=256, 1024 mixed keys with a ragged final batch — captured under
# JAX's original threefry counter layout
PINNED_DIGESTS = {
    "sbf": "be5220c6e677d339",
    "sbf_d1": "b5702a4fbe9dc5c0",
    "swbf": "4580749bdb028080",
}


def _installed_layout():
    return bool(jax.config.jax_threefry_partitionable)


def _kw(name):
    return {"sbf": ("sbf", dict(layout="planes")),
            "sbf_d1": ("sbf", dict(layout="planes", sbf_max=1)),
            "swbf": ("swbf", dict(window=4)),
            "cms": ("cms", {}), "hh": ("hh", {})}[name]


def configs(name, **over):
    variant, kw = _kw(name)
    kw = dict(SMALL, **kw, **over)
    return (JConfig.for_variant(variant, **kw),
            DedupConfig.for_variant(variant, **kw))


def jax_leaves(state):
    out = {"bits": np.asarray(state.bits),
           "position": np.asarray(state.position),
           "load": np.asarray(state.load),
           "rng": np.asarray(jax.random.key_data(state.rng))}
    if state.ring is not None:
        out["ring_events"] = np.asarray(state.ring.events)
        out["ring_slot"] = np.asarray(state.ring.slot)
    return out


def jax_state(leaves):
    ring = None
    if "ring_events" in leaves:
        ring = JRing(jnp.asarray(leaves["ring_events"]),
                     jnp.asarray(leaves["ring_slot"]))
    return JState(bits=jnp.asarray(leaves["bits"]),
                  position=jnp.asarray(leaves["position"]),
                  load=jnp.asarray(leaves["load"]),
                  rng=jnp.asarray(leaves["rng"]), ring=ring)


def assert_same_state(js, ts, ctx=""):
    a, b = jax_leaves(js), state_to_numpy(ts)
    assert a.keys() == b.keys(), ctx
    for key in a:
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


def _streams():
    r = np.random.default_rng(23)
    return {
        "dup_heavy": r.integers(0, 60, 2000).astype(np.uint32),
        "unique_heavy": r.integers(0, 1 << 30, 2000).astype(np.uint32),
        "ragged": r.integers(0, 300, 2000 - 97).astype(np.uint32),
    }


@pytest.mark.parametrize("name", sorted(PINNED_DIGESTS))
def test_pinned_digests_reproduced(name):
    _, cfg = configs(name, memory_bits=1 << 14)
    eng = Dedup(cfg, "cpu", partitionable=False)
    state = eng.init()
    keys = np.random.RandomState(7).randint(0, 400, size=1024) \
        .astype(np.uint32)
    b = cfg.batch_size
    h = hashlib.sha256()
    for i in range(0, len(keys), b):
        valid = np.ones((b,), bool)
        if i + b >= len(keys):
            valid[b // 2:] = False
        state, res = eng.process(state, keys[i:i + b], valid)
        h.update(res.dup.numpy().tobytes())
        h.update(res.inserted.numpy().tobytes())
    leaves = state_to_numpy(state)
    for key in ("bits", "load", "position", "rng", "ring_events",
                "ring_slot"):
        if key in leaves:
            h.update(leaves[key].tobytes())
    assert h.hexdigest()[:16] == PINNED_DIGESTS[name]


@pytest.mark.parametrize("name", COUNTER)
def test_stream_parity_with_reference(name):
    """run_stream over the three stream shapes: the port's reports and
    final state (ring included) equal the JAX engine's."""
    jc, tc = configs(name)
    jd = jax_engine(jc)
    td = Dedup(tc, "cpu", partitionable=_installed_layout())
    for sname, keys in _streams().items():
        st, dup = td.run_stream(td.init(), keys)
        sj, dj = jd.run_stream(jd.init(), jnp.asarray(keys))
        assert dup.dtype == torch.bool and dup.shape == keys.shape
        assert np.array_equal(dup.numpy(), np.asarray(dj)), (name, sname)
        assert_same_state(sj, st, (name, sname))


@pytest.mark.parametrize("name", COUNTER)
def test_estimate_matches_reference(name):
    jc, tc = configs(name, memory_bits=1 << 14)
    jd, td = jax_engine(jc), Dedup(tc, "cpu",
                                   partitionable=_installed_layout())
    keys = np.random.default_rng(5).integers(0, 80, 2048).astype(np.uint32)
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, _ = td.run_stream(td.init(), keys)
    probe = np.arange(120, dtype=np.uint32)
    got = td.estimate(st, probe)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          np.asarray(jd.estimate(sj, jnp.asarray(probe))))


def test_top_cells_matches_reference_with_ties():
    """A cms state with many equal counts: the port lists the same cells
    in the same order as ``jax.lax.top_k`` (the lower cell first among
    equal counts), also across its chunks."""
    jc, tc = configs("cms", memory_bits=1 << 14)
    jd, td = jax_engine(jc), Dedup(tc, "cpu")
    keys = np.repeat(np.arange(60, dtype=np.uint32), 3)
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(keys))
    st, _ = td.run_stream(td.init(), keys)
    for m in (1, 16, 200):
        wc, wn = jd.top_cells(sj, m)
        gc, gn = td.top_cells(st, m)
        assert len(set(np.asarray(wn).tolist())) < m or m == 1
        assert gc.dtype == torch.int32 and gn.dtype == torch.int32
        assert np.array_equal(gn.numpy(), np.asarray(wn)), m
        assert np.array_equal(gc.numpy(), np.asarray(wc)), m
    import repro_torch.core.engine as te
    chunk = te.TOP_CELLS_CHUNK_WORDS
    try:
        te.TOP_CELLS_CHUNK_WORDS = 3              # many chunks of 3 words
        gc, gn = td.top_cells(st, 200)
    finally:
        te.TOP_CELLS_CHUNK_WORDS = chunk
    wc, wn = jd.top_cells(sj, 200)
    assert np.array_equal(gc.numpy(), np.asarray(wc))
    assert np.array_equal(gn.numpy(), np.asarray(wn))


def test_readouts_refuse_bitset_engines():
    eng = Dedup(DedupConfig.for_variant("rlbsbf", packed=True, **SMALL),
                "cpu")
    with pytest.raises(ValueError, match="counter-family"):
        eng.estimate(eng.init(), np.zeros(4, np.uint32))
    with pytest.raises(ValueError, match="counter-family"):
        eng.top_cells(eng.init())
    _, tc = configs("cms")
    with pytest.raises(ValueError, match="1 <= m"):
        Dedup(tc, "cpu").top_cells(Dedup(tc, "cpu").init(), 0)


@pytest.mark.parametrize("name", ("sbf", "swbf"))
def test_state_carried_across_mid_stream(name):
    """JAX runs three batches, the port takes its state (swbf: with the
    ring) over and both continue: equal. Then the reverse hand-over."""
    jc, _ = configs(name)
    tc = config_from_dict(dataclasses.asdict(jc))
    jd = jax_engine(jc)
    td = Dedup(tc, "cpu", partitionable=_installed_layout())
    keys = _streams()["ragged"]
    head, tail = keys[:768], keys[768:1536]
    sj, _ = jd.run_stream(jd.init(), jnp.asarray(head))
    st = state_from_numpy(jax_leaves(sj), tc, "cpu")
    sj, dj = jd.run_stream(sj, jnp.asarray(tail))
    st, dt = td.run_stream(st, tail)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st, name)
    st, _ = td.run_stream(td.init(), head)
    sj = jax_state(state_to_numpy(st))
    sj, dj = jd.run_stream(sj, jnp.asarray(tail))
    st, dt = td.run_stream(st, tail)
    assert np.array_equal(dt.numpy(), np.asarray(dj))
    assert_same_state(sj, st, (name, "reverse"))


def test_counter_state_shapes_and_checks():
    for name, shape in (("sbf", (2, 1, 64)), ("sbf_d1", (1, 128)),
                        ("cms", (8, 1, 16))):
        _, tc = configs(name)
        leaves = state_to_numpy(Dedup(tc, "cpu").init())
        assert leaves["bits"].shape == shape and "ring_events" not in leaves
        with pytest.raises(ValueError, match="bits"):
            state_from_numpy(dict(leaves, bits=leaves["bits"][..., :1]), tc,
                             "cpu")
    _, tc = configs("swbf")
    st = Dedup(tc, "cpu").init()
    leaves = state_to_numpy(st)
    assert leaves["ring_events"].shape == (4, 256 * tc.k)
    assert (leaves["ring_events"] == 32 * tc.s_words).all()
    assert leaves["ring_slot"].dtype == np.int32
    assert state_memory_bytes(st) == (leaves["bits"].nbytes + 4 + 4 + 8
                                      + leaves["ring_events"].nbytes + 4)
    with pytest.raises(ValueError, match="ring_events"):
        state_from_numpy(dict(leaves, ring_events=leaves["ring_events"][:1]),
                         tc, "cpu")
    with pytest.raises(KeyError):
        state_from_numpy({k: v for k, v in leaves.items()
                          if not k.startswith("ring")}, tc, "cpu")


def test_swbf_event_capacity_refusals():
    """One ring slot absorbs one step's events: a wider batch or pad width
    is refused with the reference's message; a ring made wide enough takes
    it, and the step equals JAX's with the same capacity."""
    jc, tc = configs("swbf")
    td = Dedup(tc, "cpu")
    keys = np.arange(512, dtype=np.uint32) % 300
    with pytest.raises(ValueError, match="exceeds the state ring's event "
                                         "capacity 256"):
        td.process(td.init(), keys)
    with pytest.raises(ValueError, match="pad width 512 exceeds the state "
                                         "ring's event capacity 256"):
        td.process_padded(td.init(), keys[:300])
    jd = jax_engine(jc)
    sj, rj = jd.process(jd.init(event_capacity=512), jnp.asarray(keys))
    st, rt = td.process(td.init(event_capacity=512), keys)
    assert np.array_equal(rt.dup.numpy(), np.asarray(rj.dup))
    assert_same_state(sj, st)
    st, rt = td.process_padded(td.init(event_capacity=512), keys[:300])
    assert rt.dup.shape == (300,)


def test_windowed_truth_matches_reference():
    keys = np.random.default_rng(8).integers(0, 500, 5000).astype(np.uint32)
    for window, b in ((1, 64), (4, 256), (8, 100)):
        assert np.array_equal(windowed_truth_from_stream(keys, window, b),
                              jwindowed(keys, window, b))


@pytest.mark.parametrize("name", ("sbf", "swbf"))
def test_debug_exact_load_matches_incremental(name):
    _, tc = configs(name)
    a = Dedup(tc, "cpu")
    b = Dedup(dataclasses.replace(tc, debug_exact_load=True), "cpu")
    keys = _streams()["unique_heavy"]
    sa, da = a.run_stream(a.init(), keys)
    sb, db = b.run_stream(b.init(), keys)
    assert torch.equal(da, db)
    assert torch.equal(sa.load, sb.load) and torch.equal(sa.bits, sb.bits)


@pytest.mark.parametrize("entry", ("init_ring", "estimate", "counter_step"))
def test_new_entry_points_default_to_cuda(entry, monkeypatch):
    """The counter slice's entry points run on cuda unless the caller
    passes "cpu": without a card they raise, and never fall back."""
    from repro_torch.core.batched import (make_counter_planes_step,
                                          make_estimate_fn)
    from repro_torch.core.sketch import get_spec
    _, tc = configs("swbf")
    calls = {
        "init_ring": lambda d: init_ring(tc, None, *d),
        "estimate": lambda d: make_estimate_fn(tc, *d),
        "counter_step": lambda d: make_counter_planes_step(
            tc, get_spec("swbf"), *d),
    }
    calls[entry](("cpu",))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry](("cuda",))


@pytest.mark.parametrize("name", ("sbf", "swbf"))
def test_named_factories_are_the_template_step(name):
    """``make_sbf_planes_step`` / ``make_swbf_planes_step`` are the counter
    step under their spec: one batch gives the engine's reports and state."""
    from repro_torch.core import u32
    from repro_torch.core.batched import (make_sbf_planes_step,
                                          make_swbf_planes_step)
    _, tc = configs(name)
    part = _installed_layout()
    step = (make_sbf_planes_step(tc, "cpu", part) if name == "sbf"
            else make_swbf_planes_step(tc, "cpu"))
    eng = Dedup(tc, "cpu", partitionable=part)
    keys = _streams()["dup_heavy"][:256]
    st, res = eng.process(eng.init(), keys)
    st2, res2 = step(eng.init(), u32.as_words(keys, "cpu"),
                     torch.ones(256, dtype=torch.bool))
    assert torch.equal(res.dup, res2.dup)
    a, b = state_to_numpy(st), state_to_numpy(st2)
    assert all(np.array_equal(a[key], b[key]) for key in a)
