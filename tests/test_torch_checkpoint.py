"""Checkpoints and migration in the port, on the CPU: the reference's
checkpoint tests (``tests/test_checkpoint_faults.py``), refusal tests
(``tests/test_migrate_negative.py``, the same message fragments) and the
pipeline's mid-stream round trip run against ``repro_torch.checkpoint``;
and the cross-framework checks hold bit for bit — a checkpoint saved
mid-stream by either package resumes in the other with the same per-batch
reports and final leaves, both packages write the same npz arrays and
meta.json for the same state, and ``migrate_filter_state`` equals the
reference's for all five structures both ways and for swbf's ring."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.checkpoint import layout_meta as j_layout_meta
from repro.checkpoint import migrate_filter_state as j_migrate
from repro.checkpoint.manager import _flatten as j_flatten
from repro.checkpoint.migrate import tenant_meta as j_tenant_meta
from repro.core import Dedup as JDedup
from repro.core import DedupConfig as JConfig
from repro.core.fleet import FleetDedup as JFleet
from repro.dedup import DedupPipeline as JPipeline
from repro_torch.checkpoint import (CheckpointManager, check_tenant_meta,
                                    export_tenant, import_tenant, layout_meta,
                                    migrate_filter_state, tenant_meta)
from repro_torch.checkpoint.manager import _flatten
from repro_torch.convert import state_to_numpy
from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.fleet import FleetDedup
from repro_torch.core.state import init_state
from repro_torch.data.streams import zipf_stream
from repro_torch.dedup import DedupPipeline

STRUCTURES = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")


def _layout():
    return bool(jax.config.jax_threefry_partitionable)


def _both(variant, **kw):
    return (JConfig.for_variant(variant, **kw),
            DedupConfig.for_variant(variant, **kw))


def _jleaves(state) -> dict:
    """The reference state's leaves under the port's ``state_to_numpy``
    names."""
    out = {"bits": np.asarray(state.bits),
           "position": np.asarray(state.position),
           "load": np.asarray(state.load),
           "rng": np.asarray(state.rng)}
    if state.ring is not None:
        out["ring_events"] = np.asarray(state.ring.events)
        out["ring_slot"] = np.asarray(state.ring.slot)
    return out


def assert_same_leaves(jstate, tstate, ctx=""):
    a, b = _jleaves(jstate), state_to_numpy(tstate)
    assert a.keys() == b.keys(), ctx
    for key in a:
        assert a[key].dtype == b[key].dtype, (key, ctx)
        assert np.array_equal(a[key], b[key]), (key, ctx)


def _tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "nested": {"b": torch.ones((5,), dtype=torch.bfloat16),
                       "step": torch.tensor(7, dtype=torch.int32)}}


# ----------------------------------------------------------- the manager //
def test_checkpoint_roundtrip_bitwise(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    tree["c"] = [np.arange(3, dtype=np.int16)]
    mgr.save(3, tree)
    template = {"a": torch.empty((3, 4), device="meta"),
                "nested": {"b": torch.empty(5, dtype=torch.bfloat16),
                           "step": torch.empty((), dtype=torch.int32)},
                "c": [np.zeros(3, np.int16)]}
    restored = mgr.restore(3, template)
    for k in ("a", "b", "step"):
        a = tree["a"] if k == "a" else tree["nested"][k]
        b = restored["a"] if k == "a" else restored["nested"][k]
        assert a.dtype == b.dtype and b.device.type == "cpu"
        assert torch.equal(a, b)
    assert restored["c"][0].dtype == np.int16
    assert np.array_equal(restored["c"][0], tree["c"][0])
    assert sorted(mgr.load_meta(3)["keys"]) == sorted(
        j_flatten({"a": jnp.zeros((3, 4)),
                   "nested": {"b": jnp.ones(5, jnp.bfloat16),
                              "step": jnp.int32(7)},
                   "c": [np.arange(3, dtype=np.int16)]}))


def test_reference_typed_key_restores_as_key_data(tmp_path):
    """A reference checkpoint of a typed PRNG key (``name::prngkey``)
    restores into an int32 (2,) template as the key's raw data."""
    key = jax.random.key(11)
    JManager(str(tmp_path)).save(1, {"rng": key, "w": jnp.arange(4.0)})
    got = CheckpointManager(str(tmp_path)).restore(
        1, {"rng": torch.zeros(2, dtype=torch.int32),
            "w": torch.zeros(4)})
    want = np.asarray(jax.random.key_data(key), np.uint32)
    assert np.array_equal(got["rng"].numpy().view(np.uint32), want)
    assert torch.equal(got["w"], torch.arange(4.0))


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_n=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    anchored = CheckpointManager(str(tmp_path / "anchored"), keep_n=1,
                                 anchor_every=2)
    for s in (1, 2, 3, 4, 5):
        anchored.save(s, _tree())
    assert anchored.all_steps() == [2, 4, 5]
    step, tree = anchored.restore_latest(_tree())
    assert step == 5 and torch.equal(tree["a"], _tree()["a"])
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest(
        _tree()) == (None, None)


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _tree())
    assert not [d for d in os.listdir(tmp_path) if d.endswith(".tmp")]


def test_filter_state_checkpoint_resume_identical(tmp_path):
    """The filter state (incl. the stream position) restores exactly —
    RSBF's insert probability depends on it."""
    keys = np.random.default_rng(0).integers(
        0, 5000, 6000).astype(np.uint32)
    cfg = DedupConfig.for_variant("rsbf", memory_bits=1 << 13, batch_size=512)
    d = Dedup(cfg, "cpu", partitionable=_layout())
    st, _ = d.run_stream(d.init(), keys[:3072])
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"filter": st})
    st2 = mgr.restore(1, {"filter": d.init()})["filter"]
    _, b = d.run_stream(st2, keys[3072:])
    _, a = d.run_stream(st, keys[3072:])
    assert torch.equal(a, b)


def test_jsonable_meta_takes_tensors_and_numpy():
    from repro_torch.checkpoint.manager import _jsonable
    meta = _jsonable({"t": torch.arange(3), "n": np.int64(4),
                      "a": (np.ones(2, np.float32), [torch.tensor(1.5)])})
    assert json.loads(json.dumps(meta)) == {"t": [0, 1, 2], "n": 4,
                                            "a": [[1.0, 1.0], [1.5]]}


# ------------------------------------------- refusals (message fragments) //
def _fcfg(t=4):
    return DedupConfig(variant="rlbsbf", memory_bits=2048, k=2,
                       batch_size=8, n_tenants=t, seed=3).validate()


def _fleet(t=4):
    return FleetDedup(_fcfg(t), capacity=8, device="cpu")


def test_refuses_unrecognized_layout_tag():
    with pytest.raises(ValueError,
                       match=r"unrecognized tenant layout tag 'striped'"):
        check_tenant_meta({"tenant_layout": "striped", "tenant_count": 4},
                          _fcfg(4))


def test_refuses_tenant_count_mismatch():
    meta = tenant_meta(_fcfg(8))
    with pytest.raises(ValueError,
                       match=r"tenant-count mismatch: checkpoint holds 8 "
                             r"tenant\(s\), the restoring config expects 4"):
        check_tenant_meta(meta, _fcfg(4))
    with pytest.raises(ValueError, match=r"export/import tenants explicitly"):
        check_tenant_meta(meta, _fcfg(4))


def test_refuses_legacy_checkpoint_into_fleet_config():
    with pytest.raises(ValueError, match=r"tenant-count mismatch"):
        check_tenant_meta({"step": 7}, _fcfg(4))


def test_refuses_stacked_tag_contradicting_count():
    with pytest.raises(ValueError,
                       match=r"tag 'stacked' contradicts tenant_count 1"):
        check_tenant_meta({"tenant_layout": "stacked", "tenant_count": 1},
                          _fcfg(1))


def test_accepts_matching_meta_after_json_roundtrip():
    cfg = _fcfg(4)
    fleet = _fleet(4)
    meta = json.loads(json.dumps(tenant_meta(cfg, fleet.params)))
    check_tenant_meta(meta, cfg)           # no raise
    assert meta["tenant_layout"] == "stacked"
    assert meta["tenant_params"]["max_value"] == [cfg.sbf_max] * 4
    jcfg = JConfig(**dataclasses.asdict(cfg)).validate()
    jfleet = JFleet(jcfg, capacity=8)
    assert meta == json.loads(json.dumps(j_tenant_meta(jcfg,
                                                       jfleet.params)))


def test_truncated_meta_json_refused_loudly(tmp_path):
    cfg = _fcfg(4)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _fleet(4).init(3),
             extra_meta={**layout_meta(cfg), **tenant_meta(cfg)})
    path = os.path.join(str(tmp_path), "step_0000000001", "meta.json")
    raw = open(path, "rb").read()
    with open(path, "wb") as f:
        f.write(raw[:len(raw) // 2])       # filesystem short-write
    with pytest.raises(ValueError,
                       match=r"meta\.json truncated or corrupt at"):
        mgr.load_meta(1)


def test_export_import_refuse_out_of_range_tenant():
    st = _fleet(4).init(3)
    with pytest.raises(ValueError,
                       match=r"tenant 4 out of range for a fleet of 4"):
        export_tenant(st, 4)
    sub = export_tenant(st, 0)
    with pytest.raises(ValueError,
                       match=r"tenant -1 out of range for a fleet of 4"):
        import_tenant(st, -1, sub)


def test_import_refuses_shape_mismatch():
    st = _fleet(4).init(3)
    other = init_state(DedupConfig(variant="rlbsbf", memory_bits=4096, k=2,
                                   batch_size=8, seed=3).validate(), 3,
                       device="cpu")
    with pytest.raises(ValueError,
                       match=r"tenant state shape mismatch: .* same config "
                             r"required"):
        import_tenant(st, 0, other)


def test_export_refuses_single_filter_state():
    single = init_state(DedupConfig(variant="rlbsbf", memory_bits=2048, k=2,
                                    batch_size=8, seed=3).validate(), 3,
                        device="cpu")
    with pytest.raises(ValueError,
                       match=r"not a stacked tenant-fleet state"):
        export_tenant(single, 0)


def test_export_import_tenant_equal_reference():
    """export_tenant / import_tenant on a fleet that has run: the same
    leaves as the reference's, and fresh copies (stepping the export in
    place leaves the fleet as it was)."""
    jcfg = JConfig.for_variant("bsbf", memory_bits=1 << 12, batch_size=64,
                               packed=True, n_tenants=4)
    cfg = DedupConfig(**dataclasses.asdict(jcfg)).validate()
    r = np.random.default_rng(4)
    jf, tf = JFleet(jcfg, capacity=32), FleetDedup(
        cfg, capacity=32, device="cpu", partitionable=_layout())
    js, ts = jf.init(), tf.init()
    for _ in range(4):
        keys = r.integers(0, 200, 64).astype(np.uint32)
        ten = r.integers(0, 4, 64).astype(np.int32)
        js, _ = jf.process(js, jnp.asarray(keys), jnp.asarray(ten))
        ts, _ = tf.process(ts, keys, ten)
    from repro.checkpoint.migrate import export_tenant as j_export
    from repro.checkpoint.migrate import import_tenant as j_import
    jsub, tsub = j_export(js, 2), export_tenant(ts, 2)
    assert_same_leaves(jsub, tsub)
    assert_same_leaves(j_import(jf.init(), 1, jsub),
                       import_tenant(tf.init(), 1, tsub))
    before = ts.bits.clone()
    tsub.bits.zero_()
    assert torch.equal(ts.bits, before)


# ------------------------------------------------ pipeline mid-stream //
@pytest.mark.parametrize("variant,kw", [
    ("rlbsbf", dict(packed=True)),
    ("rlbsbf", dict(packed=True, backend="pallas")),
    ("swbf", dict(window=4)),
    ("swbf", dict(window=4, backend="pallas")),
], ids=["rlbsbf-jnp", "rlbsbf-pallas", "swbf-jnp", "swbf-pallas"])
def test_pipeline_state_dict_roundtrip_midstream(tmp_path, variant, kw):
    """``state_dict``/``load_state_dict`` round-trip MID-STREAM through the
    on-disk CheckpointManager: a fresh pipeline restored from the
    checkpoint produces the same dup verdicts for the rest of the stream
    and ends in the same state (bits, position, load, rng, the swbf ring)."""
    cfg = DedupConfig.for_variant(variant, memory_bits=1 << 14,
                                  batch_size=256, **kw)
    keys, _ = zipf_stream(256 * 8, universe=600, seed=9)
    half = 256 * 4

    def pipe():
        return DedupPipeline(cfg, mode="flag", device="cpu",
                             partitionable=_layout())

    pa = pipe()
    for i in range(0, half, 256):
        pa.process({"key": keys[i:i + 256]})
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(4, pa.state_dict())
    dup_a = [pa.process({"key": keys[i:i + 256]}).dup
             for i in range(half, len(keys), 256)]
    pb = pipe()                                    # fresh engine and state
    pb.load_state_dict(mgr.restore(4, pb.state_dict()))
    assert int(pb.state.position) == half + 1      # stream position resumed
    if variant == "swbf":
        assert pb.state.ring is not None           # ring leaf round-tripped
    dup_b = [pb.process({"key": keys[i:i + 256]}).dup
             for i in range(half, len(keys), 256)]
    assert all(torch.equal(a, b) for a, b in zip(dup_a, dup_b))
    fa, fb = _flatten(pa.state_dict()), _flatten(pb.state_dict())
    assert fa.keys() == fb.keys()
    for leaf in fa:
        assert np.array_equal(fa[leaf], fb[leaf]), leaf


# ------------------------------------------- across the two packages //
RESUME_CASES = {
    "rlbsbf-dense8": ("rlbsbf", {}),
    "sbf-dense8": ("sbf", {}),
    "rlbsbf-planes": ("rlbsbf", dict(packed=True)),
    "sbf-planes": ("sbf", dict(layout="planes")),
    "swbf": ("swbf", dict(window=3)),
    "rlbsbf-fleet4": ("rlbsbf", dict(packed=True, n_tenants=4)),
    "pipeline-rsbf": ("rsbf", dict(p_star=0.5)),
}


class _Run:
    """One package's engine over the case: ``init`` and ``step`` (one
    batch -> (state, host reports)), the checkpoint tree of a state and a
    state back from a restored tree."""

    def __init__(self, case, jax_side):
        variant, kw = RESUME_CASES[case]
        jcfg, cfg = _both(variant, memory_bits=1 << 13, batch_size=128,
                          **kw)
        self.pipe = case.startswith("pipeline")
        self.fleet = cfg.n_tenants > 1
        self.jax = jax_side
        if self.pipe:
            self.eng = (JPipeline(jcfg, mode="flag") if jax_side else
                        DedupPipeline(cfg, mode="flag", device="cpu",
                                      partitionable=_layout()))
        elif self.fleet:
            self.eng = (JFleet(jcfg, capacity=64) if jax_side else
                        FleetDedup(cfg, capacity=64, device="cpu",
                                   partitionable=_layout()))
        else:
            self.eng = (JDedup(jcfg) if jax_side else
                        Dedup(cfg, "cpu", partitionable=_layout()))
        self.cfg, self.jcfg = cfg, jcfg

    def init(self):
        return self.eng.state_dict() if self.pipe else self.eng.init()

    def tree(self, st):
        return st if self.pipe else {"filter": st}

    def untree(self, tree):
        if self.pipe:
            self.eng.load_state_dict(tree)
            return tree
        return tree["filter"]

    def filter_state(self, st):
        return st["filter_state"] if self.pipe else st

    def step(self, st, keys, tenants):
        x = jnp.asarray(keys) if self.jax else keys
        if self.pipe:
            out = self.eng.process({"key": x})
            return self.eng.state_dict(), [np.asarray(out.dup)]
        if self.fleet:
            t = jnp.asarray(tenants) if self.jax else tenants
            st, res = self.eng.process(st, x, t)
            return st, [np.asarray(res.dup), np.asarray(res.routed)]
        st, res = self.eng.process(st, x)
        return st, [np.asarray(res.dup), np.asarray(res.inserted)]


def _batches(n=8, seed=1):
    r = np.random.default_rng(seed)
    return [(r.integers(0, 400, 128).astype(np.uint32),
             r.integers(0, 4, 128).astype(np.int32)) for _ in range(n)]


@pytest.mark.parametrize("writer", ("reference", "port"))
@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_checkpoint_resumes_across_packages(tmp_path, case, writer):
    """One package runs half the stream and saves; the other restores into
    its own fresh state and continues. The continuation's per-batch
    reports (dup and inserted, or dup and routed for a fleet) and final
    leaves equal those of the writer's own uninterrupted run."""
    w, r = _Run(case, writer == "reference"), _Run(case,
                                                   writer != "reference")
    batches = _batches()
    st = w.init()
    for keys, ten in batches[:4]:
        st, _ = w.step(st, keys, ten)
    mgr_cls = JManager if w.jax else CheckpointManager
    mgr_cls(str(tmp_path)).save(4, w.tree(st),
                                extra_meta=layout_meta(w.cfg))
    want = []
    for keys, ten in batches[4:]:
        st, rep = w.step(st, keys, ten)
        want.append(rep)
    rmgr = (JManager if r.jax else CheckpointManager)(str(tmp_path))
    assert rmgr.load_meta(4)["filter_layout"] == w.cfg.effective_layout
    rs = r.untree(rmgr.restore(4, r.tree(r.init())))
    for (keys, ten), rep in zip(batches[4:], want):
        rs, got = r.step(rs, keys, ten)
        for a, b in zip(rep, got):
            assert np.array_equal(a, b)
    js, ts = ((w.filter_state(st), r.filter_state(rs)) if w.jax
              else (r.filter_state(rs), w.filter_state(st)))
    assert_same_leaves(js, ts, case)


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_both_packages_write_the_same_checkpoint(tmp_path, case):
    """The same stream in both packages, saved by each: the same npz
    names, dtypes, shapes and bytes, and the same meta.json but its
    ``time``."""
    j, t = _Run(case, True), _Run(case, False)
    js, ts = j.init(), t.init()
    for keys, ten in _batches(3):
        js, _ = j.step(js, keys, ten)
        ts, _ = t.step(ts, keys, ten)
    meta = {**layout_meta(t.cfg), **tenant_meta(t.cfg)}
    JManager(str(tmp_path / "j")).save(2, j.tree(js), extra_meta=meta)
    CheckpointManager(str(tmp_path / "t")).save(2, t.tree(ts),
                                                extra_meta=meta)
    out = {}
    for side in ("j", "t"):
        d = tmp_path / side / "step_0000000002"
        with np.load(d / "arrays.npz") as z:
            out[side] = ({k: z[k] for k in z.files},
                         json.loads((d / "meta.json").read_text()))
    (ja, jm), (ta, tm) = out["j"], out["t"]
    assert list(ja) == list(ta)
    for k in ja:
        assert ja[k].dtype == ta[k].dtype and ja[k].shape == ta[k].shape, k
        assert ja[k].tobytes() == ta[k].tobytes(), k
    jm.pop("time"), tm.pop("time")
    assert jm == tm
    assert meta == {**j_layout_meta(j.jcfg), **j_tenant_meta(j.jcfg)}
    # the reference's own flattening of its state names the same leaves
    assert list(j_flatten(j.tree(js))) == list(_flatten(t.tree(ts)))


# ----------------------------------------------------------- migration //
def _ran(variant, layout_kw, keys, jax_side):
    """A state of ``variant`` after ``keys`` in the given layout."""
    jcfg, cfg = _both(variant, memory_bits=1 << 12, batch_size=128,
                      **layout_kw)
    if jax_side:
        d = JDedup(jcfg)
        return jcfg, d.run_stream(d.init(), jnp.asarray(keys))[0]
    d = Dedup(cfg, "cpu", partitionable=_layout())
    return cfg, d.run_stream(d.init(), keys)[0]


def _planes_kw(variant):
    return dict(layout="planes") if variant == "sbf" else dict(packed=True)


@pytest.mark.parametrize("direction", ("dense8->planes", "planes->dense8"))
@pytest.mark.parametrize("variant", STRUCTURES + ("swbf",))
def test_migrate_equals_reference(variant, direction, monkeypatch):
    """``migrate_filter_state`` of the same state gives the reference's
    leaves, both ways (swbf, planes only, carries its ring through a
    same-layout migration); the migrated state continues as the other
    layout's engine does."""
    import repro_torch.checkpoint.migrate as tm
    monkeypatch.setattr(tm, "MIGRATE_CHUNK_WORDS", 16)   # several chunks
    keys = np.random.default_rng(5).integers(0, 700, 1024).astype(np.uint32)
    if variant == "swbf":
        src_kw = dst_kw = dict(window=3)
    elif direction == "dense8->planes":
        src_kw, dst_kw = {}, _planes_kw(variant)
    else:
        src_kw, dst_kw = _planes_kw(variant), {}
    jsrc, jst = _ran(variant, src_kw, keys, True)
    tsrc, tst = _ran(variant, src_kw, keys, False)
    jdst, tdst = _both(variant, memory_bits=1 << 12, batch_size=128,
                       **dst_kw)
    jout = j_migrate(jst, jsrc, jdst)
    tout = migrate_filter_state(tst, tsrc, tdst)
    assert_same_leaves(jout, tout, variant)
    assert tout.bits.data_ptr() != tst.bits.data_ptr()
    more = np.random.default_rng(6).integers(0, 700, 512).astype(np.uint32)
    _, a = Dedup(tdst, "cpu", partitionable=_layout()).run_stream(tout, more)
    _, b = JDedup(jdst).run_stream(jout, jnp.asarray(more))
    assert np.array_equal(a.numpy(), np.asarray(b))


def test_migrate_refuses_different_filters():
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 12,
                                  packed=True)
    st = Dedup(cfg, "cpu").init()
    with pytest.raises(ValueError, match="different filters"):
        migrate_filter_state(st, cfg, DedupConfig.for_variant(
            "rlbsbf", memory_bits=1 << 13))
    cms = DedupConfig.for_variant("cms", memory_bits=1 << 12)
    with pytest.raises(ValueError, match="count_threshold"):
        migrate_filter_state(Dedup(cms, "cpu").init(), cms,
                             DedupConfig.for_variant("cms",
                                                     memory_bits=1 << 12,
                                                     count_threshold=3))


@pytest.mark.parametrize("variant", ("rlbsbf", "sbf", "swbf", "cms", "hh"))
def test_layout_meta_equals_reference(variant):
    kw = dict(memory_bits=1 << 12)
    if variant == "swbf":
        kw["window"] = 4
    for lay in ({}, dict(layout="planes")):
        jcfg, cfg = _both(variant, **kw, **lay)
        assert layout_meta(cfg) == j_layout_meta(jcfg)
