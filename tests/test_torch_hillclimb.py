"""The port's tuning driver (``repro_torch.launch.hillclimb``) against the
reference's ``repro.launch.hillclimb``.

* The experiment names, labels and hypotheses are the reference's, read
  from its source with ``ast`` (importing it would set ``XLA_FLAGS`` to
  512 host devices in this process).
* Every experiment's mutation equals the reference's: in a subprocess
  that sets its own ``XLA_FLAGS`` first, each reference experiment runs
  with ``lm_variant`` / ``dedup_variant`` replaced by a recorder (config
  fields, the accum map, the accumulation dtype, every param and cache
  spec's shard shape on the (16, 16) production mesh as an
  ``AbstractMesh``, and the argument bytes of the smoke config at small
  dims on a (2, 2) mesh); here each port experiment runs with the trace
  replaced by the same recorder.
* The mutation reaches the traced step: on a fake 4-rank (2, 2) world the
  smoke configs at small dims run through the port's ``lm_variant``.
  einsum and sort dispatch, absorbed and naive MLA give different flops;
  the spec experiments' argument bytes equal the reference's sums of
  shard bytes. These check that each mutation took effect, not that an
  experiment's hypothesis holds.
* The overlap sweep's greedy rule runs against a stubbed timer, and the
  overlap worker once at 2 gloo ranks.

The three subprocesses start together, once for the module."""

import ast
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.distributed import sharding as shr
from repro_torch.launch import dryrun, hillclimb
from repro_torch.launch.mesh import production_axes
from repro_torch.models import transformer as tfm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "src", "repro", "launch", "hillclimb.py")
# small dims of the two cells the experiments trace, and the smoke
# configs' depth, cut to one layer (deepseek's first layer is dense and
# has MLA attention; mixtral's is an MoE layer)
SMALL = {"train_4k": {"seq": 8, "batch": 4},
         "decode_32k": {"seq": 16, "batch": 2},
         "layers": {"deepseek-v2-236b/decode_32k": 1,
                    "mixtral-8x7b/train_4k": 1, "qwen3-8b/train_4k": 1,
                    "qwen3-8b/decode_32k": 1}}
# the traced experiments, in two groups that trace in parallel processes
TRACED = (("mla-noabsorb", "mla-absorb", "mla-seqcache", "mixtral-einsum",
           "mixtral-sort"),
          ("qwen3-train-baseline", "qwen3-train-kvrep",
           "qwen3-decode-baseline", "qwen3-decode-seqshard"))

REFERENCE_RECORDER = """
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
import dataclasses, json, math, sys
import numpy as np
import jax
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P
import repro.train.steps as steps
seen = {}

def spy(loss_fn, opt_cfg, accum_steps=1, accum_dtype=None):
    seen["accum_dtype"] = accum_dtype

steps.make_train_step = spy          # the experiments wrap what is here
import repro.launch.hillclimb as hc
from repro.configs import get_arch
from repro.configs.registry import LMArch, ShapeCell
from repro.optim import init_opt_state

SMALL = json.loads(sys.argv[1])
FULL = AbstractMesh((16, 16), ("data", "model"))
shapes, params_shape = {}, LMArch.params_shape

def memo(self):                      # one abstract init per config
    if self.cfg not in shapes:
        shapes[self.cfg] = params_shape(self)
    return shapes[self.cfg]

LMArch.params_shape = memo
MINI = AbstractMesh((2, 2), ("data", "model"))

def named(tree, kind):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, kind))
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf for path, leaf in flat}

def shards(specs, shapes, mesh):
    sp, sh = named(specs, P), named(shapes, jax.ShapeDtypeStruct)
    return {k: [list(NamedSharding(mesh, sp[k]).shard_shape(sh[k].shape)),
                np.dtype(sh[k].dtype).itemsize] for k in sp}

def nbytes(specs, shapes, mesh):
    return sum(math.prod(s) * b for s, b in
               shards(specs, shapes, mesh).values())

def fields(cfg):
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if isinstance(getattr(cfg, f.name),
                         (bool, int, float, str, type(None)))}
    out["dtype"] = np.dtype(cfg.dtype).name
    return out

def lm(arch_id, shape, label, hypothesis, mutate=None, accum=None):
    base = get_arch(arch_id)
    mut = (lambda c: c) if mutate is None else mutate
    accum_map = dict(base.accum)
    if accum is not None:
        accum_map[shape] = accum
    arch = LMArch(arch_id, mut(base.cfg), accum=accum_map)
    kind = arch.shapes[shape].kind
    seen.clear()
    if kind == "train":
        arch.step(shape)
    dt = seen.get("accum_dtype")
    rec = {"kind": "lm", "arch": arch_id, "shape": shape, "label": label,
           "hypothesis": hypothesis, "cfg": fields(arch.cfg),
           "accum": accum_map,
           "accum_dtype": None if dt is None else np.dtype(dt).name,
           "params": shards(arch.param_specs(FULL), arch.params_shape(),
                            FULL)}
    if kind == "decode":
        rec["cache"] = shards(arch.batch_specs(shape, FULL)["cache"],
                              arch.input_specs(shape)["cache"], FULL)
    smoke = base.smoke()
    depth = SMALL["layers"].get(f"{arch_id}/{shape}")
    if depth:
        smoke = dataclasses.replace(smoke, n_layers=depth)
    small = LMArch(arch_id, mut(smoke), accum=accum_map)
    small.shapes[shape] = ShapeCell(shape, kind, SMALL[shape])
    args = nbytes(small.param_specs(MINI), small.params_shape(), MINI)
    if kind == "train":
        opt = jax.eval_shape(lambda: init_opt_state(small.opt_config(),
                                                    small.params_shape()))
        args += nbytes(small.opt_specs(MINI), opt, MINI)
    args += nbytes(small.batch_specs(shape, MINI),
                   small.input_specs(shape), MINI)
    rec["small_argument_bytes"] = args
    return rec

def dedup(label, hypothesis, packed, capacity_factor, memory_mb=512,
          batch=1 << 20):
    return {"kind": "dedup", "label": label, "hypothesis": hypothesis,
            "packed": packed, "capacity_factor": capacity_factor,
            "memory_mb": memory_mb, "batch": batch}

hc.lm_variant, hc.dedup_variant = lm, dedup
out = {name: fn() for name, fn in hc.EXPERIMENTS.items()
       if name != "dedup-overlap"}
print(json.dumps(out))
"""

PORT_TRACES = """
import contextlib, dataclasses, json, sys
from repro_torch.configs import get_arch
from repro_torch.configs.registry import LMArch, ShapeCell
from repro_torch.launch import dryrun, hillclimb as hc
from repro_torch.launch.mesh import make_local_mesh

SMALL = json.loads(sys.argv[1])


class Small(LMArch):
    def __init__(self, arch_id, cfg, accum=None):
        super().__init__(arch_id, cfg, accum)
        for name in ("train_4k", "decode_32k"):
            self.shapes[name] = ShapeCell(name, self.shapes[name].kind,
                                          SMALL[name])


def smoke(arch_id):
    return Small(arch_id, get_arch(arch_id).smoke())  # no accumulation


@contextlib.contextmanager
def mini_world():
    with dryrun.fake_world(4):
        yield make_local_mesh(model=2, device="cpu")


trace, args = dryrun.trace_cell, []

def recorded(arch, shape, mesh):
    depth = SMALL["layers"].get(f"{arch.arch_id}/{shape}")
    if depth:                         # the mutated config, cut in depth
        arch = Small(arch.arch_id,
                     dataclasses.replace(arch.cfg, n_layers=depth))
    rec = trace(arch, shape, mesh)
    args.append(rec["memory"]["argument_size_in_bytes"])
    return rec

hc.get_arch, hc.LMArch, hc.production_world = smoke, Small, mini_world
dryrun.trace_cell = recorded
out = {}
for name in sys.argv[2].split(","):
    rec = hc.EXPERIMENTS[name]()
    out[name] = {"flops": rec["flops"], "coll_bytes": rec["coll_bytes"],
                 "argument_bytes": args[-1]}
print(json.dumps(out))
"""


def _start(code: str, *argv, env=None):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *argv], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
             "OMP_NUM_THREADS": "1", **(env or {})})


def _finish(proc, last: bool = True):
    """A started subprocess's last output line as JSON (when ``last``),
    once it ended well."""
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1]) if last else None


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """The reference's recorded mutations, the port's traces on a fake
    (2, 2) world and the overlap worker at 2 gloo ranks, all started at
    once; ``get(name)`` waits for one and reads its last line (rank 0's
    for the worker)."""
    store = tmp_path_factory.mktemp("overlap") / "store"
    procs = {"reference": [_start(REFERENCE_RECORDER, json.dumps(SMALL))],
             "traces": [_start(PORT_TRACES, json.dumps(SMALL), ",".join(g))
                        for g in TRACED],
             "worker": [subprocess.Popen(
                 [sys.executable, "-m", "repro_torch.launch.hillclimb",
                  "--overlap-worker", "--device", "cpu", "--n",
                  str(1 << 15)], cwd=ROOT, stdout=subprocess.PIPE,
                 stderr=subprocess.PIPE, text=True,
                 env={**os.environ, "PYTHONPATH": "src", "RANK": str(r),
                      "WORLD_SIZE": "2", "STORE": str(store),
                      "OMP_NUM_THREADS": "1"}) for r in range(2)]}
    results = {}

    def get(name):
        if name not in results:
            outs = [_finish(p, last=name != "worker" or i == 0)
                    for i, p in enumerate(procs[name])]
            results[name] = {k: v for o in outs if o for k, v in o.items()}
        return results[name]

    yield get
    for name in procs:
        get(name)


# -------------------------------------------------- the experiment list //
def _reference_experiments() -> dict:
    """{name: (label, hypothesis) or None} from the reference's source:
    the string arguments of the ``lm_variant`` / ``dedup_variant`` call in
    each ``@exp`` function."""
    tree = ast.parse(open(REF).read())
    out = {}
    for fn in tree.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        names = [d.args[0].value for d in fn.decorator_list
                 if isinstance(d, ast.Call) and getattr(d.func, "id", "")
                 == "exp"]
        if not names:
            continue
        out[names[0]] = None
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                    in ("lm_variant", "dedup_variant"):
                strs = [ast.literal_eval(a) for a in node.args
                        if isinstance(a, (ast.Constant, ast.JoinedStr))
                        and isinstance(ast.literal_eval(a), str)]
                label, hypothesis = strs[-2:]
                out[names[0]] = (label, hypothesis)
    return out


_EMPTY_RECORD = {"cost": {"flops": 0.0, "bytes_accessed": 0.0},
                 "memory": {}, "collectives_bytes": {},
                 "collectives_counts": {}, "trace_s": 0.0}


@contextlib.contextmanager
def _recording(monkeypatch):
    """Each port experiment with its trace replaced by a recorder of its
    arch (on the production mesh's axes, no process group) or its dedup
    arguments."""
    from repro_torch.train import steps
    seen, recs = {}, []

    def spy(loss_fn, opt_cfg, accum_steps=1, accum_dtype=None):
        seen["accum_dtype"] = accum_dtype

    monkeypatch.setattr(steps, "make_train_step", spy)
    full = production_axes(False)

    @contextlib.contextmanager
    def axes_only():
        yield full

    def lm(arch, shape, mesh):
        kind = arch.shapes[shape].kind
        seen.clear()
        if kind == "train":
            arch.step(shape)
        dt = seen.get("accum_dtype")
        rec = {"kind": "lm", "arch": arch.arch_id, "shape": shape,
               "cfg": _fields(arch.cfg), "accum": dict(arch.accum),
               "accum_dtype": None if dt is None else
               str(dt).split(".")[-1],
               "params": _shards(arch.param_specs(mesh),
                                 shr.shape_tree(arch.params_shape()),
                                 _param_itemsize(arch.params_shape()), mesh)}
        if kind == "decode":
            d = arch.shapes[shape].dims
            cache = tfm.cache_spec(arch.cfg, d["batch"], d["seq"])
            rec["cache"] = _shards(
                arch.batch_specs(shape, mesh)["cache"],
                {k: v[0] for k, v in cache.items()},
                {k: v[1].itemsize for k, v in cache.items()}, mesh)
        recs.append(rec)
        return _EMPTY_RECORD

    def dedup(multi_pod, batch, memory_mb, packed, capacity_factor):
        recs.append({"kind": "dedup", "packed": packed,
                     "capacity_factor": capacity_factor,
                     "memory_mb": memory_mb, "batch": batch})
        return _EMPTY_RECORD

    monkeypatch.setattr(hillclimb, "production_world", axes_only)
    monkeypatch.setattr(dryrun, "trace_cell", lm)
    monkeypatch.setattr(dryrun, "dedup_dryrun", dedup)
    yield recs


def _fields(cfg) -> dict:
    out = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
           if isinstance(getattr(cfg, f.name),
                         (bool, int, float, str, type(None)))}
    out["dtype"] = str(cfg.dtype).split(".")[-1]
    return out


def _named(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named(v, prefix + (str(k),))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _named(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _param_itemsize(params_shape) -> dict:
    from repro_torch.models.layers import module_leaves
    return {"/".join(map(str, lf.path)): lf.tensors[0].element_size()
            for lf in module_leaves(params_shape)}


def _shards(specs, shapes, itemsize, mesh) -> dict:
    shapes = dict(_named(shapes))
    return {k: [list(shr.shard_shape(shapes[k], spec, mesh)), itemsize[k]]
            for k, spec in _named(specs)}


def test_experiments_are_the_references():
    """Every reference experiment is in the port under its name, with its
    label and hypothesis; ``dedup-overlap`` keeps the reference's F0 / F*
    labels (its candidate sets are the card's)."""
    ref = _reference_experiments()
    assert sorted(hillclimb.EXPERIMENTS) == sorted(ref)
    assert len(ref) == 17 and ref.pop("dedup-overlap") is None
    port = {}
    with pytest.MonkeyPatch.context() as mp, _recording(mp) as recs:
        for name in ref:
            rec = hillclimb.EXPERIMENTS[name]()
            port[name] = (rec["label"], rec["hypothesis"])
    assert len(recs) == 16
    assert port == ref
    rows = hillclimb.overlap_sweep("cpu", timer=lambda env: 1.0)
    assert rows[0]["label"] == "F0-overlap-baseline"
    assert rows[-1]["label"] == "F*-overlap-accepted"


def test_mutations_equal_the_references(started):
    """Config fields, accum map, accumulation dtype, every param and cache
    spec's shard shape (and item size) on the production mesh, the dedup
    arguments: each experiment's, against the reference's."""
    ref = started("reference")
    with pytest.MonkeyPatch.context() as mp, _recording(mp) as recs:
        names = [n for n in hillclimb.EXPERIMENTS if n != "dedup-overlap"]
        for name in names:
            hillclimb.EXPERIMENTS[name]()
    assert len(recs) == len(names) == len(ref) == 16
    for name, rec in zip(names, recs):
        want = dict(ref[name])
        want.pop("label"), want.pop("hypothesis")
        want.pop("small_argument_bytes", None)
        if rec["kind"] == "lm":
            want["accum"] = {k: int(v) for k, v in want["accum"].items()}
        assert set(rec) == set(want), name
        for key in want:
            assert rec[key] == want[key], (name, key)


def test_dispatch_and_absorption_reach_the_trace(started):
    traced = started("traces")
    assert traced["mixtral-einsum"]["flops"] != \
        traced["mixtral-sort"]["flops"]
    assert traced["mla-noabsorb"]["flops"] != traced["mla-absorb"]["flops"]
    for rec in traced.values():
        assert rec["flops"] > 0


@pytest.mark.parametrize("name,twin", [
    ("qwen3-train-kvrep", "qwen3-train-baseline"),
    ("mla-seqcache", "mla-absorb"),
    ("qwen3-decode-baseline", "qwen3-decode-seqshard"),
    ("qwen3-decode-seqshard", "qwen3-decode-baseline")])
def test_spec_mutations_reach_the_trace(started, name, twin):
    """The traced argument bytes of a spec experiment and of its twin equal
    the reference's sums of shard bytes under each one's specs, so their
    difference is the reference's."""
    traced, ref = started("traces"), started("reference")
    for n in (name, twin):
        assert traced[n]["argument_bytes"] == ref[n]["small_argument_bytes"]
    assert traced[name]["argument_bytes"] - traced[twin]["argument_bytes"] \
        == ref[name]["small_argument_bytes"] - \
        ref[twin]["small_argument_bytes"]
    if name == "qwen3-train-kvrep":      # replicated wk / wv: more bytes
        assert traced[name]["argument_bytes"] > traced[twin]["argument_bytes"]


def test_overlap_sweep_accepts_greedily():
    """F0, then each candidate on top of what was accepted, kept at > 2%
    over the incumbent; on the CPU form the card's runtimes' sets are
    recorded unread and untimed."""
    speeds = {(): 100.0, ("OMP_NUM_THREADS",): 103.0}
    calls = []

    def timer(env):
        calls.append(dict(env))
        return speeds.get(tuple(sorted(env)))

    rows = hillclimb.overlap_sweep("cpu", timer=timer)
    by = {r["label"]: r for r in rows}
    assert calls == [{}, {"OMP_NUM_THREADS": "1"}]
    for label in ("F1-nccl-high-priority", "F2-one-device-connection",
                  "F3-nccl-ll-protocol"):
        assert by[label]["status"] == "not-read-by-backend"
        assert not by[label]["accepted"]
    assert by["F4-one-omp-thread"]["accepted"]
    assert by["F*-overlap-accepted"]["accepted_flags"] == \
        ["OMP_NUM_THREADS=1"]
    assert by["F*-overlap-accepted"]["speedup"] == pytest.approx(1.03)
    assert rows[0]["cell"] == "dedup-stream/pipelined_ingest_8rank/overlap"
    # the card's form times every set; 2% is not enough, a failed run is
    # never accepted
    card = {(): 100.0, ("TORCH_NCCL_HIGH_PRIORITY",): 102.0,
            ("CUDA_DEVICE_MAX_CONNECTIONS",): 150.0,
            ("CUDA_DEVICE_MAX_CONNECTIONS", "NCCL_PROTO"): None,
            ("CUDA_DEVICE_MAX_CONNECTIONS", "OMP_NUM_THREADS"): 160.0}
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "device_count", lambda: 1)
    try:
        rows = hillclimb.overlap_sweep(
            "cuda", timer=lambda env: card[tuple(sorted(env))])
    finally:
        monkey.undo()
    assert [r["accepted"] for r in rows] == [True, False, True, False, True,
                                             True]
    assert rows[-1]["accepted_flags"] == ["CUDA_DEVICE_MAX_CONNECTIONS=1",
                                          "OMP_NUM_THREADS=1"]
    assert rows[-1]["elems_per_s"] == 160.0
    assert rows[0]["cell"] == "dedup-stream/pipelined_ingest_1rank/overlap"
    assert hillclimb.accept(100.0, 102.1) and not hillclimb.accept(100.0,
                                                                    102.0)


def test_overlap_worker_at_two_gloo_ranks(started):
    out = started("worker")
    assert out["ranks"] == 2 and out["backend"] == "gloo"
    assert out["n"] == 1 << 15 and out["elems_per_s"] > 0
    assert 0 < out["dups"] < out["n"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_overlap_worker_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hillclimb.overlap_worker("cuda", 1 << 10)


def test_cli_refuses_an_unknown_experiment(capsys):
    with pytest.raises(SystemExit):
        hillclimb.main(["--exp", "no-such-experiment"])
    assert "one of" in capsys.readouterr().err


def test_records_merge_by_label(tmp_path, monkeypatch):
    """A second run replaces the record of the same label and keeps the
    others."""
    out = tmp_path / "perf.json"
    out.write_text(json.dumps([{"label": "A0-baseline-dense8-cap2",
                                "old": True}, {"label": "other"}]))
    rec = {"cell": "c", "label": "A0-baseline-dense8-cap2",
           "hypothesis": "h", "compute_s": 1.0, "memory_s": 2.0,
           "collective_s": 3.0, "temp_bytes": 0, "copies_bytes": 0,
           "trace_s": 0.5}
    monkeypatch.setitem(hillclimb.EXPERIMENTS, "dedup-baseline",
                        lambda: dict(rec))
    assert hillclimb.main(["--exp", "dedup-baseline", "--out",
                           str(out)]) == 0
    recs = json.loads(out.read_text())
    assert [r["label"] for r in recs] == ["other", "A0-baseline-dense8-cap2"]
    assert "old" not in recs[1]


def test_terms_keep_the_references_keys():
    rec = {"cost": {"flops": 2e15, "bytes_accessed": 6.7e12,
                    "bytes_by_op": {"aten.clone": 10, "aten.copy_": 5,
                                    "aten._to_copy": 1, "aten.mm": 100}},
           "memory": {"temp_size_in_bytes": 7},
           "collectives_bytes": {"all-to-all": 9e11, "total": 9e11}}
    t = hillclimb.terms(rec)
    assert set(t) == {"flops", "hbm_bytes", "coll_bytes", "compute_s",
                      "memory_s", "collective_s", "temp_bytes",
                      "copies_bytes"}
    assert t["copies_bytes"] == 16 and t["temp_bytes"] == 7
    assert t["compute_s"] == pytest.approx(2e15 / 989.4e12)
    assert t["memory_s"] == pytest.approx(2.0)
    assert t["collective_s"] == pytest.approx(2.0)
