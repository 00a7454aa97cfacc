"""The eight examples of the port (``examples/*_torch.py``) against the
JAX package on the CPU: each runs under ``--device cpu`` at a cut size,
and what it reports — dups, flags, estimates, load history, the served
digest — equals ``repro`` at the same config, seed and keys bit for bit,
in the installed threefry layout (``--original-threefry`` when jax's
``jax_threefry_partitionable`` is off).

* The served digest of ``serving_frontend`` is the front end's live
  digest, equal to ``repro``'s ``replay_schedule`` of the schedule the
  port recorded (the async order is not deterministic; the replay is).
* ``sharded_dedup_multidevice`` runs at 2 gloo ranks, against the
  reference's ``ShardedDedup`` on 2 forced host devices in a subprocess
  (as ``tests/test_torch_sharded.py`` does).

The references run in three background processes started with the
module; the tests that wait on them come last.
* ``dedup_training`` runs 2 steps of ``cpu-small`` from the reference's
  initial weights: its dedup weights equal ``repro``'s, and each step of
  the port from the reference trainer's state gives the reference's loss
  within 1e-5 relative (``tests/test_torch_trainer.py``'s lockstep)."""

import glob
import importlib.util
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.core import DedupConfig as JConfig
from repro.serve import ServeSession as JSession
from repro.serve import replay_schedule as j_replay

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOCKSTEP_RTOL = 1e-5


def example(name: str):
    """``examples/<name>_torch.py`` as a module."""
    path = os.path.join(ROOT, "examples", f"{name}_torch.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _layout_args() -> list:
    return [] if jax.config.jax_threefry_partitionable else \
        ["--original-threefry"]


def run(name: str, *argv) -> dict:
    return example(name).main(["--device", "cpu", *map(str, argv),
                               *_layout_args()])


# --------------------------------------------- work started in background //
SHARDED_N = 2 * 8192
N = 1 << 14                      # the single-filter examples' cut size
# the single-filter examples whose references one background worker makes
SINGLE = ("click_fraud_stream", "sliding_window_dedup",
          "count_min_heavy_hitters", "quickstart", "sbf_vs_rlbsbf")

REFERENCE_SHARDED = """
import hashlib, json, os, sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
from test_torch_sharded import auto_mesh, jax_leaves
from repro.core import Dedup, DedupConfig
from repro.dedup import ShardedDedup, ShardedDedupConfig

def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

n = int(sys.argv[1])
keys = np.random.default_rng(0).integers(0, 120_000, n).astype(np.uint32)
cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20,
                              batch_size=8192)
sd = ShardedDedup(ShardedDedupConfig(base=cfg), auto_mesh(2))
st, dup, ovf = sd.run_stream(sd.init(), jnp.asarray(keys))
one = Dedup(cfg)
_, dup1 = one.run_stream(one.init(), jnp.asarray(keys))
print(json.dumps({"dup": digest(np.asarray(dup)),
                  "n_dup": int(np.asarray(dup).sum()),
                  "overflow": np.asarray(ovf).tolist(),
                  "state": {k: digest(v) for k, v in
                            jax_leaves(st).items()},
                  "single_dup": digest(np.asarray(dup1))}))
"""

# the single-filter examples' reference outputs, each at its cut size
# from the reference's own stream generators, into an npz per example
REFERENCE_SINGLE = """
import sys
import numpy as np
import jax.numpy as jnp
from repro.core import Dedup, DedupConfig
from repro.data.streams import (clickstream, controlled_distinct_stream,
                                zipf_stream)
from repro.dedup import DedupPipeline, windowed_truth_from_stream
from repro.serve import ServeSession

n, path, out = int(sys.argv[1]), sys.argv[2], {}


def stream(cfg, keys):
    eng = Dedup(cfg)
    st, dup = eng.run_stream(eng.init(), jnp.asarray(keys))
    return eng, st, np.asarray(dup)


def quickstart():
    keys, _ = controlled_distinct_stream(n, distinct_frac=0.6, seed=0)
    for v in ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf"):
        out[f"dup/{v}"] = stream(DedupConfig.for_variant(
            v, memory_bits=2 * 1024 * 1024 * 8, batch_size=8192), keys)[2]


def sbf_vs_rlbsbf():
    keys, _ = zipf_stream(n, universe=60_000, a=1.3, seed=42)
    for v in ("sbf", "rlbsbf"):
        out[f"dup/{v}"] = stream(DedupConfig.for_variant(
            v, memory_bits=1 << 18, batch_size=8192, layout="planes",
            backend="jnp"), keys)[2]


def click_fraud_stream():
    data, _, _ = clickstream(n, fraud_frac=0.08, burst=25, seed=0)
    pipe = DedupPipeline(DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 22, batch_size=4096), mode="flag")
    out["flags"] = np.concatenate([
        np.asarray(pipe.process(
            {"key": jnp.asarray(data["key"][i:i + 4096])}).dup)
        for i in range(0, n - 4096 + 1, 4096)])
    out["load_history"] = np.asarray(
        [float(x) for x in pipe.metrics.load_history], np.float32)
    conv = pipe.metrics.convergence_point()
    out["convergence"] = np.int64(-1 if conv is None else conv)
    calls = {"n": 0}

    def score_model(batch):
        calls["n"] += len(batch["key"])
        return np.asarray(batch["key"], np.float64) % 97 / 97.0

    sess = ServeSession(DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 20, batch_size=1024), score_model)
    out["served"] = np.concatenate(
        [sess.serve({"key": data["key"][i:i + 1024]})
         for i in range(0, n, 1024)])
    out["model_calls"] = np.int64(calls["n"])


def sliding_window_dedup():
    m = 8 * 4096
    rng = np.random.default_rng(0)
    hot = rng.integers(0, 2_000, m // 2).astype(np.uint32)
    cold = (np.arange(m - m // 2) % (20 * 4096) + (1 << 20)
            ).astype(np.uint32)
    keys = np.empty(m, np.uint32)
    keys[0::2], keys[1::2] = hot, cold
    _, st, out["dup"] = stream(DedupConfig.for_variant(
        "swbf", memory_bits=1 << 22, batch_size=4096, window=8), keys)
    out["load"] = np.asarray(st.load)
    out["bits"] = np.asarray(st.bits).view(np.uint32)


def count_min_heavy_hitters():
    rng = np.random.default_rng(0)
    keys = (rng.zipf(1.3, n) % 50_000).astype(np.uint32)
    probe = np.argsort(np.bincount(keys, minlength=50_000))[-8:][::-1]
    cms, st, out["dup"] = stream(DedupConfig.for_variant(
        "cms", memory_bits=1 << 22, batch_size=4096), keys)
    out["estimate"] = np.asarray(cms.estimate(
        st, jnp.asarray(probe.astype(np.uint32))))
    hh, hst, out["flagged"] = stream(DedupConfig.for_variant(
        "hh", memory_bits=1 << 22, batch_size=4096), keys)
    cells, counts = hh.top_cells(hst, m=8)
    out["top_cells"], out["top_counts"] = np.asarray(cells), np.asarray(
        counts)


for name in sys.argv[3].split(","):
    globals()[name]()
    np.savez(f"{path}/{name}.npz", **out)
    out.clear()
print("{}")
"""

# dedup_training: 2 steps of cpu-small from the reference's weights, the
# port's step in lockstep from the reference trainer's state
TRAINING = """
import importlib.util, json, sys, tempfile
import jax, numpy as np, torch
from repro.launch.train import build as j_build
from repro_torch import convert
from repro_torch.launch.train import preset_config

spec = importlib.util.spec_from_file_location(
    "example", "examples/dedup_training_torch.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
tmp = tempfile.mkdtemp(dir=sys.argv[1])
cfg = preset_config("cpu-small")


def record(trainer):
    seen, process = [], trainer.dedup.process

    def recorded(batch, *a):
        out = process(batch, *a)
        seen.append(np.asarray(out.weights).tolist())
        return out

    trainer.dedup.process = recorded
    return seen


jt = j_build("cpu-small", 2, 0.3, tmp + "/jax", -1)
params = convert.transformer_params_from_numpy(
    cfg, jax.tree.map(np.asarray, jt.params), "cpu")
real_build, made = mod.build, []


def from_reference(*a, **kw):
    tr = real_build(*a, **kw, params=params)
    made.append((tr, record(tr)))
    return tr


mod.build = from_reference
out = mod.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                tmp + "/torch"])
trainer, port_weights = made[0]
pairs, j_step = [], jt.train_step


def both(p, o, tokens, weights):
    host = jax.tree.map(np.array, (p, o))
    _, _, tm = trainer.train_step(
        convert.transformer_params_from_numpy(cfg, host[0], "cpu"),
        convert.opt_state_from_numpy(host[1], "cpu"),
        torch.from_numpy(np.array(tokens)),
        torch.from_numpy(np.array(weights)))
    res = j_step(p, o, tokens, weights)
    pairs.append((float(res[2]["loss"]), float(tm["loss"])))
    return res


jt.train_step = both
ref_weights = record(jt)
jt.run()
print(json.dumps({"steps": out["summary"]["steps"], "losses": out["losses"],
                  "port_weights": port_weights,
                  "ref_weights": ref_weights, "pairs": pairs}))
"""


def _start(code: str, *argv, devices: int = 1):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(code), *map(str, argv)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu",
             "OMP_NUM_THREADS": "1",
             "XLA_FLAGS": f"--xla_force_host_platform_device_count={devices}"
                          " --xla_cpu_multi_thread_eigen=false",
             "JAX_THREEFRY_PARTITIONABLE":
                 "1" if jax.config.jax_threefry_partitionable else "0"})


def _finish_once(name, procs, results):
    if name not in results:
        results[name] = _finish(procs[name])


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module", autouse=True)
def background(tmp_path_factory):
    """The single-filter references, the training lockstep and the
    reference's sharded run at 2 forced host devices, started as the
    module starts; ``get(name)`` waits for one."""
    tmp = tmp_path_factory.mktemp("examples")
    procs = {"single": _start(REFERENCE_SINGLE, N, tmp, ",".join(SINGLE)),
             "training": _start(TRAINING, tmp),
             "sharded": _start(REFERENCE_SHARDED, SHARDED_N, devices=2)}
    results = {}

    def get(name):
        if name in SINGLE:                  # an example's reference npz
            _finish_once("single", procs, results)
            return dict(np.load(tmp / f"{name}.npz"))
        _finish_once(name, procs, results)
        return results[name]

    yield get
    for name in procs:
        _finish_once(name, procs, results)


# ------------------------------------------------------ the device rule //
SMALL_ARGS = {"dedup_training": ["--steps", "1"],
              "serving_frontend": ["--n", "64", "--loop-n", "1"]}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
@pytest.mark.parametrize("name", sorted(
    os.path.basename(p)[:-len("_torch.py")] for p in glob.glob(
        os.path.join(ROOT, "examples", "*_torch.py"))))
def test_example_raises_without_a_card(name):
    """On the card by default: without one an example raises, and does not
    fall back to the CPU."""
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example(name).main(SMALL_ARGS.get(name, ["--n", "256"]))


# ------------------------------------------------------ single filters //
# (the tests that wait on background work come last)

def test_click_fraud_equals_reference(background):
    out = run("click_fraud_stream", "--n", N)["check"]
    ref = background("click_fraud_stream")
    for key in ("flags", "load_history", "served"):
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    conv = int(ref["convergence"])
    assert out["convergence"] == (None if conv < 0 else conv)
    assert out["model_calls"] == int(ref["model_calls"])


def test_sliding_window_equals_reference(background):
    res = run("sliding_window_dedup", "--n", 8 * 4096)
    assert res["match"] is None
    ref = background("sliding_window_dedup")
    for key in ("dup", "load"):
        np.testing.assert_array_equal(res["check"][key], ref[key],
                                      err_msg=key)
    np.testing.assert_array_equal(res["check"]["bits"].view(np.uint32),
                                  ref["bits"])


def test_count_min_heavy_hitters_equals_reference(background):
    res = run("count_min_heavy_hitters", "--n", N)
    assert res["match"] is None
    ref = background("count_min_heavy_hitters")
    for key in ("dup", "estimate", "flagged", "top_cells", "top_counts"):
        np.testing.assert_array_equal(res["check"][key], ref[key],
                                      err_msg=key)


def test_serving_frontend_digest_equals_reference_replay():
    mod = example("serving_frontend")
    res = mod.main(["--device", "cpu", "--n", "600", "--loop-n", "96",
                    *_layout_args()])
    jcfg = JConfig.for_variant("rlbsbf", memory_bits=1 << 20, batch_size=64)
    assert res["schedule"]
    assert res["digest"] == j_replay(jcfg, res["schedule"])
    sess = JSession(jcfg, mod.score_fn, buckets=mod.BUCKETS)
    for k in mod.requests(600)[:96]:
        sess.serve({"key": np.asarray([k], np.uint32)})
    assert res["check"]["session_dups"] == sess.n_flagged_dup
    assert res["check"]["session_cached"] == sess.n_cached


def test_quickstart_equals_reference(background):
    out = run("quickstart", "--n", N)["check"]
    ref = background("quickstart")
    assert set(out) == set(ref) == {
        f"dup/{v}" for v in example("quickstart").VARIANTS}
    for key in ref:
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)


def test_sbf_vs_rlbsbf_equals_reference(background):
    res = run("sbf_vs_rlbsbf", "--n", N)
    assert res["match"] == {}              # no card: no comparison made
    ref = background("sbf_vs_rlbsbf")
    assert set(res["check"]) == set(ref) == {"dup/sbf", "dup/rlbsbf"}
    for key in ref:
        np.testing.assert_array_equal(res["check"][key], ref[key],
                                      err_msg=key)


def test_dedup_training_equals_reference(background):
    """2 steps of cpu-small from the reference's initial weights: the
    dedup weights of every batch equal, each step's loss from the same
    state within 1e-5 relative."""
    out = background("training")
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert len(out["port_weights"]) == len(out["ref_weights"]) == 2
    for a, b in zip(out["port_weights"], out["ref_weights"]):
        np.testing.assert_array_equal(np.float32(a), np.float32(b))
    for ref_loss, port_loss in out["pairs"]:
        assert port_loss == pytest.approx(ref_loss, rel=LOCKSTEP_RTOL)
    # the first step runs from the same state in both packages
    assert out["losses"][0] == pytest.approx(out["pairs"][0][0],
                                             rel=LOCKSTEP_RTOL)


def test_sharded_example_equals_reference(background):
    """The example at 2 gloo ranks (each a process it starts) against the
    reference at 2 forced host devices."""
    port = run("sharded_dedup_multidevice", "--n", SHARDED_N, "--ranks",
               2)["check"]
    ref = background("sharded")
    assert port["ranks"] == 2
    for key in ("dup", "n_dup", "overflow", "single_dup"):
        assert port[key] == ref[key], key
    assert port["state"] == ref["state"]
