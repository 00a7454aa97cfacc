"""The port's training loop (``repro_torch.train.Trainer``,
``repro_torch.launch.train``) on the CPU: the reference's trainer,
straggler and re-mesh tests mirrored; ``build("cpu-small")`` from the
reference's own initial weights against the reference's ``build`` over 14
steps, with and without an injected fault; and a trainer checkpoint
written by each package that the other restores bit for bit, the next
step's loss then within 1e-5 relative (one forward pass from the same
state, as the first step's loss).

Every step is held in lockstep: the port's train step runs from the
reference trainer's state of that step (params, moments and step counter
crossed through ``repro_torch.convert``) on the reference's batch and
dedup weights, and its loss is within 1e-5 relative of the reference's,
its learning rate within 1e-6 (an fp32 ulp: the compiled reference
divides by the warmup length as a product with its reciprocal). The
free-running trajectories are a secondary check, held to 5e-2 relative
per step: at the reference's init for cpu-small (fan-in on the heads
axis, saturated attention) the fp32 gradients of either framework sit
percents from the float64 gradients of the same step
(``tests/test_torch_train.py::
test_fp32_gradients_as_near_float64_as_the_reference``), and AdamW's
first steps move every weight by +-lr whatever the gradient's size, so
two fp32 runs part after one step. The dedup weights — what the paper's stage
decides — are equal exactly."""

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.launch.train import build as j_build
from repro_torch import convert
from repro_torch.convert import state_to_numpy
from repro_torch.launch.train import build, preset_config
from repro_torch.train import MeshShape, StragglerWatchdog, remesh

STEPS, FAULT_AT = 14, 11
TRAJECTORY_RTOL = 5e-2
LOCKSTEP_RTOL = 1e-5


def _record_weights(trainer):
    """Wrap the trainer's dedup stage: every batch's loss weights."""
    seen, process = [], trainer.dedup.process

    def recorded(batch, *a):
        out = process(batch, *a)
        seen.append(np.asarray(out.weights))
        return out

    trainer.dedup.process = recorded
    return seen


def _lockstep(jax_trainer, port_step):
    """Wrap the reference trainer's train step: before each call the
    port's ``port_step`` runs from a converted copy of the same state on
    the same tokens and weights. -> [(reference metrics, port metrics)],
    as floats, one per step taken."""
    cfg, pairs, j_step = preset_config("cpu-small"), [], jax_trainer.train_step

    def both(params, opt_state, tokens, weights):
        host = jax.tree.map(np.array, (params, opt_state))
        _, _, tm = port_step(
            convert.transformer_params_from_numpy(cfg, host[0], "cpu"),
            convert.opt_state_from_numpy(host[1], "cpu"),
            torch.from_numpy(np.array(tokens)),
            torch.from_numpy(np.array(weights)))
        out = j_step(params, opt_state, tokens, weights)
        pairs.append(tuple({k: float(m[k]) for k in ("loss", "lr")}
                           for m in (out[2], tm)))
        return out

    jax_trainer.train_step = both
    return pairs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' cpu-small trainers from the reference's initial
    weights, with and without the fault, run to the end: {(package,
    fault): (trainer, summary, weights per batch)}, and {("lockstep",
    fault): [(reference metrics, port metrics)] of every step}."""
    out = {}
    for fault in (False, True):
        fa = FAULT_AT if fault else -1
        jt = j_build("cpu-small", STEPS, 0.3,
                     str(tmp_path_factory.mktemp(f"jax{fault}")), fa)
        params = convert.transformer_params_from_numpy(
            preset_config("cpu-small"),
            jax.tree.map(np.asarray, jt.params), "cpu")
        tt = build("cpu-small", STEPS, 0.3,
                   str(tmp_path_factory.mktemp(f"torch{fault}")), fa,
                   device="cpu", params=params)
        out["lockstep", fault] = _lockstep(jt, tt.train_step)
        for name, tr in (("jax", jt), ("torch", tt)):
            w = _record_weights(tr)
            out[name, fault] = (tr, tr.run(), w)
    return out


# ------------------------------------------ the reference's tests, mirrored //

def test_trainer_recovers_from_injected_fault(runs):
    trainer, summary, _ = runs["torch", True]
    assert summary["steps"] == 14          # completed despite the fault
    assert trainer.ckpt.latest_step() == 14
    assert np.isfinite(summary["final_loss"])


def test_straggler_watchdog_flags_outlier():
    wd = StragglerWatchdog(sigma=3.0)
    for _ in range(50):
        wd.observe(0.1)
    assert wd.observe(1.0) is True
    assert wd.flagged == 1


def test_remesh_shrinks_to_fit():
    mesh = remesh({"data": 4, "model": 1}, devices=[torch.device("cpu")])
    # one device -> data shrinks to 1
    assert int(np.prod(list(mesh.shape.values()))) == 1
    assert tuple(mesh.axis_names) == ("data", "model")
    assert isinstance(mesh, MeshShape)
    mesh = remesh({"pod": 2, "data": 4, "model": 2},
                  devices=[torch.device("cpu")] * 4)
    # the data axis goes first, all the way, then the pod axis if needed
    assert mesh.shape == {"pod": 2, "data": 1, "model": 2}
    assert mesh.devices.shape == (2, 1, 2)
    with pytest.raises(ValueError, match="cannot fit"):
        remesh({"data": 2, "model": 4}, devices=[torch.device("cpu")] * 2)


def test_remesh_under_a_process_group_is_a_device_mesh(tmp_path):
    """Where a process group is up the mesh is a ``DeviceMesh`` over its
    ranks (here gloo at world size 1, so data shrinks to 1)."""
    from torch.distributed.device_mesh import DeviceMesh
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = remesh({"data": 4, "model": 1})
        assert isinstance(mesh, DeviceMesh)
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------ against the reference -- //

@pytest.mark.parametrize("fault", (False, True))
def test_build_matches_reference_per_step(runs, fault):
    jt, jsum, jw = runs["jax", fault]
    tt, tsum, tw = runs["torch", fault]
    assert tsum["steps"] == jsum["steps"] == STEPS
    # the fault rolls back to step 10 after step 11: one step runs twice
    assert len(tt.history) == len(jt.history) == STEPS + (1 if fault else 0)
    for a, b in zip(tt.history, jt.history):
        assert a["step"] == b["step"]
        tol = 1e-5 if a["step"] == 1 else TRAJECTORY_RTOL
        assert abs(a["loss"] - b["loss"]) <= tol * abs(b["loss"]), a["step"]
    assert len(tw) == len(jw) == STEPS + (1 if fault else 0)
    for a, b in zip(tw, jw):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert 0 < sum(int((w == 0).sum()) for w in tw)


@pytest.mark.parametrize("fault", (False, True))
def test_build_matches_reference_in_lockstep(runs, fault):
    """Each step of the reference's run, the fault's retry included, taken
    by the port from the reference's state of that step."""
    pairs = runs["lockstep", fault]
    assert len(pairs) == STEPS + (1 if fault else 0)
    for i, (want, got) in enumerate(pairs):
        assert abs(got["lr"] - want["lr"]) <= 1e-6 * want["lr"], i
        assert abs(got["loss"] - want["loss"]) <= \
            LOCKSTEP_RTOL * abs(want["loss"]), (i, got, want)


def _same_trees(torch_trainer, jax_trainer):
    """The two trainers' states leaf for leaf, bit for bit."""
    cfg = preset_config("cpu-small")
    tp = convert.transformer_params_to_numpy(cfg, torch_trainer.params)
    for path, want in jax.tree_util.tree_flatten_with_path(
            jax_trainer.params)[0]:
        have = dict(jax.tree_util.tree_flatten_with_path(tp)[0])[path]
        assert np.array_equal(have, np.asarray(want)), path
    ts = convert.opt_state_to_numpy(torch_trainer.opt_state)
    js = jax.tree.map(np.asarray, jax_trainer.opt_state)
    assert ts.step == js.step and ts.step.dtype == js.step.dtype
    for which in ("m", "v"):
        flat = dict(jax.tree_util.tree_flatten_with_path(
            getattr(ts, which))[0])
        for path, want in jax.tree_util.tree_flatten_with_path(
                getattr(js, which))[0]:
            assert np.array_equal(flat[path], want), (which, path)
    tf = state_to_numpy(torch_trainer.dedup.state)
    jf = jax_trainer.dedup.state
    for key, leaf in (("bits", jf.bits), ("position", jf.position),
                      ("load", jf.load),
                      ("rng", jax.random.key_data(jf.rng))):
        assert np.array_equal(tf[key], np.asarray(leaf)), key


@pytest.mark.parametrize("writer", ("jax", "torch"))
def test_trainer_checkpoint_crosses_packages(runs, writer, tmp_path):
    """The writer's final checkpoint (step 14, after the fault run) restored
    by a fresh trainer of the other package: every leaf bit for bit, and
    one more step on the same batch with the same loss."""
    src, _, _ = runs[writer, True]
    reader = "torch" if writer == "jax" else "jax"
    fresh = (build("cpu-small", STEPS + 1, 0.3, src.cfg.ckpt_dir,
                   device="cpu") if reader == "torch" else
             j_build("cpu-small", STEPS + 1, 0.3, src.cfg.ckpt_dir))
    assert fresh.try_restore() and fresh.step == STEPS
    pair = {writer: src, reader: fresh}
    _same_trees(pair["torch"], pair["jax"])
    batch = next(src.data)
    losses = [float(pair[p]._one_step(dict(batch))["loss"])
              for p in ("jax", "torch")]
    assert abs(losses[1] - losses[0]) <= 1e-5 * abs(losses[0])


def test_build_runs_on_cuda_unless_asked_for_the_cpu(tmp_path):
    """The driver's entry point follows the port's device rule: without a
    card and without ``device="cpu"`` it raises, never falling back."""
    if torch.cuda.is_available():
        pytest.skip("the rule's refusal shows only without a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build("cpu-small", 2, 0.3, str(tmp_path))
    assert build("cpu-small", 2, 0.3, str(tmp_path), device="cpu"
                 ).params["embed"].device.type == "cpu"
