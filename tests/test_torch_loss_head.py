"""The loss head under a vocab split (``models.layers.weighted_xent`` in a
step placed by ``train.jit_sharded``) and the placements that hold a
sharded LM step to the reference's per-device memory.

The smoke head check (``meshcheck.head_copies`` / ``head_temp_ok``, the
``memory`` part): qwen3-8b's smoke step at one layer traced at two vocab
sizes on fake (1, 1), (1, 4), (2, 2) and (4, 1) meshes, each in a
process of its own; the copies of each rank's fp32 logits that the step
holds (Δtemp over Δ(local logits bytes)) may not grow past 1.1x the
one-rank step's. Before the port reduced ``logsumexp`` and the gold
logit over each rank's slice, a split vocab held 9 copies and a split
batch 7, against 5 on one rank: the gold logit's gather replicated the
vocab, and autograd's backward of it made zeros of the whole logits.

On four gloo ranks as a (1, 4) and a (2, 2) mesh, logits split over
both: ``weighted_xent`` equals ``repro``'s within 1e-6 relative, its
gradient the unplaced port's within 1e-6 of its largest entry (labels at
every slice edge, zero weights), and nothing of the head is all-gathered;
``logsumexp`` over split and whole dimensions equals the plain op;
``new_zeros`` and its kin keep the splits of ``self`` that the new shape
allows, holding the same values."""

import json
import os
import pickle
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.launch import meshcheck
from repro_torch.models.layers import weighted_xent
from test_torch_sharded import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, S, V = 4, 6, 32


def _inputs():
    rng = np.random.default_rng(29)
    logits = (3 * rng.standard_normal((B, S, V))).astype(np.float32)
    # every edge of the 8- and 16-column slices of a split over 4 and 2
    edges = [0, 7, 8, 15, 16, 23, 24, 31]
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels.reshape(-1)[:len(edges)] = edges
    weights = rng.random((B, S)).astype(np.float32)
    weights[1] = 0.0
    weights[3, ::2] = 0.0
    return logits, labels, weights


XENT = """
import os, pickle, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import weighted_xent
from repro_torch.train import steps

tmp = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
logits, labels, weights = (torch.from_numpy(a) for a in pickle.load(
    open(os.path.join(tmp, "xent.pkl"), "rb")))
B, V = logits.shape[0], logits.shape[2]


def splits(t):                  # the dimension each mesh dimension splits
    return [p.dim if isinstance(p, Shard) else None for p in t.placements]


out = {}
for model in (4, 2):
    mesh = make_local_mesh(model=model, device="cpu")

    def placed(t, pls):
        return distribute_tensor(t, mesh, pls, src_data_rank=None)

    x = placed(logits, [Shard(0), Shard(2)]).requires_grad_()
    lab = placed(labels, [Shard(0), Replicate()])
    w = placed(weights, [Shard(0), Replicate()])
    steps.GATHER_REPLICATED.clear()
    with steps._sharding_handlers(), steps._replicate_plain_tensors(), \\
            CommDebugMode() as comm:
        loss = weighted_xent(x, lab, w)
        (g,) = torch.autograd.grad(loss, x)
    rec = {"loss": float(loss.full_tensor()), "grad": g.full_tensor().numpy(),
           "grad_placements": splits(g),
           "counts": {str(k): v for k, v in comm.get_comm_counts().items()},
           "gather_replicated": dict(steps.GATHER_REPLICATED)}
    with steps._sharding_handlers():
        y = x.detach()
        rec["lse"] = {name: y_.full_tensor().numpy() for name, y_ in (
            ("vocab", torch.logsumexp(y, -1)),
            ("vocab_keepdim", torch.logsumexp(y, 2, keepdim=True)),
            ("seq_vocab", torch.logsumexp(y, (1, 2))),
            ("seq", torch.logsumexp(y, 1)))}
        made = {"zeros": y.new_zeros((B, 5, V)),
                "full": y.new_full((B, 3), 2.5),
                "ones": y.new_ones((3, V)),
                "empty": y.new_empty((B, 2, V))}
        rec["made"] = {k: (splits(t),
                           None if k == "empty" else t.full_tensor().numpy())
                       for k, t in made.items()}
    out[f"1x{model}" if model == 4 else "2x2"] = rec
if rank == 0:
    with open(os.path.join(tmp, "out.pkl"), "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
print("{}")
"""


def _start_head(data: int, model: int):
    return subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(meshcheck.HEAD_WORKER),
         str(data), str(model)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": "src", "OMP_NUM_THREADS": "1"})


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four head traces and the gloo ranks, all started at once."""
    heads = {mesh: _start_head(*mesh) for mesh in meshcheck.HEAD_MESHES}
    tmp = tmp_path_factory.mktemp("loss_head")
    with open(tmp / "xent.pkl", "wb") as f:
        pickle.dump(_inputs(), f)
    try:
        run_ranks(XENT, tmp, 4)
    finally:
        copies = {mesh: _finish(p) for mesh, p in heads.items()}
    with open(tmp / "out.pkl", "rb") as f:
        ranks = pickle.load(f)
    return copies, ranks


@pytest.mark.parametrize("mesh", [m for m in meshcheck.HEAD_MESHES
                                  if m != (1, 1)],
                         ids=lambda m: f"{m[0]}x{m[1]}")
def test_a_split_holds_no_more_logit_copies(runs, mesh):
    """The smoke head check on one mesh against the one-rank step: a
    split vocab or batch holds at most 1.1x the copies of each rank's
    logits that one rank holds (9.0, 9.0 and 7.0 against 5.0 before the
    head reduced over each rank's slice)."""
    copies, _ = runs
    pair = {m: copies[m]["copies"] for m in ((1, 1), mesh)}
    assert meshcheck.head_temp_ok(pair), pair


def test_memory_part_passes_on_every_mesh(runs):
    """``head_temp_ok`` over all four meshes, as the ``memory`` part
    applies it; the one-rank step holds its logits five times."""
    copies, _ = runs
    got = {m: r["copies"] for m, r in copies.items()}
    assert meshcheck.head_temp_ok(got), got
    assert got[(1, 1)] == pytest.approx(5.0, abs=0.05)


def _plain(logits, labels, weights):
    x = torch.from_numpy(logits).requires_grad_()
    loss = weighted_xent(x, torch.from_numpy(labels),
                         torch.from_numpy(weights))
    (g,) = torch.autograd.grad(loss, x)
    return float(loss.detach()), g.detach().numpy()


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_split_loss_equals_reference(runs, mesh):
    """The loss over logits split by batch and vocab equals
    ``repro.models.layers.weighted_xent`` on the same numpy inputs."""
    _, ranks = runs
    logits, labels, weights = _inputs()
    want = float(JL.weighted_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  jnp.asarray(weights)))
    assert ranks[mesh]["loss"] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_split_gradient_equals_plain(runs, mesh):
    """The gradient against the split logits, placed as the logits are,
    equals the unplaced port's within 1e-6 of its largest entry: rows
    of zero weight get zeros, every slice edge's gold logit its -w/W."""
    _, ranks = runs
    _, want = _plain(*_inputs())
    rec = ranks[mesh]
    assert rec["grad_placements"] == [0, 2]
    assert np.abs(rec["grad"] - want).max() <= 1e-6 * np.abs(want).max()
    assert not rec["grad"][1].any()


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_head_gathers_nothing(runs, mesh):
    """Forward and backward of the head issue no all-gather (the
    reductions are all-reduces of one value a row), and the public
    gather rule never saw a split gathered dimension."""
    _, ranks = runs
    rec = ranks[mesh]
    assert not any("gather" in k for k in rec["counts"]), rec["counts"]
    assert any("all_reduce" in k for k in rec["counts"]), rec["counts"]
    assert rec["gather_replicated"] == {}


@pytest.mark.parametrize("mesh", ["1x4", "2x2"])
def test_logsumexp_handler_equals_plain(runs, mesh):
    """``logsumexp`` over the split vocab, over it and a whole dimension,
    with and without keepdim, and over a whole dimension alone."""
    _, ranks = runs
    x = torch.from_numpy(_inputs()[0])
    want = {"vocab": torch.logsumexp(x, -1),
            "vocab_keepdim": torch.logsumexp(x, 2, keepdim=True),
            "seq_vocab": torch.logsumexp(x, (1, 2)),
            "seq": torch.logsumexp(x, 1)}
    for name, w in want.items():
        np.testing.assert_allclose(ranks[mesh]["lse"][name], w.numpy(),
                                   rtol=1e-6, err_msg=name)


def test_new_factory_keeps_the_splits_the_shape_allows(runs):
    """``new_zeros`` of a new middle size keeps the batch and vocab
    splits, ``new_full`` the batch's, ``new_ones`` of another leading
    size neither; every value the constant asked for."""
    _, ranks = runs
    made = ranks["2x2"]["made"]
    assert made["zeros"][0] == [0, 2]
    assert made["full"][0] == [0, None]
    assert made["ones"][0] == [None, None]
    assert made["empty"][0] == [0, 2]
    assert (made["zeros"][1] == 0).all() and made["zeros"][1].shape == (
        B, 5, V)
    assert (made["full"][1] == 2.5).all() and made["full"][1].shape == (B, 3)
    assert (made["ones"][1] == 1).all() and made["ones"][1].shape == (3, V)


def test_peak_by_op_splits_the_temp_by_the_line_that_made_it():
    """``analyze_step(..., peak_by_op=True)``: the temp live at the peak,
    by aten op and the port's line that made each storage, adds up to
    the step's temp; the head's ``logsumexp`` is named by its line."""
    from repro_torch.launch.analysis import analyze_step
    logits, labels, weights = (torch.from_numpy(a) for a in _inputs())

    def step(x):
        return weighted_xent(x * 2, labels, weights)

    rec = analyze_step(step, (logits,), peak_by_op=True)["memory"]
    assert sum(rec["peak_by_op"].values()) == rec["temp_size_in_bytes"]
    assert any(k.startswith("aten.") and "models/layers.py:" in k
               and k.endswith(" weighted_xent") for k in rec["peak_by_op"])
    assert "peak_by_op" not in analyze_step(step, (logits,))["memory"]
