"""The port's dry run and step analysis (``repro_torch.launch.dryrun``,
``repro_torch.launch.analysis``) against the reference's shapes.

``analyze_step`` counts 2mnk flops for a lone matmul, one all-gather of
the tensor's bytes for a known redistribute, one all-to-all of the local
result for a split-to-split one, and the bytes of each aten op. An accumulating step over
a batch split over the production meshes moves its rows in all-to-alls
and gathers none. On a fake 256-rank world,
``dryrun_cell`` on a full-width cell (qwen3-8b decode_32k, single mesh)
and ``dedup_dryrun`` give argument bytes per device equal to the
reference's shard shapes summed (``NamedSharding.shard_shape`` on a
``jax.sharding.AbstractMesh``). A fake process group is global to its
process, so the parts that bring one up run in one subprocess of their
own, started when the module's first test needs it."""

import json
import math
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as j_get_arch
from repro.core import DedupConfig as JConfig
from repro.dedup import ShardedDedup as JSharded
from repro.dedup import ShardedDedupConfig as JShardedConfig
from repro_torch.launch import analysis, dryrun

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = """
import json, sys
import torch, torch.distributed as dist
from repro_torch.launch import analysis, dryrun

out = {}
with dryrun.fake_world(4):
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_local_mesh
    mesh = make_local_mesh(model=2, device="cpu")
    x = distribute_tensor(torch.randn(64, 32), mesh, [Shard(0), Replicate()],
                          src_data_rank=None)
    r = analysis.analyze_step(
        lambda t: t.redistribute(mesh, [Replicate(), Replicate()]), (x,))
    out["redistribute"] = {k: r[k] for k in
                           ("collectives_counts", "collectives_bytes")}
    r = analysis.analyze_step(
        lambda t: t.redistribute(mesh, [Shard(1), Replicate()]), (x,))
    out["split_to_split"] = {k: r[k] for k in
                             ("collectives_counts", "collectives_bytes")}
    out["split_to_split"]["local_bytes"] = \
        r["outputs"].to_local().numel() * 4
assert not dist.is_initialized()
# an accumulating step over a batch split over the production mesh's
# batch axes: 4 microbatches of 256 rows of 33 token ids, a replicated
# table (so that only the batch moves)
import torch.nn.functional as F
from repro_torch.distributed.sharding import P, batch_axes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.layers import Params
from repro_torch.optim import OptimizerConfig, OptState, init_opt_state
from repro_torch.train import jit_sharded, make_train_step


def loss_fn(p, tokens, w):
    per = F.embedding(tokens, p["table"]).pow(2).mean((1, 2))
    return (per * w).sum() / w.sum()


for multi in (False, True):
    with dryrun.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi, device="cpu")
        params = Params(table=torch.randn(64, 8))
        opt = init_opt_state(OptimizerConfig(), params)
        rep = {"table": P(None, None)}
        b_ax = batch_axes(mesh)
        fn = jit_sharded(make_train_step(loss_fn, OptimizerConfig(),
                                         accum_steps=4), mesh,
                         (rep, OptState(P(), rep, rep), P(b_ax, None),
                          P(b_ax)))
        r = analysis.analyze_step(fn.placed, fn.place(
            params, opt, torch.randint(0, 64, (256, 33), dtype=torch.int32),
            torch.ones(256)))
        out["accum_multi" if multi else "accum_single"] = {
            k: r[k] for k in ("collectives_counts", "collectives_bytes")}
for name, rec in (("decode", dryrun.dryrun_cell("qwen3-8b", "decode_32k",
                                                False)),
                  ("dedup", dryrun.dedup_dryrun(False))):
    out[name] = {k: rec[k] for k in ("memory", "n_chips", "mesh_shape",
                                     "collectives_counts", "kind")}
    out[name]["flops"] = rec["cost"]["flops"]
# moe_apply alone, forward and backward, both dispatches, unplaced and on
# fake (4, 1) and (2, 2) meshes: its token groups split over "data"
from repro_torch.launch import meshcheck
out["moe"] = {}
for disp in ("sort", "einsum"):
    rec = {"plain": meshcheck.moe_apply_trace("mixtral-8x7b", disp)}
    for model in (1, 2):
        with dryrun.fake_world(4):
            rec[f"4x{model}" if model == 1 else "2x2"] = \
                meshcheck.moe_apply_trace("mixtral-8x7b", disp,
                                          make_local_mesh(model=model,
                                                          device="cpu"))
    out["moe"][disp] = {k: {"flops": r["cost"]["flops"],
                            "collectives_bytes": r["collectives_bytes"],
                            "param_bytes": r["param_bytes"]}
                        for k, r in rec.items()}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def fake_runs():
    proc = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(WORKER)], cwd=ROOT,
        capture_output=True, text=True, timeout=900,
        env={**os.environ, "PYTHONPATH": "src"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _shard_bytes(mesh, shape, dtype, spec) -> int:
    return math.prod(NamedSharding(mesh, spec).shard_shape(shape)) * \
        np.dtype(dtype).itemsize


def test_analyze_step_counts_a_lone_matmul():
    m, k, n = 48, 40, 24
    a, b = torch.randn(m, k), torch.randn(k, n)
    r = analysis.analyze_step(lambda x, y: x @ y, (a, b))
    assert r["cost"]["flops"] == 2 * m * k * n
    assert r["cost"]["bytes_accessed"] == 4 * (m * k + k * n + m * n)
    assert r["memory"]["argument_size_in_bytes"] == 4 * (m * k + k * n)
    assert r["memory"]["output_size_in_bytes"] == 4 * m * n
    assert r["collectives_counts"] == {}
    assert r["collectives_bytes"] == {"total": 0}
    assert torch.equal(r["outputs"], a @ b)


def test_analyze_step_counts_one_all_gather(fake_runs):
    r = fake_runs["redistribute"]
    assert r["collectives_counts"] == {"all-gather": 1}
    assert r["collectives_bytes"] == {"all-gather": 64 * 32 * 4,
                                      "total": 64 * 32 * 4}


def test_analyze_step_counts_split_to_split_as_one_all_to_all(fake_runs):
    """Shard(0) -> Shard(1) over the (2, 2) mesh's first dimension: one
    all-to-all of the local (64, 16) result, as the card runs it, and no
    all-gather, though gloo's form of it is an all-gather and a chunk."""
    r = fake_runs["split_to_split"]
    assert r["local_bytes"] == 64 * 16 * 4
    assert r["collectives_counts"] == {"all-to-all": 1}
    assert r["collectives_bytes"] == {"all-to-all": 64 * 16 * 4,
                                      "total": 64 * 16 * 4}


# the port's einsum equations (models/), two and three operands
EINSUMS = ("bhd,bfd->bhfd", "bhfd,ohf->bod", "bhgqk,bkhd->bqhgd",
           "bhqk,bkc->bqhc", "bid,bjd->bij", "bqhc,bkc->bhqk",
           "bqhc,chv->bqhv", "bqhgd,bkhd->bhgqk", "bqhn,chn->bqhc",
           "bqhr,bkr->bhqk", "bqhv,hvd->bqd", "bsc,che->bshe",
           "bsd,dhe->bshe", "bsd,dke->bske", "bsd,dv->bsv", "bshe,hed->bsd",
           "bsl,lhe->bshe", "necd,edf->necf", "necf,efd->necd",
           "ntec,necd->ntd", "ntec,ntd->necd", "ntke,ntkec,ntk->ntec",
           "ntke,ntkec->ntec")


@pytest.mark.parametrize("equation", EINSUMS)
def test_einsum_flops_equal_the_lowered_count(equation):
    """``einsum_flops`` — what an einsum that reaches the counters whole
    (torch 2.11) is counted — equals the count of the bmm / mul lowering
    torch 2.13 hands them, on every equation the models use."""
    terms = equation.split("->")[0].split(",")
    g = torch.Generator().manual_seed(len(equation))
    dims = {c: int(torch.randint(2, 7, (1,), generator=g))
            for c in sorted(set("".join(terms)))}
    ops = [torch.randn([dims[c] for c in t]) for t in terms]
    r = analysis.analyze_step(lambda *o: torch.einsum(equation, *o), ops)
    assert analysis.einsum_flops(equation, [o.shape for o in ops]) == \
        r["cost"]["flops"]


def test_analyze_step_reports_bytes_by_op():
    """One clone's operand and result bytes under ``bytes_by_op``, and
    ``copy_bytes`` (the reference's ``essential_by_op["copy"]``) is
    theirs."""
    x = torch.randn(12, 10)
    r = analysis.analyze_step(lambda t: t.clone().mul_(2), (x,))
    by_op = r["cost"]["bytes_by_op"]
    assert by_op["aten.clone"] == 2 * 12 * 10 * 4
    assert sum(by_op.values()) == r["cost"]["bytes_accessed"]
    assert analysis.copy_bytes(r["cost"]) == 2 * 12 * 10 * 4


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_accumulating_step_gathers_no_batch_rows(fake_runs, mesh):
    """4 microbatches of a batch of 256 rows split over 16 ("data") or 32
    (("pod", "data")) ranks: each rank keeps its share of every
    microbatch. The token ids and the weights travel once, in one
    all-to-all per mesh dimension that splits them, each of a (D, m, c,
    ...) buffer (m = 1 slot, c = 64 / D rows of a microbatch per rank);
    nothing is all-gathered."""
    r = fake_runs[f"accum_{mesh}"]
    n_dims, d = (1, 16) if mesh == "single" else (2, 32)
    row_bytes = 33 * 4 + 4                       # token ids, a weight
    assert "all-gather" not in r["collectives_counts"]
    assert "all-gather" not in r["collectives_bytes"]
    assert r["collectives_counts"]["all-to-all"] == 2 * n_dims
    assert r["collectives_bytes"]["all-to-all"] == \
        n_dims * d * (64 // d) * row_bytes


def test_decode_cell_argument_bytes_equal_the_reference(fake_runs):
    """Parameters, the 32k KV cache, token and pos of qwen3-8b's
    decode_32k, per device on the (16, 16) mesh."""
    rec = fake_runs["decode"]
    assert rec["n_chips"] == 256 and rec["kind"] == "decode"
    assert rec["mesh_shape"] == {"data": 16, "model": 16}
    mesh = AbstractMesh((16, 16), ("data", "model"))
    arch = j_get_arch("qwen3-8b")
    want = 0
    pshape = arch.params_shape()
    for sd, spec in zip(jax.tree.leaves(pshape), jax.tree.leaves(
            arch.param_specs(mesh), is_leaf=lambda x: isinstance(x, JP))):
        want += _shard_bytes(mesh, sd.shape, sd.dtype, spec)
    inputs = arch.input_specs("decode_32k")
    specs = arch.batch_specs("decode_32k", mesh)
    for sd, spec in zip(jax.tree.leaves(inputs), jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))):
        want += _shard_bytes(mesh, sd.shape, sd.dtype, spec)
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["memory"]["temp_size_in_bytes"] > 0


def test_decode_cell_flops_equal_the_shape_count(fake_runs):
    """qwen3-8b's decode_32k per device on the (16, 16) mesh: the flops
    of its matmuls and both attention products with the batch over
    "data" and the heads (head_dim where the 8 KV heads do not divide
    16), the FFN, the vocab and the cache's sequence over "model", within
    1% (torch 2.13 counted its einsums' propagation at the global shapes,
    inference mode hid its matmuls)."""
    cfg = j_get_arch("qwen3-8b").cfg
    b, s = 128 // 16, 32768
    d, hd = cfg.d_model, cfg.head_dim
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    per_layer = (2 * b * d * (2 * q + 2 * kv)       # wq, wo; wk, wv
                 + 2 * 2 * b * q * s                # q k^T and p v
                 + 3 * 2 * b * d * cfg.d_ff)         # the SwiGLU
    want = (cfg.n_layers * per_layer + 2 * b * d * cfg.vocab) / 16
    got = fake_runs["decode"]["flops"]
    assert abs(got / want - 1) <= 0.01, (got, want)


@pytest.mark.parametrize("dispatch", ["sort", "einsum"])
def test_moe_apply_splits_its_groups_over_data(fake_runs, dispatch):
    """mixtral-8x7b's smoke MoE layer forward and backward, 4 x 64 tokens
    in 8 groups of 32: on a fake (4, 1) mesh each rank does a quarter of
    the unplaced flops (within 2%) and moves only the params' gradients
    (one all-reduce of their bytes, no all-gather or all-to-all of
    activations); on (2, 2) at least half of them."""
    r = fake_runs["moe"][dispatch]
    plain, split, both = r["plain"], r["4x1"], r["2x2"]
    assert abs(plain["flops"] / split["flops"] / 4 - 1) <= 0.02
    assert set(split["collectives_bytes"]) <= {"all-reduce", "total"}
    assert split["collectives_bytes"].get("all-reduce", 0) <= \
        split["param_bytes"]
    assert both["flops"] <= plain["flops"] / 2


def test_dedup_dryrun_argument_bytes_equal_the_reference(fake_runs):
    """The sharded filter's state slab and the keys of one global batch of
    2^20 over 256 ranks, per device."""
    rec = fake_runs["dedup"]
    assert rec["n_chips"] == 256 and rec["kind"] == "dedup"
    assert set(rec["collectives_counts"]) == {"all-to-all"}
    mesh = AbstractMesh((16, 16), ("data", "model"))
    axes = ("data", "model")
    cfg = JConfig.for_variant("rlbsbf", memory_bits=512 * 8 * 1024 * 1024,
                              packed=False)
    sd = JSharded(JShardedConfig(base=cfg, mesh_axes=axes), mesh)
    state = jax.eval_shape(sd.init)
    want = sum(_shard_bytes(mesh, x.shape, x.dtype,
                            JP(axes, *([None] * (x.ndim - 1))))
               for x in jax.tree.leaves(state))
    want += _shard_bytes(mesh, (1 << 20,), np.uint32, JP(axes))
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_skipped_cells_and_the_cli_resume(tmp_path, capsys):
    """A cell with a skip reason is skipped by rule, with no process
    group; the CLI writes it, resumes by (arch, shape, mesh) and exits
    0."""
    rec = dryrun.dryrun_cell("qwen3-8b", "long_500k", True)
    assert "skipped" in rec and rec["mesh"] == "multi"
    out = tmp_path / "dr.json"
    argv = ["--arch", "qwen3-8b", "--shape", "long_500k", "--mesh", "both",
            "--out", str(out)]
    assert dryrun.main(argv) == 0
    recs = json.loads(out.read_text())
    assert [(r["mesh"], "skipped" in r) for r in recs] == [
        ("single", True), ("multi", True)]
    assert dryrun.main(argv) == 0
    assert "skip cached" in capsys.readouterr().out
    assert not torch.distributed.is_initialized()
