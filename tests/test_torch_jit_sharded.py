"""``repro_torch.train.jit_sharded``: one train step of each model family's
smoke config placed on a (2, 2) ("data", "model") mesh of four gloo ranks,
against the unsharded port step and against ``repro``'s step.

The families: a dense LM (qwen3-8b: vocab, heads and FFN over "model",
ZeRO-1 moments over "data"), a mixture of experts (mixtral-8x7b, its four
smoke experts split over "model", the sort dispatch's scatters), the GNN
(MeshGraphNet, its graph split over ("data", "model") as the ogb_products
cell splits it) and a recsys ranker (DLRM-RM2, its tables' rows over
"model"); the dense LM again in 2 microbatches, each rank holding one
row of each; and decode steps with the reference's sequence-parallel
cache. Each rank runs as a process of its own; the reference runs in
this process on the same numpy-seeded params and inputs. Every parameter
leaf after the step within 1e-5 of the tree's max |value|, and the loss
and the gradient norm within 1e-5 of theirs: the sharded sums add
partial products in another order. The optimizer runs without warmup
(``no_warmup``), so that the check sees a wrong update, as planted faults
show."""

import dataclasses
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.optim import init_opt_state as j_init_opt
from repro.train.steps import make_train_step as j_make_train_step
from test_torch_sharded import run_ranks

FAMILIES = {"lm": "qwen3-8b", "lm_accum": "qwen3-8b", "moe": "mixtral-8x7b",
            "gnn": "meshgraphnet", "recsys": "dlrm-rm2"}
# "lm_accum": the LM step in 2 microbatches; its batch of 4 rows is split
# over "data" 2, so each rank holds one row of each microbatch
ACCUM = {"lm_accum": 2}
TOL = 1e-5
LR = 1e-4


def no_warmup(cfg):
    """The arch's optimizer with no warmup and a peak lr of 1e-4: the
    first step's update of an element is about 1e-4, not 1% of the
    peak, so that a dropped, halved or reversed update of a leaf lies 3
    to 12x outside the parameter check's bound (1e-5 of the tree's
    largest |value|, about 1.7 here: the norm scales start at 1).
    AdamW's first update is lr g / (|g| + eps), so where a gradient sums
    to ~eps two orders of summation differ by up to ~10% of the lr (MoE
    against the reference: 8.6e-6 at 1e-4); at the archs' own 3e-4 to
    1e-3 that would pass the bound."""
    return dataclasses.replace(cfg, warmup_steps=0, lr=LR)


def _inputs(family: str, rc):
    rng = np.random.default_rng(11)
    if family in ("lm", "lm_accum", "moe"):
        toks = rng.integers(0, rc.vocab, (4, 41)).astype(np.int32)
        return {"tokens": toks,
                "weights": np.array([1.0, 0.0, 0.5, 1.0], np.float32)}
    if family == "gnn":
        n, e = 64, 128
        return {"batch": {
            "nodes": rng.standard_normal((n, rc.d_node_in)).astype(
                np.float32),
            "edges": rng.standard_normal((e, 8)).astype(np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": rng.random(e) < 0.9,
            "node_mask": rng.random(n) < 0.9,
            "targets": rng.standard_normal((n, rc.d_out)).astype(
                np.float32)}, "weights": None}
    b = 16
    ids = np.stack([rng.integers(0, v, b) for v in rc.vocab_sizes],
                   1).astype(np.int32)
    w = np.ones(b, np.float32)
    w[3] = 0.0
    return {"batch": {"dense": rng.standard_normal((b, rc.n_dense)).astype(
        np.float32), "sparse_ids": ids,
        "labels": (rng.random(b) < 0.3).astype(np.float32)}, "weights": w}


def _reference(family: str, arch_id: str):
    """(ref cfg, params before, inputs, and a function that runs the
    reference's step on them -> (params after, loss, grad norm))."""
    jarch = j_get_arch(arch_id)
    rc = jarch.smoke()
    opt_cfg = no_warmup(jarch.opt_config())
    if family in ("lm", "lm_accum", "moe"):
        rp = JT.init(rc, jax.random.PRNGKey(0))
        arch = type(jarch)(arch_id, rc,
                           accum={"train_4k": ACCUM.get(family, 1)})
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_4k")
    elif family == "gnn":
        rp = JG.init(rc, jax.random.PRNGKey(0))
        step = j_make_train_step(lambda p, b, w: JG.loss_fn(rc, p, b, w),
                                 opt_cfg)
    else:
        rp = JR.init(rc, jax.random.PRNGKey(0))
        arch = type(jarch)(arch_id, rc)
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_batch")
    inp = _inputs(family, rc)

    def run():
        opt = j_init_opt(opt_cfg, rp)
        args = [jax.tree.map(jnp.asarray, v) for v in inp.values()]
        new, _, m = jax.jit(step)(rp, opt, *args)
        return (jax.tree.map(np.asarray, new), float(m["loss"]),
                float(m["grad_norm"]))

    return rc, jax.tree.map(np.asarray, rp), inp, run


WORKER = """
import dataclasses, os, pickle, sys
import numpy as np
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.distributed import sharding as shr
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import gnn, recsys, transformer
from repro_torch.models.layers import module_leaves, tensor_batch
from repro_torch.optim import OptState, init_opt_state, optimizers
from repro_torch.train import jit_sharded, make_train_step

tmp = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
mesh = make_local_mesh(model=2, device="cpu")
lr, cases = pickle.load(open(os.path.join(tmp, "cases.pkl"), "rb"))
MODS = {"lm": (transformer, "transformer"), "lm_accum": (transformer,
        "transformer"), "moe": (transformer, "transformer"),
        "gnn": (gnn, "gnn"), "recsys": (recsys, "recsys")}


def whole(params):
    # every DTensor parameter gathered whole, in one order on every rank
    for name, p in list(params.named_parameters()):
        if hasattr(p, "full_tensor"):
            owner, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(owner), leaf,
                    torch.nn.Parameter(p.full_tensor()))
    return params


out = {}
for family, (arch_id, cfg_dict, rp, inp, accum) in cases.items():
    if family == "decode":
        continue
    mod, kind = MODS[family]
    arch = get_arch(arch_id)
    cfg_cls = type(arch.smoke())
    tc = cfg_cls(**cfg_dict)
    # the test's optimizer (no_warmup), as the reference runs it
    opt_cfg = dataclasses.replace(arch.opt_config(), warmup_steps=0,
                                  lr=lr)
    if family in ("lm", "lm_accum", "moe"):
        arch = type(arch)(arch_id, tc, accum={"train_4k": accum})
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_4k")
        pspecs, ospecs = arch.param_specs(mesh), arch.opt_specs(mesh)
        bs = arch.batch_specs("train_4k", mesh)
        args = (torch.from_numpy(inp["tokens"]),
                torch.from_numpy(inp["weights"]))
        specs = (bs["tokens"], bs["weights"])
    elif family == "gnn":
        step = make_train_step(lambda p, b, w: gnn.loss_fn(tc, p, b, w),
                               opt_cfg)
        pspecs = shr.gnn_param_specs(mesh, gnn._build(tc, None, "meta"))
        ospecs = OptState(step=shr.P(), m=pspecs, v=pspecs)
        args = (tensor_batch(inp["batch"], "cpu"), None)
        specs = (shr.gnn_batch_specs(mesh, True), None)
    else:
        arch = type(arch)(arch_id, tc)
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_batch")
        pspecs, ospecs = arch.param_specs(mesh), arch.opt_specs(mesh)
        bs = shr.recsys_batch_specs(mesh)
        args = (tensor_batch(inp["batch"], "cpu"),
                torch.from_numpy(inp["weights"]))
        specs = ({k: bs[k] for k in inp["batch"]}, bs["labels"])
    to_port = getattr(convert, f"{kind}_params_from_numpy")
    to_numpy = getattr(convert, f"{kind}_params_to_numpy")
    res = {}
    for form in ("plain", "sharded"):
        params = to_port(tc, rp, "cpu")
        opt = init_opt_state(opt_cfg, params)
        fn = step if form == "plain" else jit_sharded(
            step, mesh, (pspecs, ospecs) + specs)
        params, opt, m = fn(params, opt, *args)
        loss, norm = (x.full_tensor() if hasattr(x, "full_tensor") else x
                      for x in (m["loss"], m["grad_norm"]))
        # the stacked leaves whose moments ZeRO-1 split by layer
        split = [lf.path for lf in module_leaves(params) if lf.stacked
                 and optimizers._layers_split(optimizers._leaf(opt.m, lf))]
        res[form] = (to_numpy(tc, whole(params)), float(loss), float(norm),
                     split)
    out[family] = res
# decode with one KV head: the cache's sequence splits over "model" and
# its batch over "data" (the reference's seq-parallel cache), each slot
# write an index_put_ into both split dimensions
arch_id, cfg_dict, rp, inp, _ = cases["decode"]
tc = transformer.TransformerConfig(**cfg_dict)
arch = type(get_arch(arch_id))(arch_id, tc)
step = arch.step("decode_32k")
B, S = inp["token"].shape[0], inp["slots"]
cache_shape = transformer.cache_spec(tc, B, S)
cspecs = shr.transformer_cache_specs(tc, mesh, cache_shape)
bspec = shr.P(shr.batch_axes(mesh))
res = {}
for form in ("plain", "sharded"):
    params = convert.transformer_params_from_numpy(tc, rp, "cpu")
    cache = transformer.init_cache(tc, B, S, "cpu")
    fn = step if form == "plain" else jit_sharded(
        step, mesh, (arch.param_specs(mesh), cspecs, bspec, bspec),
        donate_argnums=(1,))
    logits = []
    # a serving step runs under inference mode: so is its placement
    with torch.inference_mode():
        for t, p in zip(inp["token"].T, inp["pos"].T):
            lg, cache = fn(params, cache, torch.from_numpy(t.copy()),
                           torch.from_numpy(p.copy()))
            logits.append(lg.full_tensor() if hasattr(lg, "full_tensor")
                          else lg)
        cache = {k: (v.full_tensor() if hasattr(v, "full_tensor") else v)
                 for k, v in cache.items()}
    res[form] = ([x.numpy() for x in logits],
                 {k: v.float().numpy() for k, v in cache.items()})
out["decode"] = res
# the steps' op handlers are in DTensor's table only while a step runs
from torch.distributed.tensor import DTensor
from repro_torch.train.steps import _handlers
table = DTensor._op_dispatcher._custom_op_handlers
out["handlers_left"] = [str(op) for op in _handlers() if op in table]
# a handler called on another thread while a step holds the handlers, as
# a CUDA step's backward runs its views on autograd's device thread
import threading
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.train.steps import _sharding_handlers
x = distribute_tensor(torch.arange(32.0).view(8, 4), mesh,
                      [Shard(0), Replicate()], src_data_rank=None)
got = []
with _sharding_handlers():
    th = threading.Thread(target=lambda: got.append(
        x.view(8, 2, 2).full_tensor()), daemon=True)
    th.start()
    th.join(60)
out["view_on_another_thread"] = bool(got) and bool(torch.equal(
    got[0], torch.arange(32.0).view(8, 2, 2)))
if rank == 0:
    with open(os.path.join(tmp, "out.pkl"), "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
print("{}")
"""


def _flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in _flat(t, path + (i,)).items()}
    return {path: np.asarray(tree)}


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jit_sharded")
    runs, cases = {}, {}
    for family, arch_id in FAMILIES.items():
        rc, rp, inp, runs[family] = _reference(family, arch_id)
        cfg = {k: (np.dtype(v).name if k == "dtype" else v)
               for k, v in dataclasses.asdict(rc).items()}
        cases[family] = (arch_id, cfg, rp, inp, ACCUM.get(family, 1))
    rc = dataclasses.replace(j_get_arch("qwen3-8b").smoke(), n_kv_heads=1)
    rng = np.random.default_rng(5)
    cases["decode"] = ("qwen3-8b", {k: (np.dtype(v).name if k == "dtype"
                                        else v)
                                    for k, v in dataclasses.asdict(rc).items()},
                       jax.tree.map(np.asarray,
                                    JT.init(rc, jax.random.PRNGKey(1))),
                       {"token": rng.integers(0, rc.vocab, (4, 3)).astype(
                           np.int32),
                        "pos": np.array([[0, 1, 2], [5, 6, 7], [0, 3, 9],
                                         [11, 12, 13]], np.int32),
                        "slots": 16}, 1)
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump((LR, cases), f)
    # the ranks run while this process compiles and runs the reference
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, WORKER, tmp, 4)
        refs = {family: run() for family, run in runs.items()}
        ranks.result()
    with open(tmp / "out.pkl", "rb") as f:
        port = pickle.load(f)
    return refs, port, {f: _flat(c[2]) for f, c in cases.items()}


def mismatches(after: dict, want: dict) -> dict:
    """{leaf: its distance} for each leaf after the step further from
    ``want``'s than TOL of the whole tree's largest |value|."""
    scale = max(np.abs(w).max() for w in want.values())
    dist = {k: np.abs(after[k] - w).max() / scale for k, w in want.items()}
    return {k: d for k, d in dist.items() if not d <= TOL}


@pytest.mark.parametrize("family", FAMILIES)
def test_sharded_step_equals_plain_and_reference(steps, family):
    refs, port, befores = steps
    want, want_loss, want_norm = refs[family]
    sharded, s_loss, s_norm, _ = port[family]["sharded"]
    plain, p_loss, p_norm, _ = port[family]["plain"]
    for other in (p_loss, want_loss):
        assert abs(s_loss - other) <= TOL * abs(other), (s_loss, other)
    for other in (p_norm, want_norm):
        assert abs(s_norm - other) <= TOL * other, (s_norm, other)
    want, sharded, plain = _flat(want), _flat(sharded), _flat(plain)
    assert sharded.keys() == want.keys() == plain.keys()
    for other in (plain, want):
        assert mismatches(sharded, other) == {}


@pytest.mark.parametrize("family", ["lm", "moe"])
@pytest.mark.parametrize("plant", ["no-op", "halved", "reversed"])
def test_parameter_check_sees_a_wrong_update(steps, family, plant):
    """The check above on the sharded step's result with one planted
    fault in the update of a leaf whose moments ZeRO-1 split by layer
    (the path that updates such a leaf whole and gathers its layers):
    the leaf is reported, and no other."""
    refs, port, befores = steps
    sharded, _, _, split = port[family]["sharded"]
    assert split, "no leaf of the sharded step is split by layer"
    key = tuple(split[0])
    want, sharded, before = _flat(refs[family][0]), _flat(sharded), \
        befores[family]
    assert key in want
    upd = sharded[key] - before[key]
    sharded[key] = before[key] + {"no-op": 0 * upd, "halved": upd / 2,
                                  "reversed": -upd}[plant]
    assert list(mismatches(sharded, want)) == [key]


def test_sharded_decode_equals_plain(steps):
    """Three decode steps of a one-KV-head smoke config, its cache split
    by batch over "data" and by sequence over "model": logits and the
    whole cache within 1e-5 of their max |value| of the plain steps'."""
    _, port, _ = steps
    (p_logits, p_cache), (s_logits, s_cache) = (port["decode"]["plain"],
                                                port["decode"]["sharded"])
    for a, b in zip(s_logits, p_logits):
        assert np.abs(a - b).max() <= TOL * np.abs(b).max()
    assert s_cache.keys() == p_cache.keys()
    for k, b in p_cache.items():
        assert np.abs(s_cache[k] - b).max() <= TOL * max(np.abs(b).max(),
                                                         1.0), k


def test_handlers_are_removed_after_the_steps(steps):
    _, port, _ = steps
    assert port["handlers_left"] == []


def test_handlers_run_on_another_thread_during_a_step(steps):
    """A view through the handlers on a second thread while the first
    holds them for a step: it runs, and is right (a lock held for the
    whole step would stop it, and a CUDA step's backward with it)."""
    _, port, _ = steps
    assert port["view_on_another_thread"] is True


# the torch versions whose private DTensor parts (below) the port's
# sharding was run against: 2.13 by these tests, 2.11 by the card's mesh
# check; another fails here, to be checked again
CHECKED_TORCH = ("2.11", "2.13")


def test_private_dtensor_parts_are_the_checked_ones():
    """``jit_sharded``, the dry run and the analysis reach into DTensor's
    private parts: its dispatcher's table of op handlers
    (``train.steps._sharding_handlers``), its view rule
    (``_view_placements``), ``_StridedShard.local_shard_size_and_offset``
    (``launch.dryrun``), ``ShardingPropagator._fake_mode_lock`` and
    ``placement_types.shard_dim_alltoall`` (``launch.analysis``). This
    pins the torch versions they were checked against and the forms the
    port relies on."""
    import inspect

    import torch
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._ops._view_ops import (
        propagate_shape_and_sharding, view_groups)
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard
    assert torch.__version__.split("+")[0].rsplit(".", 1)[0] in \
        CHECKED_TORCH, torch.__version__
    assert isinstance(DTensor._op_dispatcher._custom_op_handlers, dict)
    assert list(inspect.signature(propagate_shape_and_sharding).parameters
                ) == ["input_src_placements", "global_input_shape", "rule",
                      "mesh_sizes", "strict_view"]
    assert list(inspect.signature(view_groups).parameters) == [
        "from_size", "to_size"]
    assert callable(_StridedShard.local_shard_size_and_offset)
    assert hasattr(ShardingPropagator, "_fake_mode_lock")
    from torch.distributed.tensor import placement_types
    assert list(inspect.signature(placement_types.shard_dim_alltoall)
                .parameters) == ["input", "gather_dim", "shard_dim", "mesh",
                                 "mesh_dim"]
