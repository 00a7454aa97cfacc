"""``repro_torch.train.jit_sharded``: one train step of each model family's
smoke config placed on a (2, 2) ("data", "model") mesh of four gloo ranks,
against the unsharded port step and against ``repro``'s step.

The families (``repro_torch.launch.meshcheck``, which runs the same
steps port against port where there is no JAX): a dense LM (qwen3-8b:
vocab, heads and FFN over "model", ZeRO-1 moments over "data"), a mixture
of experts (mixtral-8x7b, its four smoke experts' FFN split over "model",
the sort dispatch's scatters), deepseek-v2-236b's MLA, shared experts and
dense first layer with 8 routed experts split over "model" and routed in
groups of 20 (4 groups on each "data" rank; pairs drop), the GNN
(MeshGraphNet, its graph split over ("data", "model") as the ogb_products
cell splits it) and a recsys ranker (DLRM-RM2, its tables' rows over
"model"); the dense LM again in 2 microbatches, each rank holding one
row of each; and decode steps with the reference's sequence-parallel
cache; and the dense LM with one KV head for its four query heads,
whose attention regroups its queries under "model" 2. No index op,
slice or select of any step reaches DTensor's own dispatch: the port
places them itself, and RoPE and the slice handlers equal the plain ops
on a split DTensor. Each rank runs as a process
of its own; the reference runs in
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
from repro.models import layers as JL
from repro.models import recsys as JR
from repro.models import transformer as JT
from repro.optim import init_opt_state as j_init_opt
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.launch import meshcheck
from repro_torch.launch.meshcheck import LR, TOL, flat as _flat, mismatches
from test_torch_sharded import run_ranks

FAMILIES = {f: arch_id for f, (arch_id, _) in meshcheck.FAMILIES.items()}
# RoPE's input in the handler checks: (B, S, H, D), D split over "model"
ROPE_X = np.random.default_rng(3).standard_normal((2, 6, 3, 8)).astype(
    np.float32)
# "lm_accum": the LM step in 2 microbatches; its batch of 4 rows is split
# over "data" 2, so each rank holds one row of each microbatch
ACCUM = {f: a for f, (_, a) in meshcheck.FAMILIES.items() if a > 1}
LM_FAMILIES = ("lm", "lm_accum", "lm_gqa", "moe", "moe_grouped")


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


def _reference(family: str, arch_id: str):
    """(ref cfg, params before, inputs, and a function that runs the
    reference's step on them -> (params after, loss, grad norm))."""
    jarch = j_get_arch(arch_id)
    rc = jarch.smoke()
    if family == "lm_gqa":
        rc = dataclasses.replace(rc, n_kv_heads=1)
    if family == "moe_grouped":
        tc = meshcheck.smoke_config(family)
        rc = dataclasses.replace(rc, n_experts=tc.n_experts,
                                 moe_group_size=tc.moe_group_size)
    opt_cfg = no_warmup(jarch.opt_config())
    if family in LM_FAMILIES:
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
    inp = meshcheck.family_inputs(family, rc)

    def run():
        opt = j_init_opt(opt_cfg, rp)
        args = [jax.tree.map(jnp.asarray, v) for v in inp.values()]
        new, _, m = jax.jit(step)(rp, opt, *args)
        return (jax.tree.map(np.asarray, new), float(m["loss"]),
                float(m["grad_norm"]))

    return rc, jax.tree.map(np.asarray, rp), inp, run


WORKER = """
import os, pickle, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch import meshcheck
from repro_torch.launch.mesh import make_local_mesh

tmp = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
mesh = make_local_mesh(model=2, device="cpu")
lr, cases, ROPE_X = pickle.load(open(os.path.join(tmp, "cases.pkl"),
                                   "rb"))
# every family and the decode steps (one KV head: the cache's sequence
# splits over "model" and its batch over "data", the reference's
# seq-parallel cache, each slot write an index_put_ into both split
# dimensions); the index ops passed on to DTensor's dispatch, counted
out = meshcheck.run_cases(mesh, cases, lr)
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
# RoPE on a head_dim split over "model" (each rank whole pairs), and the
# slice / select handlers, each against the plain op on the same values,
# with the collectives each issued
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.models.layers import apply_rope
from repro_torch.train.steps import _replicate_plain_tensors
aten = torch.ops.aten


def run(fn, *ts):
    with _sharding_handlers(), _replicate_plain_tensors(), \
            CommDebugMode() as comm:
        y = fn(*ts)
    return {"placements": [str(p) for p in y.placements],
            "collectives": comm.get_total_counts(),
            "value": y.full_tensor().numpy()}


x = torch.from_numpy(ROPE_X)
pos = torch.arange(x.shape[1], dtype=torch.int32).expand(x.shape[:2])
out["rope"] = run(lambda t: apply_rope(t, pos, 1e4), distribute_tensor(
    x, mesh, [Shard(0), Shard(3)], src_data_rank=None))
g = torch.arange(64.0).view(8, 8)
slices = {"unsplit": ([Shard(0), Replicate()], lambda t: t[:, 1:6]),
          "aligned_even": ([Shard(0), Shard(1)], lambda t: t[:, 0::2]),
          "aligned_odd": ([Shard(0), Shard(1)], lambda t: t[:, 1::2]),
          "unaligned": ([Shard(0), Shard(1)], lambda t: t[:, 1:6]),
          "select_unsplit": ([Shard(1), Replicate()], lambda t: t[3]),
          "select_split": ([Shard(0), Shard(1)], lambda t: t[:, 5]),
          "backward_aligned": ([Shard(0), Shard(1)], lambda t:
                               aten.slice_backward(t, [8, 16], 1, 1, 16, 2)),
          "backward_unsplit": ([Shard(1), Replicate()], lambda t:
                               aten.slice_backward(t, [12, 8], 0, 2, 10, 1)),
          "select_backward": ([Shard(0), Shard(1)], lambda t:
                              aten.select_backward(t, [8, 3, 8], 1, 2))}
out["slices"] = {}
for name, (pls, fn) in slices.items():
    out["slices"][name] = run(fn, distribute_tensor(g, mesh, pls,
                                                    src_data_rank=None))
    out["slices"][name]["plain"] = fn(g).numpy()
# elementwise ops on partial sums over "data" (each rank's part a
# function of its "data" coordinate c), against the plain op on the
# reduced values
from torch.distributed.tensor import Partial
c = mesh.get_coordinate()[0]
base = torch.arange(8.0).view(2, 4) - 3.0
part_a, part_b = base * (c + 1) + c, base.flip(1) * (2 - c) - c
want_a = {"sum": sum(base * (k + 1) + k for k in (0, 1)),
          "max": torch.maximum(base, base * 2 + 1)}
want_b = {"sum": sum(base.flip(1) * (2 - k) - k for k in (0, 1)),
          "max": torch.maximum(base.flip(1) * 2, base.flip(1) - 1)}


def partial(local, kind):
    return DTensor.from_local(local.clone(), mesh,
                              [Partial(kind), Replicate()], run_check=False)


pointwise = {
    "sum_plus_number": ("sum", lambda a, b: a + 1.5,
                        lambda a, b: a + 1.5),
    "sum_minus_number": ("sum", lambda a, b: a - 2, lambda a, b: a - 2),
    "sum_add_number_in_place": ("sum", lambda a, b: a.add_(1.5),
                                lambda a, b: a + 1.5),
    "sum_plus_sum": ("sum", lambda a, b: a + b, lambda a, b: a + b),
    "sum_times_number": ("sum", lambda a, b: a * 3.0, lambda a, b: a * 3.0),
    "max_plus_max": ("max", lambda a, b: a + b, lambda a, b: a + b),
    "max_plus_number": ("max", lambda a, b: a + 1.5, lambda a, b: a + 1.5)}
out["pointwise"] = {}
for name, (kind, fn, plain) in pointwise.items():
    r = run(fn, partial(part_a, kind), partial(part_b, kind))
    r["plain"] = plain(want_a[kind], want_b[kind]).numpy()
    out["pointwise"][name] = r
if rank == 0:
    with open(os.path.join(tmp, "out.pkl"), "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
print("{}")
"""


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("jit_sharded")
    runs, cases = {}, {}
    for family, arch_id in FAMILIES.items():
        rc, rp, inp, runs[family] = _reference(family, arch_id)
        cases[family] = (arch_id, meshcheck.config_dict(rc), rp, inp,
                         ACCUM.get(family, 1))
    rc = dataclasses.replace(j_get_arch("qwen3-8b").smoke(), n_kv_heads=1)
    cases["decode"] = meshcheck.decode_case(
        jax.tree.map(np.asarray, JT.init(rc, jax.random.PRNGKey(1))))
    with open(tmp / "cases.pkl", "wb") as f:
        pickle.dump((LR, cases, ROPE_X), f)
    # the ranks run while this process compiles and runs the reference
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, WORKER, tmp, 4)
        refs = {family: run() for family, run in runs.items()}
        ranks.result()
    with open(tmp / "out.pkl", "rb") as f:
        port = pickle.load(f)
    return refs, port, {f: _flat(c[2]) for f, c in cases.items()}


def test_no_index_op_reaches_dtensor_dispatch(steps):
    """Every index op, slice and select of every family's step and of
    the decode steps ran through the port's own handlers: none was passed
    on to DTensor's per-version strategy."""
    _, port, _ = steps
    assert port["unhandled"] == {}


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


def test_rope_keeps_a_head_dim_split(steps):
    """``apply_rope`` of a (B, S, H, D) DTensor whose D is split over
    "model" (whole pairs on each rank): its result keeps the split, no
    collective runs, and it equals ``repro.models.layers.apply_rope`` of
    the same values."""
    _, port, _ = steps
    r = port["rope"]
    assert r["placements"] == ["S(0)", "S(3)"]
    assert r["collectives"] == 0
    pos = np.broadcast_to(np.arange(ROPE_X.shape[1], dtype=np.int32),
                          ROPE_X.shape[:2])
    want = np.asarray(JL.apply_rope(jnp.asarray(ROPE_X), jnp.asarray(pos),
                                    1e4))
    np.testing.assert_allclose(r["value"], want, rtol=1e-6, atol=1e-6)


# the slices whose split each rank keeps (or that cut no split dimension),
# which move nothing
LOCAL_SLICES = ("unsplit", "aligned_even", "aligned_odd", "select_unsplit",
                "backward_aligned", "backward_unsplit", "select_backward")


@pytest.mark.parametrize("name", ["unsplit", "aligned_even", "aligned_odd",
                                  "unaligned", "select_unsplit",
                                  "select_split", "backward_aligned",
                                  "backward_unsplit", "select_backward"])
def test_slice_handlers_equal_the_plain_op(steps, name):
    """The port's ``aten.slice`` / ``slice_backward`` / ``select`` /
    ``select_backward`` on (8, 8) DTensors over the (2, 2) gloo mesh:
    the plain op's values; no collective where the slice keeps each
    rank's split (the even or odd lanes of a split dimension whose parts
    hold whole pairs) or cuts no split dimension; a split the slice
    cannot keep is moved or gathered first."""
    _, port, _ = steps
    r = port["slices"][name]
    np.testing.assert_array_equal(r["value"], r["plain"])
    if name in LOCAL_SLICES:
        assert r["collectives"] == 0, r
    else:
        assert r["collectives"] > 0, r


@pytest.mark.parametrize("name", ["sum_plus_number", "sum_minus_number",
                                  "sum_add_number_in_place", "sum_plus_sum",
                                  "sum_times_number", "max_plus_max",
                                  "max_plus_number"])
def test_pointwise_on_partial_sums_equals_the_plain_op(steps, name):
    """The port's elementwise handler on (2, 4) DTensors that are partial
    sums (or maxima) over "data" of the (2, 2) gloo mesh: the plain op's
    values on the reduced tensors. A number added to a partial sum is
    added once, not once a rank (in place: by the first rank alone, the
    sum kept); two partial sums add as one, with no collective; two
    partial maxima are reduced before they add."""
    _, port, _ = steps
    r = port["pointwise"][name]
    np.testing.assert_array_equal(r["value"], r["plain"])
    if name in ("sum_add_number_in_place", "sum_plus_sum",
                "sum_times_number", "max_plus_number"):
        assert r["collectives"] == 0, r
        assert r["placements"][0].startswith("P"), r


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
    (``launch.dryrun``), ``ShardingPropagator._propagate_tensor_meta_non_cached``
    and ``placement_types.shard_dim_alltoall`` (``launch.analysis``); the
    index and einsum handlers read a DTensor's ``_local_tensor`` and
    build their results with ``DTensor.from_local(..., shape=,
    stride=)``; the analysis counts a composite op that inference mode
    hands over whole by its decomposition (``OpOverload.decompose``,
    ``torch._C._dispatch_has_kernel_for_dispatch_key``) and leaves out
    the propagation through a decomposition
    (``DecompShardingStrategy.propagate_strategy``: a static method of
    (op_schema, sharding_prop) in torch 2.11, a method in 2.13). This
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
    assert list(inspect.signature(
        ShardingPropagator._propagate_tensor_meta_non_cached).parameters
                ) == ["self", "op_schema"]
    from torch.distributed.tensor import placement_types
    assert list(inspect.signature(placement_types.shard_dim_alltoall)
                .parameters) == ["input", "gather_dim", "shard_dim", "mesh",
                                 "mesh_dim"]
    assert {"shape", "stride", "run_check"} <= set(
        inspect.signature(DTensor.from_local).parameters)
    assert "_local_tensor" in DTensor.__slots__ or hasattr(
        DTensor, "_local_tensor")
    assert torch._C._dispatch_has_kernel_for_dispatch_key(
        "aten::matmul", torch._C.DispatchKey.CompositeImplicitAutograd)
    assert callable(torch.ops.aten.matmul.default.decompose)
    from torch.distributed.tensor._decompositions import \
        DecompShardingStrategy
    assert list(inspect.signature(
        DecompShardingStrategy.propagate_strategy).parameters) in (
            ["op_schema", "sharding_prop"], ["self", "op_schema"])
