"""Multi-pod dry run of the port: every (arch x shape x mesh) cell placed
on the production meshes and its step run once on fake tensors, per
device — the counterpart of ``repro.launch.dryrun``, which lowers and
compiles each cell for 256 or 512 forced host devices.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b \\
        --shape train_4k --mesh single --out experiments/dryrun_torch.json

The 256- or 512-rank world is a fake process group (``"fake"`` over a
``FakeStore``: this process is rank 0, every collective returns at once),
brought up here, in the dry run's own process, never at import — the
counterpart of the reference's ``XLA_FLAGS`` line. Parameters, optimizer
state and inputs are fake tensors (``FakeTensorMode``: shapes, no memory)
placed by the registry's specs through ``train.jit_sharded``; the step
runs once under ``launch.analysis.analyze_step``. Per cell the record
keeps the reference's keys — cost, memory, collective bytes and counts,
``n_chips``, ``mesh_shape``, ``dims`` — with ``trace_s`` (the placed
step's run on fake tensors) where the reference has ``lower_s`` and
``compile_s``. Results merge into ``--out`` by (arch, shape, mesh), so
cells resume; cells with a ``skip`` reason are skipped by rule. The exit
code is 1 when any cell failed.

The mesh and the fake tensors are on the CPU on any host: fake tensors
hold no data, and bytes and flops do not depend on the device. A
redistribution from one split dimension to another counts as the one
all-to-all of its local result that the card runs, though on a CPU mesh
DTensor runs it as an all-gather and a chunk (``analyze_step``); the
port's own ``all_to_all_single`` calls (the dedup dispatch, the
microbatches of an accumulating step) count as all-to-alls. Fake tensors
hold no data for a kernel launch, so the dedup cell runs its kernels'
plain forms; the record says so. ``trace_cell`` traces one cell of any
arch on a mesh that is up; ``launch.hillclimb`` traces mutated archs
through it.

An LM cell is counted a layer at a time (``depth_count``), as the
reference's analysis counts a scanned loop's body once times its trip
count: traced at two depths, each additive term extrapolated to the full
depth, the record keeping ``"counted_at_depths"`` and ``"extrapolated"``;
``--full-depth`` traces every layer instead.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Callable

import torch
from torch import nn

from ..configs import all_arch_ids, get_arch
from ..launch.analysis import analyze_step
from ..launch.mesh import make_production_mesh, production_axes
from ..optim import init_opt_state
from ..train.steps import jit_sharded


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (this process rank 0) for the
    duration; any group already up is left alone and must be that
    size."""
    import torch.distributed as dist
    if dist.is_initialized():
        if dist.get_world_size() != n:
            raise RuntimeError(f"a process group of {dist.get_world_size()}"
                               f" ranks is up, the mesh needs {n}")
        yield
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def _strided_offsets_on_host():
    """DTensor works out the offsets of a ``_StridedShard`` (a split
    dimension flattened with another, as an einsum flattens the heads
    into its contraction) with ``torch.arange`` and ``tolist``; under the
    dry run's ``FakeTensorMode`` those would be fake tensors that cannot
    be read back. For the dry run's duration they are real ones."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor.placement_types import _StridedShard
    orig = _StridedShard.local_shard_size_and_offset

    def on_host(*args, **kwargs):
        with unset_fake_temporarily():
            return orig(*args, **kwargs)

    _StridedShard.local_shard_size_and_offset = on_host
    try:
        yield
    finally:
        _StridedShard.local_shard_size_and_offset = orig


def _fake_params(shape_tree: nn.Module, device) -> nn.Module:
    """The ``meta`` param tree with every parameter a fake tensor on
    ``device`` (inside ``FakeTensorMode``)."""
    for name, p in list(shape_tree.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        setattr(shape_tree.get_submodule(owner), leaf, nn.Parameter(
            torch.empty(p.shape, dtype=p.dtype, device=device)))
    return shape_tree


def _fake_inputs(tree, device):
    if isinstance(tree, dict):
        return {k: _fake_inputs(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _n_chips(multi_pod: bool) -> int:
    return math.prod(production_axes(multi_pod).shape.values())


def _summary(rec: dict) -> None:
    mem = rec["memory"]
    print(f"[dryrun] {rec['arch']}/{rec['shape']}/{rec['mesh']}: "
          f"trace={rec['trace_s']:.1f}s flops={rec['cost']['flops']:.3e} "
          f"bytes={rec['cost']['bytes_accessed']:.3e} "
          f"coll={rec['collectives_bytes'].get('total', 0):.3e}B")
    print(f"[dryrun]   memory: {mem}")


def _trace_once(arch, shape: str, mesh, fsdp=None, update_fn=None) -> dict:
    """``arch``'s cell traced at its own depth (see ``trace_cell``). An
    LM cell's ``fsdp`` (None: the arch's own choice) goes to its param
    and optimizer specs, a train step's ``update_fn`` to its step
    (``make_train_step``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cell = arch.shapes[shape]
    dev = "cpu"
    if arch.family == "gnn":
        shape_tree = arch.params_shape(shape)
        pspecs = arch.param_specs(mesh, shape)
        ospecs = arch.opt_specs(mesh, shape)
    elif fsdp is not None:
        shape_tree = arch.params_shape()
        pspecs = arch.param_specs(mesh, fsdp)
        ospecs = arch.opt_specs(mesh, fsdp)
    else:
        shape_tree = arch.params_shape()
        pspecs = arch.param_specs(mesh)
        ospecs = arch.opt_specs(mesh)
    bspecs = arch.batch_specs(shape, mesh)
    # the optimizer's step counter is a host scalar that the update reads
    # back (its schedule), not device state: a real tensor
    step0 = torch.zeros((), dtype=torch.int32)
    t0 = time.perf_counter()
    with _strided_offsets_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_params(shape_tree, dev)
        inputs = _fake_inputs(arch.input_specs(shape), dev)
        step = arch.step(shape) if update_fn is None else \
            arch.step(shape, update_fn=update_fn)
        if cell.kind == "train":
            opt = init_opt_state(arch.opt_config(), params)
            opt = opt._replace(step=step0)
            args = (params, opt, *inputs.values())
            specs = (pspecs, ospecs, *(bspecs[k] for k in inputs))
            donate = (0, 1)
        else:
            args = (params, *inputs.values())
            specs = (pspecs, *(bspecs[k] for k in inputs))
            donate = (1,) if cell.kind == "decode" else ()
        fn = jit_sharded(step, mesh, specs, donate_argnums=donate)
        # the serving steps run under inference mode: their arguments are
        # placed as inference tensors, as they would be served
        with torch.inference_mode(cell.kind != "train"):
            placed = fn.place(*args)
        t_place = time.perf_counter() - t0
        rec = analyze_step(fn.placed, placed)
    rec.pop("outputs")
    rec["trace_s"] = round(rec.pop("run_s"), 2)
    rec["place_s"] = round(t_place, 2)
    return rec


def trace_cell(arch, shape: str, mesh, full_depth: bool = False) -> dict:
    """One cell of ``arch`` (an ``LMArch``, ``GNNArch`` or ``RecsysArch``)
    placed on ``mesh`` (over a process group that is up) and its step run
    once on fake tensors under ``analyze_step`` — the counterpart of the
    reference's ``hillclimb.lower_lm_cell``. -> the analysis record with
    ``trace_s`` and ``place_s``.

    An LM cell deeper than two layers past its dense first ones is
    counted a layer at a time (``depth_count``), as the reference's
    analysis counts its scanned layers once times their trip count;
    ``full_depth`` traces every layer instead."""
    if arch.family == "lm" and not full_depth and \
            arch.cfg.n_layers > arch.cfg.first_dense_layers + 2:
        return depth_count(arch, shape, mesh)
    return _trace_once(arch, shape, mesh)


# ------------------------------------------------- the per-layer count --- //

# the terms of a record that add up over a step's ops (and the memory
# terms, which the count extrapolates alike)
ADDITIVE = (("cost", "flops"), ("cost", "bytes_accessed"),
            ("cost", "bytes_by_op"), ("cost", "flops_by_op"),
            ("collectives_bytes",), ("collectives_by_op",),
            ("collectives_counts",))
MEMORY = ("argument_size_in_bytes", "output_size_in_bytes",
          "alias_size_in_bytes", "temp_size_in_bytes")


def _combine(a, b, fn):
    """``fn`` over two values or two trees of dicts of them (a missing
    key is 0)."""
    if isinstance(a, dict) or isinstance(b, dict):
        a, b = a or {}, b or {}
        return {k: _combine(a.get(k, 0), b.get(k, 0), fn)
                for k in sorted(set(a) | set(b))}
    return fn(a, b)


def _get(rec, path):
    for k in path:
        rec = rec.get(k, {})
    return rec


def _put(rec, path, value):
    for k in path[:-1]:
        rec = rec.setdefault(k, {})
    rec[path[-1]] = value


def at_depth(arch, n_layers: int):
    """A copy of ``arch`` whose config has ``n_layers`` layers and that is
    otherwise the same cell: its shapes, optimizer and step."""
    cut = copy.copy(arch)
    cut.cfg = dataclasses.replace(arch.cfg, n_layers=n_layers)
    cut.shapes = dict(arch.shapes)
    return cut


def _grads_taken(grads: dict) -> Callable:
    """A train step's update that is not run: it hands the step's
    gradients to ``grads`` by parameter name and keeps the params and
    state (``make_train_step``'s ``update_fn``)."""
    def update_fn(opt_cfg, params, g, opt_state):
        grads.clear()
        grads.update(g)
        return params, opt_state, {}
    return update_fn


def _full_depth_grads(arch, grads: dict, n_cut: int, dev: str) -> dict:
    """Fake gradients of every parameter of ``arch`` at its full depth,
    each placed as the cut step placed its own: a scanned layer's as the
    last scanned layer of the cut model (layers 1 on, the steady state);
    dense first layers and the rest by name."""
    from torch.distributed.tensor import DTensor
    last = n_cut - arch.cfg.first_dense_layers - 1
    out = {}
    for name, p in arch.params_shape().named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            parts[1] = str(min(int(parts[1]), last))
        g = grads[".".join(parts)]
        # laid out as autograd left it (a gradient may be a strided view)
        local = torch.empty_strided(g._local_tensor.shape,
                                    g._local_tensor.stride(), dtype=g.dtype,
                                    device=dev)
        out[name] = DTensor.from_local(
            local, g.device_mesh, g.placements, run_check=False,
            shape=p.shape, stride=g.stride())
    return out


def _update_trace(arch, mesh, grads: dict, n_cut: int) -> dict:
    """The optimizer update of ``arch``'s train step alone at full depth
    (``train.steps.apply_updates`` through ``jit_sharded``), on fake
    params and state placed as the cell places them and fake gradients
    placed as the cut step left them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..train import steps
    opt_cfg = arch.opt_config()
    step0 = torch.zeros((), dtype=torch.int32)
    with _strided_offsets_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_params(arch.params_shape(), "cpu")
        opt = init_opt_state(opt_cfg, params)._replace(step=step0)
        g = _full_depth_grads(arch, grads, n_cut, "cpu")
        fn = jit_sharded(
            lambda p, o, gr: steps.apply_updates(opt_cfg, p, gr, o), mesh,
            (arch.param_specs(mesh), arch.opt_specs(mesh), None))
        rec = analyze_step(fn.placed, fn.place(params, opt, g))
    rec.pop("outputs")
    rec["grad_bytes"] = sum(t._local_tensor.numel() * t.element_size()
                            for t in g.values())
    return rec


def depth_count(arch, shape: str, mesh) -> dict:
    """An LM cell counted a layer at a time, as the reference's analysis
    counts its scan (``loop_aware_analysis``: the loop body once, times
    its trip count). The cell is traced at d1 = dense + 1 and d2 = dense
    + 2 layers, at full width on the same mesh and specs, and each
    additive term (flops and bytes by op, collective bytes and counts by
    kind and by op, argument, output and alias bytes) is reported at the
    full depth L as c(d1) + (L - d1)(c(d2) - c(d1)); temp likewise. A
    train step's optimizer update, which runs once over every layer
    outside the reference's scan, is left out of both traces and traced
    alone at full depth (its ZeRO-1 state may split the layers' axis
    only at full depth); its terms are added, and the step's temp is the
    larger of the layers' and the update's (the gradients held plus the
    update's own). A serving step keeps nothing of a layer past the
    next, so its temp is the deeper trace's: the steady layer's peak. A
    config whose specs for a layer or for the inputs differ with the
    depth is refused: its layers are not alike (a stacked leaf's spec
    and a decode cache's hold the leading L axis whole, so they are one
    layer's whatever the depth where the layers are alike). The cut
    cells take the full-depth model's choice of FSDP specs (a big
    model's: the cut one has fewer params)."""
    cfg = arch.cfg
    fd, L = cfg.first_dense_layers, cfg.n_layers
    d1, d2 = fd + 1, fd + 2
    cuts = {d: at_depth(arch, d) for d in (d1, d2)}
    pspecs = arch.param_specs(mesh)
    fsdp = pspecs == arch.param_specs(mesh, fsdp=True)
    full = (pspecs, arch.batch_specs(shape, mesh))
    for d, cut in cuts.items():
        if (cut.param_specs(mesh, fsdp),
                cut.batch_specs(shape, mesh)) != full:
            raise ValueError(
                f"{cfg.name}/{shape}: the specs of a layer or of the "
                f"inputs at {d} layers differ from those at {L}; its "
                f"layers are not alike, so it is not counted per layer "
                f"(use full_depth)")
    train = arch.shapes[shape].kind == "train"
    recs, grads = {}, {}
    for d, cut in cuts.items():
        recs[d] = _trace_once(cut, shape, mesh, fsdp,
                              _grads_taken(grads) if train else None)
    a, b, k = recs[d1], recs[d2], L - d1

    def line(x, y):
        return x + k * (y - x)

    rec = {}
    for path in ADDITIVE:
        _put(rec, path, _combine(_get(a, path), _get(b, path), line))
    rec["memory"] = {m: line(a["memory"][m], b["memory"][m])
                     for m in MEMORY}
    if not train:
        # a serving step keeps nothing of a layer past the next: its peak
        # is the steady layer's, which the deeper trace holds (the first
        # layer's input is the embedding's, placed otherwise)
        rec["memory"]["temp_size_in_bytes"] = b["memory"][
            "temp_size_in_bytes"]
    rec["trace_s"] = round(a["trace_s"] + b["trace_s"], 2)
    rec["place_s"] = round(a["place_s"] + b["place_s"], 2)
    rec["counted_at_depths"] = [d1, d2]
    rec["depth_traces"] = {str(d): {
        "flops": r["cost"]["flops"],
        "temp_size_in_bytes": r["memory"]["temp_size_in_bytes"],
        "collectives_bytes": r["collectives_bytes"].get("total", 0),
        "trace_s": r["trace_s"]} for d, r in recs.items()}
    if train:
        upd = _update_trace(arch, mesh, grads, d2)
        for path in ADDITIVE:
            _put(rec, path, _combine(_get(rec, path), _get(upd, path),
                                     lambda x, y: x + y))
        mem, um = rec["memory"], upd["memory"]
        # the step's outputs: the layers' own (the loss), then the
        # update's (params and moments, aliases of the step's arguments;
        # the new step counter and the metrics)
        mem["output_size_in_bytes"] += um["output_size_in_bytes"] - \
            mem["alias_size_in_bytes"]
        mem["alias_size_in_bytes"] = um["alias_size_in_bytes"]
        mem["temp_size_in_bytes"] = max(
            mem["temp_size_in_bytes"],
            upd["grad_bytes"] + um["temp_size_in_bytes"])
        rec["update_traced_at_depth"] = L
        rec["trace_s"] = round(rec["trace_s"] + upd["run_s"], 2)
    rec["extrapolated"] = ["cost", "collectives_bytes", "collectives_by_op",
                           "collectives_counts", "memory"]
    return rec


def dryrun_cell(arch_id: str, shape: str, multi_pod: bool,
                full_depth: bool = False) -> dict:
    arch = get_arch(arch_id)
    cell = arch.shapes[shape]
    rec = {"arch": arch_id, "shape": shape, "kind": cell.kind,
           "mesh": "multi" if multi_pod else "single",
           "dims": dict(cell.dims)}
    if cell.skip:
        rec["skipped"] = cell.skip
        return rec
    with fake_world(_n_chips(multi_pod)):
        mesh = make_production_mesh(multi_pod, device="cpu")
        rec["mesh_shape"] = dict(production_axes(multi_pod).shape)
        rec.update(trace_cell(arch, shape, mesh, full_depth))
    rec["n_chips"] = _n_chips(multi_pod)
    _summary(rec)
    return rec


def dedup_dryrun(multi_pod: bool, batch: int = 1 << 20,
                 memory_mb: int = 512, packed: bool = False,
                 capacity_factor: float = 2.0) -> dict:
    """The paper's technique on the production mesh: the sharded-filter
    dedup service (static routing, the ``all_to_all_single`` dispatch),
    one rank's step of a global batch over every rank of the mesh.
    ``packed`` and ``capacity_factor`` reach the configs as the
    reference's ``hillclimb.dedup_variant`` passes them."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..core import DedupConfig
    from ..dedup import ShardedDedup, ShardedDedupConfig
    n = _n_chips(multi_pod)
    axes = production_axes(multi_pod)
    cfg = DedupConfig.for_variant(
        "rlbsbf", memory_bits=memory_mb * 8 * 1024 * 1024, packed=packed)
    dev = "cpu"
    with fake_world(n), _strided_offsets_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        sd = ShardedDedup(ShardedDedupConfig(
            base=cfg, capacity_factor=capacity_factor), device=dev)
        local_batch = batch // sd.n_shards
        state = sd.init()
        keys = torch.empty((local_batch,), dtype=torch.int32, device=dev)
        res = analyze_step(sd.local_step(local_batch), (state, keys))
    res.pop("outputs")
    rec = {"arch": "dedup-stream", "shape": f"ingest_{batch}",
           "kind": "dedup", "mesh": "multi" if multi_pod else "single",
           "dims": {"batch": batch, "memory_mb": memory_mb,
                    "packed": packed, "capacity_factor": capacity_factor,
                    "per_shard_bits": sd.local_cfg.s * sd.local_cfg.k},
           "mesh_shape": dict(axes.shape), "n_chips": n,
           "kernels": "plain forms (fake tensors hold no data to launch "
                      "on)"}
    rec.update(res)
    rec["trace_s"] = round(rec.pop("run_s"), 2)
    _summary(rec)
    return rec


def _port_frames(exc: BaseException) -> list:
    """The frames of this package in an exception's traceback, innermost
    last: where in the port the op that failed was called."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [f"{os.path.relpath(fr.filename, root)}:{fr.lineno} {fr.name}"
            for fr in traceback.extract_tb(exc.__traceback__)
            if fr.filename.startswith(root)][-6:]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="arch id, 'all', or 'dedup-stream'")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--full-depth", action="store_true",
                    help="trace every layer of an LM cell, not two "
                         "depths (the per-layer count)")
    args = ap.parse_args(argv)

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results
            if "error" not in r}

    def run(aid, shape, mp):
        key = (aid, shape, "multi" if mp else "single")
        if key in done:
            print(f"[dryrun] skip cached {key}")
            return
        try:
            if aid == "dedup-stream":
                rec = dedup_dryrun(mp)
                key = (aid, rec["shape"], key[2])
            else:
                rec = dryrun_cell(aid, shape, mp, args.full_depth)
        except Exception as e:                    # noqa: BLE001 — recorded
            rec = {"arch": aid, "shape": shape,
                   "mesh": "multi" if mp else "single",
                   "error": f"{type(e).__name__}: {e}"[:2000],
                   "where": _port_frames(e),
                   "traceback": traceback.format_exc()[-2000:]}
            print(f"[dryrun] FAILED {key}: {rec['error'][:300]}")
        results[:] = [r for r in results
                      if (r["arch"], r["shape"], r["mesh"]) != key]
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)

    arch_ids = all_arch_ids() + ["dedup-stream"] if args.arch == "all" \
        else [args.arch]
    for mp in meshes:
        for aid in arch_ids:
            if aid == "dedup-stream":
                run(aid, "ingest", mp)
                continue
            arch = get_arch(aid)
            shapes = (list(arch.shapes) if args.shape == "all"
                      else [args.shape])
            for shape in shapes:
                run(aid, shape, mp)

    n_ok = sum(1 for r in results if "error" not in r and "skipped" not in r)
    n_skip = sum(1 for r in results if "skipped" in r)
    n_err = sum(1 for r in results if "error" in r)
    print(f"[dryrun] done: {n_ok} traced, {n_skip} skipped (by rule), "
          f"{n_err} errors -> {args.out}")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
