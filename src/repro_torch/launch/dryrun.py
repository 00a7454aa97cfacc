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
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

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


def trace_cell(arch, shape: str, mesh) -> dict:
    """One cell of ``arch`` (an ``LMArch``, ``GNNArch`` or ``RecsysArch``)
    placed on ``mesh`` (over a process group that is up) and its step run
    once on fake tensors under ``analyze_step`` — the counterpart of the
    reference's ``hillclimb.lower_lm_cell``. -> the analysis record with
    ``trace_s`` and ``place_s``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cell = arch.shapes[shape]
    dev = "cpu"
    if arch.family == "gnn":
        shape_tree = arch.params_shape(shape)
        pspecs = arch.param_specs(mesh, shape)
        ospecs = arch.opt_specs(mesh, shape)
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
        step = arch.step(shape)
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


def dryrun_cell(arch_id: str, shape: str, multi_pod: bool) -> dict:
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
        rec.update(trace_cell(arch, shape, mesh))
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
                rec = dryrun_cell(aid, shape, mp)
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
