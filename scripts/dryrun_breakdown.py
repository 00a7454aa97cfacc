"""Where a dry-run cell's per-device flops and collective bytes go: one
cell of the port's dry run (``repro_torch.launch.dryrun.trace_cell`` on
the production mesh over a fake process group, fake tensors), optionally
at a cut depth or cell size, with each counted matmul grouped by its
local operand shapes and by the DTensor op (and its placements) that
issued it, and each collective by the DTensor op that issued it; and,
for a train cell of an LM, the count of its shapes: 8 flops per active
parameter per token under full remat (top-k of the routed experts, the
embedding's lookup not a matmul) plus the attention's two products at
the full sequence, 4 passes (forward, its recompute, twice in the
backward); and the bound on its all-gathers of parameters split over
"data" (FSDP): 3 x accumulation x their bytes per device once gathered,
one gather per use in the forward, its recompute and the backward.
For a prefill cell, the count of its shapes as ``lm_prefill_count``
makes it. The cell is traced at full depth (``--layers`` cuts it).
Computed from shapes on the host, never measured.

    PYTHONPATH=src python scripts/dryrun_breakdown.py --arch mixtral-8x7b \\
        --shape train_4k --layers 1 [--batch 256] [--mesh multi] [--top 20]
"""

import argparse
import collections
import dataclasses
import json

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.registry import ShapeCell
from repro_torch.launch import analysis, dryrun
from repro_torch.launch.mesh import make_production_mesh


def lm_train_count(arch, n_chips: int, as_computed: bool = False) -> float:
    """The count of a train cell's shapes per device of ``n_chips`` (see
    the module's docstring). ``as_computed``: as both packages compute
    it instead — the routed experts at their capacity slots (E·C a
    group of g tokens of a microbatch, C = max(4, ceil(g k cf / E))) and
    each attention product in 5 passes (the forward, the layer's remat,
    the blocked attention's own checkpoint — per Q block in the port,
    per KV step in the reference — and 2 in the backward)."""
    from repro_torch.models.moe import _capacity
    cfg = arch.cfg
    dims = arch.shapes["train_4k"].dims
    T = dims["batch"] // arch.accum.get("train_4k", 1) * dims["seq"]
    g = cfg.moe_group_size if cfg.is_moe and cfg.moe_group_size and \
        T > cfg.moe_group_size and T % cfg.moe_group_size == 0 else T
    active = 0
    for name, p in arch.params_shape().named_parameters():
        if p.dim() < 2 or "embed" in name:
            continue
        n = p.numel()
        if "moe" in name and "shared" not in name and "router" not in name:
            n = n * _capacity(g, cfg.moe_cfg) / g if as_computed else \
                n * cfg.moe_top_k // cfg.n_experts
        active += n
    qk, v = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
             if cfg.use_mla else (cfg.hd, cfg.hd))
    passes = 5 if as_computed else 4
    attn = passes * 2 * dims["seq"] * cfg.n_heads * (qk + v) * cfg.n_layers
    return (8 * active + attn) * dims["batch"] * dims["seq"] / n_chips


def lm_prefill_count(arch, n_chips: int, shape: str = "prefill_32k"
                     ) -> float:
    """The count of a prefill cell's shapes per device of ``n_chips``: 2
    flops a multiply-add of every weight each token passes through (the
    lm_head at every position; the routed experts at their capacity
    slots, E·C a group of g tokens with C = max(4, ceil(g k cf / E)), as
    both packages' dispatch runs them; the embedding's lookup not a
    matmul), plus the attention's two products over every (q_block,
    k_block) tile that both packages' ``flash_sdpa`` computes, masked or
    not: the padded sequence squared, per head and layer."""
    from repro_torch.models.moe import _capacity
    cfg = arch.cfg
    dims = arch.shapes[shape].dims
    B, S = dims["batch"], dims["seq"]
    T = B * S
    g = cfg.moe_group_size if cfg.is_moe and cfg.moe_group_size and \
        T > cfg.moe_group_size and T % cfg.moe_group_size == 0 else T
    per_token = 0
    for name, p in arch.params_shape().named_parameters():
        if p.dim() < 2 or "embed" in name:
            continue
        n = p.numel()
        if ".moe." in name and "shared" not in name and \
                "router" not in name:
            n = n * _capacity(g, cfg.moe_cfg) / g
        per_token += n
    qk, v = ((cfg.qk_nope_dim + cfg.qk_rope_dim, cfg.v_head_dim)
             if cfg.use_mla else (cfg.hd, cfg.hd))
    qb, kb = min(cfg.attn_q_block, S), min(cfg.attn_k_block, S)
    pad = (-(-S // qb) * qb, -(-S // kb) * kb)
    attn = 2 * pad[0] * pad[1] * cfg.n_heads * (qk + v) * cfg.n_layers * B
    return (2 * per_token * T + attn) / n_chips


def fsdp_gather_bound(arch, mesh, shape: str) -> float:
    """3 x accumulation x the bytes per device, once gathered over
    "data", of the parameters whose spec splits them over "data"."""
    from repro_torch.distributed import sharding as shr
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    total = 0
    for (path, shape_), spec in zip(
            shr._ref_leaves(arch.params_shape()),
            _leaves(arch.param_specs(mesh))):
        axes = [a for e in spec if e for a in ((e,) if isinstance(e, str)
                                               else e)]
        if "data" not in axes:
            continue
        split = 1
        for a in axes:
            split *= 1 if a == "data" else sizes[a]
        itemsize = 2 if arch.cfg.dtype == torch.bfloat16 else 4
        n = 1
        for d in shape_:
            n *= d
        total += n * itemsize / split
    return 3 * arch.accum.get(shape, 1) * total


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _desc(a) -> str:
    from torch.distributed.tensor import DTensor
    if isinstance(a, DTensor):
        return f"{tuple(a.shape)}{[str(p) for p in a.placements]}"
    if isinstance(a, torch.Tensor):
        return f"{tuple(a.shape)}"
    if isinstance(a, (list, tuple)):
        return "[" + ",".join(_desc(x) for x in a) + "]"
    return repr(a)[:40]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--layers", type=int)
    ap.add_argument("--batch", type=int)
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--bound-only", action="store_true",
                    help="print the FSDP gather bound, trace nothing")
    args = ap.parse_args()
    arch = get_arch(args.arch)
    if args.layers:
        arch = type(arch)(args.arch, dataclasses.replace(
            arch.cfg, n_layers=args.layers), **(
                {"accum": arch.accum} if hasattr(arch, "accum") else {}))
    if args.batch:
        c = arch.shapes[args.shape]
        arch.shapes[args.shape] = ShapeCell(c.name, c.kind,
                                            {**c.dims, "batch": args.batch})
    flops = collections.Counter()
    owner = ["step"]
    orig = analysis._OpCounter.__torch_dispatch__

    def counted(self, func, types, args_=(), kwargs=None):
        if analysis._is_dtensor(types) and not self.propagating.depth:
            owner[0] = f"{func.overloadpacket}{_desc(args_)}"
        before = self.flops
        out = orig(self, func, types, args_, kwargs)
        if self.flops > before:
            flops[(f"{func.overloadpacket}{_desc(args_)}", owner[0])] += \
                self.flops - before
        return out

    analysis._OpCounter.__torch_dispatch__ = counted
    multi = args.mesh == "multi"
    with dryrun.fake_world(512 if multi else 256):
        mesh = make_production_mesh(multi, device="cpu")
        bound = (fsdp_gather_bound(arch, mesh, args.shape)
                 if arch.family == "lm" else None)
        if args.bound_only:
            print(json.dumps({"fsdp_gather_bound": bound}))
            return
        rec = dryrun.trace_cell(arch, args.shape, mesh, full_depth=True)
    out = {"flops": rec["cost"]["flops"],
           "temp_bytes": rec["memory"]["temp_size_in_bytes"],
           "collectives_bytes": rec["collectives_bytes"],
           "collectives_by_op": rec["collectives_by_op"],
           "top_flops": [[v, k[0], k[1]]
                         for k, v in flops.most_common(args.top)]}
    if arch.family == "lm" and arch.shapes[args.shape].kind == "train":
        out["shape_count"] = lm_train_count(arch, 512 if multi else 256)
        out["count_as_computed"] = lm_train_count(
            arch, 512 if multi else 256, as_computed=True)
        out["fsdp_gather_bound"] = bound
    if arch.family == "lm" and arch.shapes[args.shape].kind == "prefill":
        out["shape_count"] = lm_prefill_count(arch, 512 if multi else 256,
                                              args.shape)
    print(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
