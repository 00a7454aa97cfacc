"""The model sharding held to the unplaced step, port against port, on
the CPU of any host (gloo ranks, fake process groups): the checks that
``tests/test_torch_jit_sharded.py`` and ``tests/test_torch_dryrun.py``
make against the reference, in a form that needs no JAX, so that the
card machine's torch runs them too.

    PYTHONPATH=src python -m repro_torch.launch.meshcheck            # all
    PYTHONPATH=src python -m repro_torch.launch.meshcheck --part memory

``steps``: one train step of each family's smoke config (``FAMILIES``)
through ``train.jit_sharded`` on a (2, 2) ("data", "model") mesh of four
gloo ranks, each rank a process of its own meeting at a ``FileStore``,
against the same step unplaced from the same seeded state, and three
decode steps of a one-KV-head qwen3-8b with the reference's
sequence-parallel cache; every parameter leaf (logit, cache entry)
within ``TOL`` of the tree's max |value|, the loss and grad norm within
``TOL`` of theirs. It also counts the index ops, slices and selects
that went past the port's own handlers to DTensor's dispatch (must be
none).

``traces``: on fake process groups, the cells that torch 2.11's DTensor
refused before the port placed the index ops itself and mixtral-8x7b's
long_500k on the multi mesh, which each torch's DTensor read at other
flops before the port placed the elementwise ops, against the same cell
on the single mesh (``TRACE_CELLS``, ``TRACE_SAME_FLOPS``), and
qwen3-8b's decode_32k against the count of its shapes
(``decode_flops``). ``moe``: the smoke MoE train steps on a fake
(4, 1) mesh against (1, 1), whose flops must split 4x (``moe_split``).
``attention``: the GQA analogs of mixtral-8x7b and qwen3-8b (8 query
heads, 2 KV heads) on a fake (1, 4) mesh: the attention split 4x,
nothing of the queries gathered, the step's flops against the
reference's plan (``attention_split``). ``depth``: the dry run's
per-layer count of ``DEPTH_CELLS`` against their full-depth traces
(``depth_differences``). ``memory``: the smoke head check, qwen3-8b's
smoke step at one layer traced at two vocab sizes on fake (1, 1), (1, 4),
(2, 2) and (4, 1) meshes (``head_copies``), no mesh holding more copies
of each rank's fp32 logits than ``HEAD_TOL`` times the one-rank step
(``head_temp_ok``); four processes at once, ~15 s. Each other part
takes about a minute on one core; they run apart as processes of their
own (``--part``) where time counts. ``REFERENCE_TEMP`` holds the
reference's temp per device of the LM train_4k and prefill_32k cells,
which ``scripts/dryrun_table.py --reference`` sets beside the port's.

Prints one JSON object as its last line; exit 0 when every check
passes. Nothing here touches a card.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np

# family: (arch id, gradient accumulation steps)
FAMILIES = {"lm": ("qwen3-8b", 1), "lm_accum": ("qwen3-8b", 2),
            "lm_gqa": ("qwen3-8b", 1),
            "moe": ("mixtral-8x7b", 1), "moe_grouped": ("deepseek-v2-236b", 1),
            "gnn": ("meshgraphnet", 1), "recsys": ("dlrm-rm2", 1)}
TOL = 1e-5
LR = 1e-4
# the ops whose passing on to DTensor's own dispatch the steps check
# counts (none may pass): the index ops, slices and selects
UNHANDLED_WATCHED = ("index_add", "index_put", "index_select", "slice",
                     "select")
RANKS, MODEL = 4, 2
# the cells torch 2.11's DTensor refused (an index_add of split indices,
# index_put_ with no strategy, index_select over a dimension split twice)
TRACE_CELLS = (("meshgraphnet", "molecule", True),
               ("dlrm-rm2", "train_batch", False),
               ("dlrm-rm2", "serve_p99", True),
               ("mixtral-8x7b", "long_500k", True))
# the cells whose flops per device must equal another cell's, traced in
# the same part, within TRACE_TOL: the mixtral cell's batch of one splits
# over no mesh dimension, so the multi mesh's "pod" leaves each device the
# work it has on the single mesh (torch 2.13 read 4.468e9 flops and 2.11
# 8.143e9 while DTensor placed the elementwise ops and softmax, each
# reducing the batch-of-one's partial sums at other ops)
TRACE_SAME_FLOPS = {"mixtral-8x7b/long_500k/multi": ("mixtral-8x7b",
                                                     "long_500k", False)}
TRACE_TOL = 0.01
# the smoke MoE train step of the split check: batch x seq tokens, routed
# in groups of MOE_GROUP (128 groups; 32 per "data" rank of 4)
MOE_SPLIT = {"batch": 64, "seq": 128}
MOE_GROUP = 64
SPLIT_TOL = 0.02
DECODE_TOL = 0.01
# the smoke GQA analog of the attention check: 8 query heads, 2 KV heads,
# head_dim 16, so that a "model" split of 4 divides the query heads but
# not the KV heads, as 16 does mixtral-8x7b's and qwen3-8b's 32 and 8;
# one microbatch of 16 x 128 tokens in the smoke config's 32-token blocks
ATTN_HEADS = {"n_heads": 8, "n_kv_heads": 2, "head_dim": 16}
ATTN_SPLIT = {"batch": 16, "seq": 128}
# the reference's per-device flops of those steps on a (1, 4) mesh
# (``scripts/reference_attn_plan.py``: XLA for 4 host devices, Auto axes,
# loop-aware; computed from shapes, jax 0.9.0)
REFERENCE_ATTN_FLOPS = {"qwen3-8b": 624951296.0,
                        "mixtral-8x7b": 587202560.0}
ATTN_TOL = 0.05


def smoke_config(family: str):
    """The port's smoke config of a family. ``moe_grouped`` is
    deepseek-v2-236b's (MLA, shared experts, the dense first layer) with
    8 routed experts and ``moe_group_size`` 20, so that a batch of 4 x 40
    tokens routes in 8 groups, 4 on each "data" rank of 2, and pairs
    drop (capacity 13 per expert). ``lm_gqa`` is qwen3-8b's with one KV
    head for its 4 query heads: on "model" 2 the KV heads do not divide
    the split, so the attention regroups its queries as 2 x 2 and
    repeats K and V twice (``models.transformer._gqa_factor``)."""
    from ..configs import get_arch
    cfg = get_arch(FAMILIES[family][0]).smoke()
    if family == "lm_gqa":
        cfg = dataclasses.replace(cfg, n_kv_heads=1)
    if family == "moe_grouped":
        cfg = dataclasses.replace(cfg, n_experts=8, moe_group_size=20)
    return cfg


def family_inputs(family: str, cfg) -> dict:
    """The step's inputs as numpy arrays from a fixed seed: ``cfg`` is
    either package's config of the family (only its sizes are read)."""
    rng = np.random.default_rng(11)
    if family in ("lm", "lm_accum", "lm_gqa", "moe", "moe_grouped"):
        toks = rng.integers(0, cfg.vocab, (4, 41)).astype(np.int32)
        return {"tokens": toks,
                "weights": np.array([1.0, 0.0, 0.5, 1.0], np.float32)}
    if family == "gnn":
        n, e = 64, 128
        return {"batch": {
            "nodes": rng.standard_normal((n, cfg.d_node_in)).astype(
                np.float32),
            "edges": rng.standard_normal((e, 8)).astype(np.float32),
            "src": rng.integers(0, n, e).astype(np.int32),
            "dst": rng.integers(0, n, e).astype(np.int32),
            "edge_mask": rng.random(e) < 0.9,
            "node_mask": rng.random(n) < 0.9,
            "targets": rng.standard_normal((n, cfg.d_out)).astype(
                np.float32)}, "weights": None}
    b = 16
    ids = np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                   1).astype(np.int32)
    w = np.ones(b, np.float32)
    w[3] = 0.0
    return {"batch": {"dense": rng.standard_normal((b, cfg.n_dense)).astype(
        np.float32), "sparse_ids": ids,
        "labels": (rng.random(b) < 0.3).astype(np.float32)}, "weights": w}


def config_dict(cfg) -> dict:
    """A config as plain fields (``dtype`` by name), to cross a pickle
    into a rank or from the reference's config."""
    def name(dtype):
        try:
            return np.dtype(dtype).name
        except TypeError:                         # a torch dtype
            return str(dtype).rsplit(".", 1)[-1]

    return {k: (name(v) if k == "dtype" else v)
            for k, v in dataclasses.asdict(cfg).items()}


def _kind(arch_id: str) -> str:
    from ..configs import get_arch
    return {"lm": "transformer", "gnn": "gnn",
            "recsys": "recsys"}[get_arch(arch_id).family]


def seeded_params(arch_id: str, cfg, seed: int) -> dict:
    """The port's seeded params of ``cfg`` as the reference's numpy tree."""
    from .. import convert
    from ..models import gnn, recsys, transformer
    kind = _kind(arch_id)
    mod = {"transformer": transformer, "gnn": gnn, "recsys": recsys}[kind]
    return getattr(convert, f"{kind}_params_to_numpy")(
        cfg, mod.init(cfg, seed, "cpu"))


def decode_case(params=None) -> tuple:
    """(arch id, config fields, params, inputs, 1) of the decode check:
    qwen3-8b's smoke config with one KV head (its cache's sequence splits
    over "model", its batch over "data"), 4 rows at three positions each,
    16 slots. ``params``: a numpy tree (the reference's), else the
    port's seeded one."""
    from ..configs import get_arch
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke(), n_kv_heads=1)
    rng = np.random.default_rng(5)
    inp = {"token": rng.integers(0, cfg.vocab, (4, 3)).astype(np.int32),
           "pos": np.array([[0, 1, 2], [5, 6, 7], [0, 3, 9], [11, 12, 13]],
                           np.int32),
           "slots": 16}
    if params is None:
        params = seeded_params("qwen3-8b", cfg, 1)
    return "qwen3-8b", config_dict(cfg), params, inp, 1


def port_cases() -> dict:
    """Every family's case from the port's own seeded params."""
    cases = {}
    for family, (arch_id, accum) in FAMILIES.items():
        cfg = smoke_config(family)
        cases[family] = (arch_id, config_dict(cfg),
                         seeded_params(arch_id, cfg, 0),
                         family_inputs(family, cfg), accum)
    cases["decode"] = decode_case()
    return cases


@contextlib.contextmanager
def counting_unhandled(counts: collections.Counter):
    """For the duration, each op that one of ``train.steps``' handlers
    passes on to DTensor's own dispatch is counted in ``counts`` by
    name."""
    from ..train import steps
    orig = steps._dispatch_unhandled

    def counted(op_call, args, kwargs):
        counts[str(op_call)] += 1
        return orig(op_call, args, kwargs)

    steps._dispatch_unhandled = counted
    try:
        yield
    finally:
        steps._dispatch_unhandled = orig


def _whole(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


def _whole_params(params):
    """Every DTensor parameter gathered whole, in one order on every
    rank."""
    import torch
    for name, p in list(params.named_parameters()):
        if hasattr(p, "full_tensor"):
            owner, _, leaf = name.rpartition(".")
            setattr(params.get_submodule(owner), leaf,
                    torch.nn.Parameter(p.full_tensor()))
    return params


def run_family(mesh, family: str, case: tuple, lr: float) -> dict:
    """One train step of ``case`` (arch id, config fields, numpy params,
    numpy inputs, accumulation) plain and through ``jit_sharded`` on
    ``mesh``, each from the same state -> {form: (numpy params after,
    loss, grad norm, the stacked leaves whose moments ZeRO-1 split by
    layer)}."""
    import torch
    from .. import convert
    from ..configs import get_arch
    from ..distributed import sharding as shr
    from ..models import gnn
    from ..models.layers import module_leaves, tensor_batch
    from ..optim import OptState, init_opt_state, optimizers
    from ..train import jit_sharded, make_train_step
    arch_id, cfg_dict, rp, inp, accum = case
    arch = get_arch(arch_id)
    cfg = type(arch.smoke())(**cfg_dict)
    # no warmup, a peak lr of ``lr``: a wrong update shows
    opt_cfg = dataclasses.replace(arch.opt_config(), warmup_steps=0, lr=lr)
    if arch.family == "lm":
        arch = type(arch)(arch_id, cfg, accum={"train_4k": accum})
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_4k")
        pspecs, ospecs = arch.param_specs(mesh), arch.opt_specs(mesh)
        bs = arch.batch_specs("train_4k", mesh)
        args = (torch.from_numpy(inp["tokens"]),
                torch.from_numpy(inp["weights"]))
        specs = (bs["tokens"], bs["weights"])
    elif arch.family == "gnn":
        step = make_train_step(lambda p, b, w: gnn.loss_fn(cfg, p, b, w),
                               opt_cfg)
        pspecs = shr.gnn_param_specs(mesh, gnn._build(cfg, None, "meta"))
        ospecs = OptState(step=shr.P(), m=pspecs, v=pspecs)
        args = (tensor_batch(inp["batch"], "cpu"), None)
        specs = (shr.gnn_batch_specs(mesh, True), None)
    else:
        arch = type(arch)(arch_id, cfg)
        arch.opt_config = lambda: opt_cfg
        step = arch.step("train_batch")
        pspecs, ospecs = arch.param_specs(mesh), arch.opt_specs(mesh)
        bs = shr.recsys_batch_specs(mesh)
        args = (tensor_batch(inp["batch"], "cpu"),
                torch.from_numpy(inp["weights"]))
        specs = ({k: bs[k] for k in inp["batch"]}, bs["labels"])
    kind = _kind(arch_id)
    to_port = getattr(convert, f"{kind}_params_from_numpy")
    to_numpy = getattr(convert, f"{kind}_params_to_numpy")
    res = {}
    for form in ("plain", "sharded"):
        params = to_port(cfg, rp, "cpu")
        opt = init_opt_state(opt_cfg, params)
        fn = step if form == "plain" else jit_sharded(
            step, mesh, (pspecs, ospecs) + specs)
        params, opt, m = fn(params, opt, *args)
        split = [lf.path for lf in module_leaves(params) if lf.stacked
                 and optimizers._layers_split(optimizers._leaf(opt.m, lf))]
        res[form] = (to_numpy(cfg, _whole_params(params)),
                     float(_whole(m["loss"])), float(_whole(m["grad_norm"])),
                     split)
    return res


def run_decode(mesh, case: tuple) -> dict:
    """Three decode steps of ``case`` (``decode_case``) plain and through
    ``jit_sharded`` on ``mesh`` -> {form: (logits per step, the cache)},
    numpy."""
    import torch
    from .. import convert
    from ..configs import get_arch
    from ..distributed import sharding as shr
    from ..models import transformer
    from ..train import jit_sharded
    arch_id, cfg_dict, rp, inp, _ = case
    cfg = transformer.TransformerConfig(**cfg_dict)
    arch = type(get_arch(arch_id))(arch_id, cfg)
    step = arch.step("decode_32k")
    B, S = inp["token"].shape[0], inp["slots"]
    cspecs = shr.transformer_cache_specs(cfg, mesh,
                                         transformer.cache_spec(cfg, B, S))
    bspec = shr.P(shr.batch_axes(mesh))
    res = {}
    for form in ("plain", "sharded"):
        params = convert.transformer_params_from_numpy(cfg, rp, "cpu")
        cache = transformer.init_cache(cfg, B, S, "cpu")
        fn = step if form == "plain" else jit_sharded(
            step, mesh, (arch.param_specs(mesh), cspecs, bspec, bspec),
            donate_argnums=(1,))
        logits = []
        # a serving step runs under inference mode: so is its placement
        with torch.inference_mode():
            for t, p in zip(inp["token"].T, inp["pos"].T):
                lg, cache = fn(params, cache, torch.from_numpy(t.copy()),
                               torch.from_numpy(p.copy()))
                logits.append(_whole(lg).numpy())
            cache = {k: _whole(v).float().numpy() for k, v in cache.items()}
        res[form] = (logits, cache)
    return res


def run_cases(mesh, cases: dict, lr: float) -> dict:
    """What each rank runs: every family of ``cases`` and the decode ->
    {family: run_family's result, "decode": run_decode's, "unhandled":
    {op: count} of the index ops, slices and selects passed on to
    DTensor's dispatch, "gather_replicated": ``train.steps``'
    ``GATHER_REPLICATED``, the lines whose gather replicated a split
    gathered dimension}."""
    from ..train import steps
    counts = collections.Counter()
    out = {}
    steps.GATHER_REPLICATED.clear()
    with counting_unhandled(counts):
        for family, case in cases.items():
            out[family] = (run_decode(mesh, case) if family == "decode"
                           else run_family(mesh, family, case, lr))
    out["unhandled"] = {op: n for op, n in counts.items()
                        if any(k in op for k in UNHANDLED_WATCHED)}
    out["gather_replicated"] = dict(steps.GATHER_REPLICATED)
    return out


def flat(tree, path=()) -> dict:
    """{path: array} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in flat(tree[key], path + (key,)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, t in enumerate(tree)
                for k, v in flat(t, path + (i,)).items()}
    return {path: np.asarray(tree)}


def mismatches(after: dict, want: dict) -> dict:
    """{leaf: its distance} for each leaf of ``after`` further from
    ``want``'s than TOL of the whole tree's largest |value|."""
    scale = max(np.abs(w).max() for w in want.values())
    dist = {k: np.abs(after[k] - w).max() / scale for k, w in want.items()}
    return {k: d for k, d in dist.items() if not d <= TOL}


def distances(res: dict) -> dict:
    """Sharded against plain: {family: the largest distance of a leaf,
    of the loss, of the grad norm (decode: of a step's logits, of a cache
    entry)}, each relative to the plain tree's max |value|."""
    out = {}
    for family, forms in res.items():
        if family == "decode":
            (p_lg, p_cache), (s_lg, s_cache) = forms["plain"], \
                forms["sharded"]
            out[family] = {
                "logits": max(float(np.abs(a - b).max() / np.abs(b).max())
                              for a, b in zip(s_lg, p_lg)),
                "cache": max(float(np.abs(s_cache[k] - b).max()
                                   / max(np.abs(b).max(), 1.0))
                             for k, b in p_cache.items())}
            continue
        (pp, pl, pn, _), (sp, sl, sn, _) = forms["plain"], forms["sharded"]
        pp, sp = flat(pp), flat(sp)
        scale = max(np.abs(v).max() for v in pp.values())
        out[family] = {
            "params": max(float(np.abs(sp[k] - v).max() / scale)
                          for k, v in pp.items()),
            "loss": abs(sl - pl) / abs(pl), "grad_norm": abs(sn - pn) / pn}
    return out


RANK_WORKER = """
import os, pickle, sys
import torch, torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.launch import meshcheck
from repro_torch.launch.mesh import make_local_mesh
tmp = sys.argv[1]
rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                        rank=rank, world_size=world)
lr, cases = pickle.load(open(os.path.join(tmp, "cases.pkl"), "rb"))
out = meshcheck.run_cases(make_local_mesh(model=meshcheck.MODEL,
                                          device="cpu"), cases, lr)
if rank == 0:
    with open(os.path.join(tmp, "out.pkl"), "wb") as f:
        pickle.dump(out, f)
dist.destroy_process_group()
"""


def start_ranks(code: str, tmp: str, world: int = RANKS) -> list:
    """``code`` as ``world`` gloo ranks on the CPU, each a process of its
    own (one thread) meeting at a ``FileStore`` in ``tmp``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    store = os.path.join(tmp, f"store-{os.urandom(4).hex()}")
    env = {**os.environ, "PYTHONPATH": root, "WORLD": str(world),
           "STORE": store, "OMP_NUM_THREADS": "1"}
    return [subprocess.Popen([sys.executable, "-c", code, tmp],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                             text=True, env={**env, "RANK": str(r)})
            for r in range(world)]


def finish_ranks(procs: list, timeout: float = 900) -> None:
    """Waits for the ranks; any still running at ``timeout`` is killed.
    Raises with the first failing rank's error output."""
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (_, err) in zip(procs, outs):
        if p.returncode:
            raise RuntimeError(f"a rank exited {p.returncode}: "
                               f"{err[-3000:]}")


def check_steps(timeout: float = 900) -> dict:
    """The (2, 2) gloo steps of every family and the decode, port against
    port -> {"distances", "unhandled", "ok", "s"}."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "cases.pkl"), "wb") as f:
            pickle.dump((LR, port_cases()), f)
        finish_ranks(start_ranks(RANK_WORKER, tmp), timeout)
        with open(os.path.join(tmp, "out.pkl"), "rb") as f:
            out = pickle.load(f)
    unhandled = out.pop("unhandled")
    replicated = out.pop("gather_replicated")
    dist = distances(out)
    ok = not unhandled and all(v <= TOL for d in dist.values()
                               for v in d.values())
    return {"distances": dist, "unhandled": unhandled,
            "gather_replicated": replicated, "ok": ok,
            "s": round(time.perf_counter() - t0, 1)}


# ------------------------------------------------------------ traces --- //

def decode_flops(cfg, batch: int, seq: int, data: int, model: int) -> int:
    """Per-device flops of one decode step of a dense GQA config at
    ``batch`` rows over ``data`` ranks against a ``seq``-long cache, each
    weight's and the cache's model-split dimension over ``model`` ranks
    (heads, or head_dim where the KV heads do not divide it; the FFN; the
    vocab; the cache's sequence): 2 flops a multiply-add of every matmul
    and both attention products."""
    b = batch // data
    d, hd = cfg.d_model, cfg.hd
    q, kv = cfg.n_heads * hd, cfg.n_kv_heads * hd
    layer = 2 * b * d * (q + 2 * kv + q) + 2 * 2 * b * q * seq \
        + 3 * 2 * b * d * cfg.d_ff
    return (cfg.n_layers * layer + 2 * b * d * cfg.vocab) // model


def _summary(rec: dict) -> dict:
    keep = {"flops": rec["cost"]["flops"],
            "temp_bytes": rec["memory"]["temp_size_in_bytes"],
            "collectives_bytes": rec["collectives_bytes"],
            "trace_s": rec.get("trace_s")}
    return keep


def moe_step_arch(arch_id: str, batch: int, seq: int, group: int):
    """The smoke config's ``LMArch`` with its ``train_4k`` cell cut to
    ``batch`` x ``seq`` tokens in one microbatch, routed in groups of
    ``group``."""
    from ..configs import get_arch
    from ..configs.registry import ShapeCell
    arch = get_arch(arch_id)
    cfg = dataclasses.replace(arch.smoke(), moe_group_size=group)
    arch = type(arch)(arch_id, cfg, accum={"train_4k": 1})
    arch.shapes["train_4k"] = ShapeCell("train_4k", "train",
                                        {"batch": batch, "seq": seq})
    return arch


def moe_apply_trace(arch_id: str, dispatch: str, mesh=None,
                    batch: int = 4, seq: int = 64, group: int = 32) -> dict:
    """``moe_apply`` alone, forward and backward (the gradients of its
    params, placed as the params are, and of its input), of the smoke
    config's MoE layer with ``dispatch`` and groups of ``group`` tokens,
    on fake (batch, seq, d) tokens split by rows over ``mesh``'s batch
    axes, under ``analysis.analyze_step``; ``mesh`` None runs it unplaced.
    The record's ``param_bytes`` are the MoE params' bytes."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..configs import get_arch
    from ..distributed import sharding as shr
    from ..models.moe import moe_apply, moe_init
    from ..train import jit_sharded
    from .analysis import analyze_step
    from .dryrun import _fake_params, _strided_offsets_on_host
    arch = get_arch(arch_id)
    tcfg = dataclasses.replace(arch.smoke(), moe_dispatch=dispatch,
                               moe_group_size=group)
    cfg = tcfg.moe_cfg
    params = moe_init(None, cfg, tcfg.dtype, "meta")
    names = [n for n, _ in params.named_parameters()]

    def step(p, x):
        x = x.requires_grad_()
        loss = moe_apply(p, x, cfg).float().pow(2).sum()
        return torch.autograd.grad(
            loss, [q for _, q in p.named_parameters()] + [x])

    with _strided_offsets_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_params(params, "cpu")
        x = torch.empty((batch, seq, cfg.d_model), dtype=tcfg.dtype)
        if mesh is None:
            rec = analyze_step(step, (params, x))
        else:
            stacked = shr.transformer_param_specs(
                tcfg, mesh, type(arch)(arch_id, tcfg).params_shape()
            )["layers"]["moe"]
            specs = shr.map_specs(lambda sp: shr.P(*sp[1:]), stacked)
            xs = shr.P(shr.batch_axes(mesh), None, None)
            grads = tuple(_spec_of(specs, n) for n in names) + (xs,)
            fn = jit_sharded(step, mesh, (specs, xs), out_specs=grads,
                             donate_argnums=())
            rec = analyze_step(fn.placed, fn.place(params, x))
    rec.pop("outputs")
    rec["param_bytes"] = sum(q.numel() * q.element_size()
                             for q in params.parameters())
    return rec


def _spec_of(specs: dict, name: str):
    """A parameter's spec by its module name (``shared.w_gate``)."""
    for k in name.split("."):
        specs = specs[k]
    return specs


def moe_split(arch_id: str) -> dict:
    """The smoke train step of ``moe_step_arch`` traced on a fake (1, 1)
    and a fake (4, 1) mesh -> {"flops": per device on each, "split":
    their ratio, "collectives_bytes" on (4, 1)}."""
    from .dryrun import fake_world, trace_cell
    from .mesh import make_local_mesh
    arch = moe_step_arch(arch_id, MOE_SPLIT["batch"], MOE_SPLIT["seq"],
                         MOE_GROUP)
    recs = {}
    for n in (1, 4):
        with fake_world(n):
            recs[n] = trace_cell(arch, "train_4k",
                                 make_local_mesh(model=1, device="cpu"))
    return {"flops": [recs[1]["cost"]["flops"], recs[4]["cost"]["flops"]],
            "split": recs[1]["cost"]["flops"] / recs[4]["cost"]["flops"],
            "collectives_bytes": recs[4]["collectives_bytes"]}


def _cell_key(arch_id: str, shape: str, multi: bool) -> str:
    return f"{arch_id}/{shape}/{'multi' if multi else 'single'}"


def check_traces() -> dict:
    """The fake-world traces of ``TRACE_CELLS``, of the cells that
    ``TRACE_SAME_FLOPS`` holds them to, and of qwen3-8b's decode_32k ->
    {"cells", "decode", "ok", "s"}."""
    from ..configs import get_arch
    from .dryrun import dryrun_cell
    t0 = time.perf_counter()
    cells, ok = {}, True
    for arch_id, shape, multi in TRACE_CELLS:
        key = _cell_key(arch_id, shape, multi)
        try:
            cells[key] = _summary(dryrun_cell(arch_id, shape, multi))
            if key in TRACE_SAME_FLOPS:
                other = _cell_key(*TRACE_SAME_FLOPS[key])
                cells[other] = _summary(dryrun_cell(*TRACE_SAME_FLOPS[key]))
        except Exception as e:                    # noqa: BLE001 — reported
            cells[key] = {"error": f"{type(e).__name__}: {e}"[:600]}
            ok = False
            continue
        if key in TRACE_SAME_FLOPS:
            want = cells[other]["flops"]
            cells[key]["expected_flops"] = want
            ok = ok and abs(cells[key]["flops"] / want - 1) <= TRACE_TOL
    rec = dryrun_cell("qwen3-8b", "decode_32k", False)
    arch = get_arch("qwen3-8b")
    dims = arch.shapes["decode_32k"].dims
    want = decode_flops(arch.cfg, dims["batch"], dims["seq"],
                        rec["mesh_shape"]["data"], rec["mesh_shape"]["model"])
    decode = {**_summary(rec), "shape_count": want,
              "ratio": rec["cost"]["flops"] / want}
    ok = ok and abs(decode["ratio"] - 1) <= DECODE_TOL
    return {"cells": cells, "decode": decode, "ok": ok,
            "s": round(time.perf_counter() - t0, 1)}


def check_moe() -> dict:
    """``moe_split`` of both MoE archs -> {arch: its record, "ok", "s"}."""
    t0 = time.perf_counter()
    out = {a: moe_split(a) for a in ("mixtral-8x7b", "deepseek-v2-236b")}
    out["ok"] = all(abs(m["split"] / 4 - 1) <= SPLIT_TOL
                    for m in out.values())
    out["s"] = round(time.perf_counter() - t0, 1)
    return out


# ---------------------------------------------------------- attention --- //

def gqa_config(arch_id: str):
    """The smoke config of ``arch_id`` with ``ATTN_HEADS``."""
    from ..configs import get_arch
    return dataclasses.replace(get_arch(arch_id).smoke(), **ATTN_HEADS)


def attention_trace(arch_id: str, mesh=None, batch: int = 4,
                    seq: int = 64) -> dict:
    """The attention sublayer alone (``transformer._attn_apply``: the
    projections, RoPE, the regroup, the blocked attention and the output
    projection), forward and backward (its params' and its input's
    gradients), of ``gqa_config(arch_id)`` on fake (batch, seq, d)
    inputs split by rows over ``mesh``'s batch axes, under
    ``analysis.analyze_step``; ``mesh`` None runs it unplaced. The
    record's ``kv_bytes`` are the bytes of K and V (B, S, Kv, hd), what
    gathering their head_dim moves, ``norm_bytes`` those of the q / k
    norm scales (qk_norm), whose gradients are gathered from the split
    head_dim."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from ..configs import get_arch
    from ..distributed import sharding as shr
    from ..models import transformer as tfm
    from ..train import jit_sharded
    from .analysis import analyze_step
    from .dryrun import _fake_params, _strided_offsets_on_host
    cfg = gqa_config(arch_id)
    params = tfm._attn_init(cfg, None, "meta")
    # the sublayer's own norm scale is applied before it, by the layer
    names = [n for n, _ in params.named_parameters() if n != "norm"]

    def step(p, x):
        x = x.requires_grad_()
        pos = torch.arange(seq, dtype=torch.int32).expand(batch, seq)
        loss = tfm._attn_apply(p, cfg, x, pos).float().pow(2).sum()
        return torch.autograd.grad(loss, [p[n] for n in names] + [x])

    with _strided_offsets_on_host(), \
            FakeTensorMode(allow_non_fake_inputs=True):
        params = _fake_params(params, "cpu")
        x = torch.empty((batch, seq, cfg.d_model), dtype=cfg.dtype)
        if mesh is None:
            rec = analyze_step(step, (params, x))
        else:
            stacked = shr.transformer_param_specs(
                cfg, mesh, type(get_arch(arch_id))(arch_id, cfg)
                .params_shape())["layers"]["attn"]
            specs = shr.map_specs(lambda sp: shr.P(*sp[1:]), stacked)
            xs = shr.P(shr.batch_axes(mesh), None, None)
            grads = tuple(_spec_of(specs, n) for n in names) + (xs,)
            fn = jit_sharded(step, mesh, (specs, xs), out_specs=grads,
                             donate_argnums=())
            rec = analyze_step(fn.placed, fn.place(params, x))
    rec.pop("outputs")
    item = torch.finfo(cfg.dtype).bits // 8
    rec["kv_bytes"] = 2 * batch * seq * cfg.n_kv_heads * cfg.hd * item
    # the q / k norm scales' gradients, summed over a split head_dim
    rec["norm_bytes"] = 2 * cfg.hd * 4 if cfg.qk_norm else 0
    return rec


def attention_sublayer_ok(whole: dict, split: dict) -> bool:
    """Whether the GQA analog's attention sublayer (``attention_trace``)
    split over "model" 4 does a quarter of its flops whole and gathers
    K and V's head_dim and at most the q / k norm scales' gradients
    besides (no query)."""
    gathered = split["collectives_bytes"].get("all-gather", 0)
    return whole["cost"]["flops"] == 4 * split["cost"]["flops"] and \
        split["kv_bytes"] <= gathered <= \
        split["kv_bytes"] + split["norm_bytes"]


def gqa_step_arch(arch_id: str):
    """``gqa_config``'s ``LMArch`` with its ``train_4k`` cell cut to
    ``ATTN_SPLIT`` in one microbatch (``scripts/reference_attn_plan.py``
    compiles the reference's)."""
    from ..configs import get_arch
    from ..configs.registry import ShapeCell
    arch = type(get_arch(arch_id))(arch_id, gqa_config(arch_id),
                                   accum={"train_4k": 1})
    arch.shapes["train_4k"] = ShapeCell("train_4k", "train",
                                        dict(ATTN_SPLIT))
    return arch


def attention_split(arch_id: str) -> dict:
    """The GQA analog's attention sublayer (``attention_trace``) and its
    whole smoke train step (``gqa_step_arch``) on fake (1, 1) and (1, 4)
    meshes -> {"attn_flops": per device on each, "attn_split",
    "attn_all_gather": its all-gather bytes on (1, 4), "kv_bytes",
    "attn_ok": ``attention_sublayer_ok``, "flops": the step's on each,
    "reference_flops", "collectives_bytes" and "temp_bytes" on (1, 4)}."""
    from .dryrun import fake_world, trace_cell
    from .mesh import make_local_mesh
    attn, steps = {}, {}
    arch = gqa_step_arch(arch_id)
    for n in (1, 4):
        with fake_world(n):
            mesh = make_local_mesh(model=n, device="cpu")
            attn[n] = attention_trace(arch_id, mesh)
            steps[n] = trace_cell(arch, "train_4k", mesh)
    a1, a4 = attn[1]["cost"]["flops"], attn[4]["cost"]["flops"]
    return {"attn_flops": [a1, a4], "attn_split": a1 / a4,
            "attn_all_gather": attn[4]["collectives_bytes"].get(
                "all-gather", 0),
            "kv_bytes": attn[4]["kv_bytes"] + attn[4]["norm_bytes"],
            "attn_ok": attention_sublayer_ok(attn[1], attn[4]),
            "flops": [steps[1]["cost"]["flops"], steps[4]["cost"]["flops"]],
            "reference_flops": REFERENCE_ATTN_FLOPS[arch_id],
            "collectives_bytes": steps[4]["collectives_bytes"],
            "temp_bytes": steps[4]["memory"]["temp_size_in_bytes"]}


def check_attention() -> dict:
    """``attention_split`` of mixtral-8x7b's and qwen3-8b's GQA analogs:
    the attention split 4x, nothing gathered but K and V's head_dim and
    the norm scales' gradients (``attention_sublayer_ok``), the step's
    flops on (1, 4) within ``ATTN_TOL`` of the reference's -> {arch: its
    record, "ok", "s"}."""
    t0 = time.perf_counter()
    out = {a: attention_split(a) for a in ("mixtral-8x7b", "qwen3-8b")}
    out["ok"] = all(
        m["attn_ok"]
        and abs(m["flops"][1] / m["reference_flops"] - 1) <= ATTN_TOL
        for m in out.values())
    out["s"] = round(time.perf_counter() - t0, 1)
    return out


# -------------------------------------------------------------- depth --- //

# the smoke cells of the per-layer count's check, each at DEPTH_LAYERS
# layers on a fake (2, 2) mesh: (arch id, cell, its dims, config changes,
# gradient accumulation). deepseek-v2-236b's has its dense first layer;
# the prefill runs 256 tokens in 32-token blocks, 8 x 8 tiles a layer
DEPTH_CELLS = {
    "qwen3-8b/train_4k": ("qwen3-8b", "train_4k", {"batch": 8, "seq": 32},
                          {}, 2),
    "deepseek-v2-236b/train_4k": ("deepseek-v2-236b", "train_4k",
                                  {"batch": 8, "seq": 32}, {}, 1),
    "qwen3-8b/prefill_32k": ("qwen3-8b", "prefill_32k",
                             {"batch": 4, "seq": 256},
                             {"attn_q_block": 32, "attn_k_block": 32}, 1)}
DEPTH_LAYERS = 4
TEMP_TOL = 0.05


def depth_arch(name: str):
    """``DEPTH_CELLS[name]``'s ``LMArch`` at ``DEPTH_LAYERS`` layers."""
    from ..configs import get_arch
    from ..configs.registry import ShapeCell
    arch_id, shape, dims, changes, accum = DEPTH_CELLS[name]
    base = get_arch(arch_id)
    cfg = dataclasses.replace(base.smoke(), n_layers=DEPTH_LAYERS, **changes)
    arch = type(base)(arch_id, cfg, accum={"train_4k": accum})
    arch.shapes[shape] = ShapeCell(shape, base.shapes[shape].kind, dims)
    return arch, shape


def depth_trace(name: str, full_depth: bool) -> dict:
    """``depth_arch(name)``'s cell on a fake (2, 2) mesh, counted a layer
    at a time (``dryrun.depth_count``) or traced at full depth."""
    from .dryrun import fake_world, trace_cell
    from .mesh import make_local_mesh
    arch, shape = depth_arch(name)
    with fake_world(4):
        return trace_cell(arch, shape, make_local_mesh(model=2,
                                                       device="cpu"),
                          full_depth)


def _flat_terms(rec: dict) -> dict:
    from .dryrun import ADDITIVE
    out = {}

    def walk(x, path):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = x

    for path in ADDITIVE:
        x = rec
        for k in path:
            x = x.get(k, {})
        walk(x, path)
    for m in ("argument_size_in_bytes", "output_size_in_bytes",
              "alias_size_in_bytes"):
        out[f"memory/{m}"] = rec["memory"][m]
    return out


def depth_differences(count: dict, full: dict) -> dict:
    """{term: (per-layer count, full-depth trace)} of every additive term
    (and argument, output and alias bytes) that differs, and "temp": the
    count's temp over the trace's."""
    a, b = _flat_terms(count), _flat_terms(full)
    out = {k: (a.get(k, 0), b.get(k, 0)) for k in sorted(set(a) | set(b))
           if a.get(k, 0) != b.get(k, 0)}
    out["temp"] = count["memory"]["temp_size_in_bytes"] / \
        full["memory"]["temp_size_in_bytes"]
    return out


def depth_ok(diff: dict) -> bool:
    """Whether ``depth_differences`` holds a per-layer count to its
    full-depth trace: every additive term equal, temp within
    ``TEMP_TOL``."""
    return set(diff) == {"temp"} and abs(diff["temp"] - 1) <= TEMP_TOL


def check_depth() -> dict:
    """Each ``DEPTH_CELLS`` cell counted a layer at a time against its
    full-depth trace: every additive term equal, temp within
    ``TEMP_TOL`` -> {cell: its differences, "ok", "s"}."""
    t0 = time.perf_counter()
    out = {}
    for name in DEPTH_CELLS:
        out[name] = depth_differences(depth_trace(name, False),
                                      depth_trace(name, True))
    out["ok"] = all(depth_ok(d) for d in out.values())
    out["s"] = round(time.perf_counter() - t0, 1)
    return out


# ------------------------------------------------------------- memory --- //

# the smoke head check: qwen3-8b's smoke config at one layer, one
# microbatch of HEAD_CELL tokens, traced at both HEAD_VOCABS on each fake
# ("data", "model") mesh of HEAD_MESHES; Δtemp over Δ(each rank's fp32
# logits) is the number of copies of its logits the step holds, which a
# mesh may not raise past HEAD_TOL times the (1, 1) mesh's (five: the
# logits, logsumexp's backward's x - lse, its exp and their product, the
# gold logit's gradient). The attention runs in one block of the
# sequence: the smoke config's 32-token blocks hold the same copies at
# 2.3x the trace's ops
HEAD_CELL = {"batch": 16, "seq": 128}
HEAD_VOCABS = (4096, 512)
HEAD_MESHES = ((1, 1), (1, 4), (2, 2), (4, 1))
HEAD_TOL = 1.1
# the reference's temp per device of the LM train_4k and prefill_32k cells
# on both production meshes (``scripts/reference_dryrun_memory.py``: XLA's
# memory analysis of the module compiled for 256 / 512 host devices, Auto
# axes; computed from shapes, jax 0.9.0), and the most the port's dry run
# may read against it in a train_4k cell
REFERENCE_TEMP = {
    "qwen3-8b/train_4k/single": 18327156384,
    "qwen3-8b/train_4k/multi": 15955875744,
    "qwen3-8b/prefill_32k/single": 5721689008,
    "qwen3-8b/prefill_32k/multi": 3825732528,
    "codeqwen1.5-7b/train_4k/single": 14282041720,
    "codeqwen1.5-7b/train_4k/multi": 14284077432,
    "codeqwen1.5-7b/prefill_32k/single": 5785912304,
    "codeqwen1.5-7b/prefill_32k/multi": 3889955824,
    "h2o-danube-3-4b/train_4k/single": 19027575744,
    "h2o-danube-3-4b/train_4k/multi": 19542713536,
    "h2o-danube-3-4b/prefill_32k/single": 4588356336,
    "h2o-danube-3-4b/prefill_32k/multi": 2810888944,
    "mixtral-8x7b/train_4k/single": 38250894160,
    "mixtral-8x7b/train_4k/multi": 38264578656,
    "mixtral-8x7b/prefill_32k/single": 41046788200,
    "mixtral-8x7b/prefill_32k/multi": 20891027760,
    "deepseek-v2-236b/train_4k/single": 45555365496,
    "deepseek-v2-236b/train_4k/multi": 45602993856,
    "deepseek-v2-236b/prefill_32k/single": 53687092360,
    "deepseek-v2-236b/prefill_32k/multi": 26843546768}
REFERENCE_TEMP_TOL = 1.5


def head_arch(vocab: int):
    """qwen3-8b's smoke ``LMArch`` at one layer and ``vocab``, its
    attention in one block, with its ``train_4k`` cell cut to
    ``HEAD_CELL`` in one microbatch."""
    from ..configs import get_arch
    from ..configs.registry import ShapeCell
    base = get_arch("qwen3-8b")
    seq = HEAD_CELL["seq"]
    cfg = dataclasses.replace(base.smoke(), n_layers=1, vocab=vocab,
                              attn_q_block=seq, attn_k_block=seq)
    arch = type(base)("qwen3-8b", cfg, accum={"train_4k": 1})
    arch.shapes["train_4k"] = ShapeCell("train_4k", "train", dict(HEAD_CELL))
    return arch


def head_copies(data: int, model: int) -> dict:
    """The smoke head check's step at both ``HEAD_VOCABS`` on a fake
    (data, model) mesh -> {"temp_bytes": at each vocab, "logits_bytes":
    the difference of each rank's fp32 logits, "copies": Δtemp over it,
    "collectives_bytes": at the larger vocab}."""
    from .dryrun import fake_world, trace_cell
    from .mesh import make_local_mesh
    recs = {}
    for vocab in HEAD_VOCABS:
        with fake_world(data * model):
            recs[vocab] = trace_cell(head_arch(vocab), "train_4k",
                                     make_local_mesh(model=model,
                                                     device="cpu"))
    hi, lo = HEAD_VOCABS
    tokens = HEAD_CELL["batch"] * HEAD_CELL["seq"] // data
    logits = tokens * (hi - lo) // model * 4
    temp = [recs[v]["memory"]["temp_size_in_bytes"] for v in HEAD_VOCABS]
    return {"mesh": [data, model], "temp_bytes": temp,
            "logits_bytes": logits, "copies": (temp[0] - temp[1]) / logits,
            "collectives_bytes": recs[hi]["collectives_bytes"]}


def head_temp_ok(copies: dict) -> bool:
    """Whether no mesh of ``copies`` ({(data, model): the copies of each
    rank's logits, ``head_copies``}) holds more than ``HEAD_TOL`` times
    the (1, 1) mesh's."""
    one = copies[(1, 1)]
    return all(c <= HEAD_TOL * one for c in copies.values())


HEAD_WORKER = """
import json, sys
from repro_torch.launch import meshcheck
print(json.dumps(meshcheck.head_copies(int(sys.argv[1]), int(sys.argv[2])),
                 default=float))
"""


def check_memory(timeout: float = 600) -> dict:
    """The smoke head check: ``head_copies`` of every mesh of
    ``HEAD_MESHES``, each in a process of its own (a fake process group
    is global to its process), all at once, held by ``head_temp_ok`` ->
    {"meshes": each record, "ok", "s"}."""
    t0 = time.perf_counter()
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, "-c", HEAD_WORKER, str(d),
                               str(m)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for d, m in HEAD_MESHES]
    try:
        outs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    meshes = {}
    for (d, m), p, (out, err) in zip(HEAD_MESHES, procs, outs):
        if p.returncode:
            raise RuntimeError(f"the ({d}, {m}) trace exited {p.returncode}"
                               f": {err[-3000:]}")
        meshes[f"{d}x{m}"] = json.loads(out.strip().splitlines()[-1])
    ok = head_temp_ok({tuple(r["mesh"]): r["copies"]
                       for r in meshes.values()})
    return {"meshes": meshes, "ok": ok,
            "s": round(time.perf_counter() - t0, 1)}


PARTS = {"steps": check_steps, "traces": check_traces, "moe": check_moe,
         "attention": check_attention, "depth": check_depth,
         "memory": check_memory}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--part", choices=[*PARTS, "all"], default="all")
    args = ap.parse_args(argv)
    import torch
    out = {"torch": torch.__version__}
    for part, check in PARTS.items():
        if args.part in (part, "all"):
            out[part] = check()
    ok = all(out[k]["ok"] for k in PARTS if k in out)
    out["ok"] = ok
    print(json.dumps(out, default=float))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
