"""Tuning driver of the port — the counterpart of
``repro.launch.hillclimb``: trace a cell under one change to its config
or its sharding, record the roofline terms, and merge the (hypothesis,
change, terms) record by label into
``experiments/perf_iterations_torch.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --exp NAME|all

The experiments are the reference's, under its names, labels and
hypotheses: the dedup-stream ingest (packed layout, capacity factor),
deepseek-v2's decode_32k (MLA absorption, the latent cache's layout) and
train_4k (MoE dispatch, bf16 accumulation, microbatching), mixtral's
dispatch, qwen3-8b's KV projections in training and its decode cache
layout. Each traces its cell as ``launch.dryrun`` does — fake tensors on
a fake process group of the production mesh's 256 ranks, the step run
once under ``launch.analysis.analyze_step`` — through
``dryrun.trace_cell`` (an LM cell) or ``dryrun.dedup_dryrun``. A config
change is ``dataclasses.replace`` on the frozen ``TransformerConfig``; a
sharding change replaces ``distributed.sharding.transformer_cache_specs``
or ``transformer_param_specs`` (and ``train-bf16accum`` replaces
``train.steps.make_train_step``) for the experiment's duration, which
the registry looks up at call time.

The terms keep the reference's keys. Its ``loop_aware`` record rebuilds
the trip counts of scanned loops that XLA's cost analysis counts once;
the port's counters see every op that runs, so the terms come straight
from the analysis record: ``flops``, ``hbm_bytes`` (``bytes_accessed``,
the operand and result bytes of every op), ``coll_bytes``,
``temp_bytes`` and ``copies_bytes`` (the bytes of ``aten.copy_``,
``clone`` and ``_to_copy``), and the times at the card's rates
(``launch.hw``: ``PEAK_FLOPS_BF16``, ``HBM_BW``, ``ICI_BW``). ``trace_s``
stands where the reference has ``compile_s``. A decode_32k cell traces
in ~2 – 5 min on one host core, a train_4k cell in 4 – 61 min.

``dedup-overlap`` is the one experiment that runs on the card (or, with
``--device cpu``, on 8 gloo ranks): the reference's greedy sweep over
flag sets that a runtime reads once, here environment sets that NCCL,
the CUDA driver and torch's CPU thread pool read at communicator,
context or pool creation. Each set is timed in a fresh set of worker
processes (``--overlap-worker``: the pipelined swbf ingest, best of 3)
and accepted at more than 2% over the incumbent; a set no runtime of the
run's form reads is recorded as ``not-read-by-backend`` and not timed.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..configs import get_arch
from ..configs.registry import LMArch
from ..distributed import sharding as shr
from ..distributed.sharding import P
from . import dryrun
from .analysis import copy_bytes
from .hw import HBM_BW, ICI_BW, PEAK_FLOPS_BF16
from .mesh import make_production_mesh

OUT = "experiments/perf_iterations_torch.json"


def terms(rec: dict) -> dict:
    """The reference's roofline terms of one analysis record."""
    coll = rec["collectives_bytes"].get("total", 0)
    flops = rec["cost"]["flops"]
    hbm = rec["cost"]["bytes_accessed"]
    return {
        "flops": flops,
        "hbm_bytes": hbm,
        "coll_bytes": coll,
        "compute_s": flops / PEAK_FLOPS_BF16,
        "memory_s": hbm / HBM_BW,
        "collective_s": coll / ICI_BW,
        "temp_bytes": rec["memory"].get("temp_size_in_bytes"),
        "copies_bytes": copy_bytes(rec["cost"]),
    }


@contextlib.contextmanager
def production_world():
    """The single-pod production mesh (16, 16) over a fake 256-rank
    process group, for the duration."""
    with dryrun.fake_world(dryrun._n_chips(False)):
        yield make_production_mesh(False, device="cpu")


def lm_variant(arch_id: str, shape: str, label: str, hypothesis: str,
               mutate=None, accum=None) -> dict:
    base_arch = get_arch(arch_id)
    cfg = base_arch.cfg if mutate is None else mutate(base_arch.cfg)
    accum_map = dict(base_arch.accum)
    if accum is not None:
        accum_map[shape] = accum
    arch = LMArch(arch_id, cfg, accum=accum_map)
    with production_world() as mesh:
        rec = dryrun.trace_cell(arch, shape, mesh)
    return {"cell": f"{arch_id}/{shape}/single", "label": label,
            "hypothesis": hypothesis, **terms(rec),
            "trace_s": rec["trace_s"],
            "collectives_counts": rec["collectives_counts"]}


def dedup_variant(label: str, hypothesis: str, packed: bool,
                  capacity_factor: float, memory_mb: int = 512,
                  batch: int = 1 << 20) -> dict:
    rec = dryrun.dedup_dryrun(False, batch=batch, memory_mb=memory_mb,
                              packed=packed, capacity_factor=capacity_factor)
    return {"cell": f"dedup-stream/ingest_{batch}/single", "label": label,
            "hypothesis": hypothesis, **terms(rec),
            "trace_s": rec["trace_s"],
            "collectives_counts": rec["collectives_counts"]}


@contextlib.contextmanager
def replaced(module, name: str, value):
    """``module.name`` is ``value`` for the duration, then the original
    again."""
    orig = getattr(module, name)
    setattr(module, name, value)
    try:
        yield orig
    finally:
        setattr(module, name, orig)


def _map_named(fn, tree, name=None):
    """``fn(leaf name, spec)`` over a spec tree of dicts and lists (a list
    item's name is ``[i]``, as the reference's path key prints)."""
    if isinstance(tree, dict):
        return {k: _map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_named(fn, v, f"[{i}]") for i, v in enumerate(tree)]
    return fn(name, tree)


def _cache_rule(rule):
    """A ``transformer_cache_specs`` from ``rule(name, batch axes, ndim)``
    -> a spec, or None for a replicated leaf."""
    def specs(cfg, mesh, cache_shape):
        b = shr.batch_axes(mesh)
        out = {}
        for name, x in cache_shape.items():
            shape = tuple(x.shape) if hasattr(x, "shape") else tuple(x[0])
            spec = rule(name, b)
            out[name] = spec if spec is not None else \
                P(*(None for _ in shape))
        return out
    return specs


EXPERIMENTS = {}


def exp(name):
    def deco(fn):
        EXPERIMENTS[name] = fn
        return fn
    return deco


# ---------------- cell A: the paper's technique ------------------------- //

@exp("dedup-baseline")
def dedup_baseline():
    return dedup_variant(
        "A0-baseline-dense8-cap2",
        "paper-faithful layout: one byte per bit, capacity factor 2.0",
        packed=False, capacity_factor=2.0)


@exp("dedup-packed")
def dedup_packed():
    return dedup_variant(
        "A1-packed-uint32",
        "32 bits/word packing cuts filter-state HBM traffic ~8-32x "
        "(probe gathers words; scatter builds packed deltas)",
        packed=True, capacity_factor=2.0)


@exp("dedup-capacity")
def dedup_capacity():
    return dedup_variant(
        "A2-packed-cap1.25",
        "routing buffers (S,C) dominate all-to-all bytes; capacity 2.0 -> "
        "1.25 cuts them 1.6x at <1e-4 overflow (Poisson tail at B/S=4096)",
        packed=True, capacity_factor=1.25)


# ---------------- cell F: pipelined-ingest collective overlap ---------- //
# The §4.5 double-buffered carry pays off only when batch t + 1's
# dispatch exchange overlaps batch t's step: on the card that is the
# collective runtime's and the driver's call. Each set below is read once,
# when NCCL makes its communicator, when the CUDA context is made or when
# torch's CPU thread pool starts, so each is timed in fresh processes.

OVERLAP_ACCEPT = 1.02  # greedy accept threshold: >2% over the incumbent
OVERLAP_N = 1 << 17

# (label, environment, the runtime that reads it, hypothesis)
OVERLAP_CANDIDATES = (
    ("F1-nccl-high-priority", {"TORCH_NCCL_HIGH_PRIORITY": "1"}, "nccl",
     "NCCL's collectives on a high-priority stream: the pipelined "
     "carry's key/count exchange is scheduled ahead of the step's "
     "kernels instead of queueing behind them"),
    ("F2-one-device-connection", {"CUDA_DEVICE_MAX_CONNECTIONS": "1"},
     "cuda",
     "one hardware work queue: the exchange is issued in program order "
     "between the steps' kernels, the Megatron setting for overlapping "
     "communication with compute"),
    ("F3-nccl-ll-protocol", {"NCCL_PROTO": "LL"}, "nccl",
     "the low-latency protocol: the exchange moves tens of KB per batch, "
     "where LL's flag-in-word stores beat the Simple protocol's "
     "bandwidth"),
    ("F4-one-omp-thread", {"OMP_NUM_THREADS": "1"}, "cpu",
     "one intra-op thread per rank: the ranks' host work stops "
     "contending for the cores, so each rank's step and exchange "
     "interleave"),
)
# the runtimes each form of the run reads
OVERLAP_READERS = {"cuda": ("nccl", "cuda", "cpu"), "cpu": ("cpu",)}


def overlap_ranks(device: str) -> int:
    """One rank per card, or 8 gloo ranks on the CPU (the reference's 8
    simulated devices)."""
    return torch.cuda.device_count() if device != "cpu" else 8


def overlap_cell(ranks: int) -> str:
    return f"dedup-stream/pipelined_ingest_{ranks}rank/overlap"


def _overlap_time(extra_env: dict, device: str, ranks: int,
                  n: int = OVERLAP_N):
    """Elems/s of the worker under the environment set, or None when a
    rank failed: ``ranks`` fresh processes meeting at a file store."""
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    with tempfile.TemporaryDirectory(prefix="hillclimb_overlap_") as tmp:
        procs = []
        for r in range(ranks):
            env = {**os.environ, **extra_env, "RANK": str(r),
                   "WORLD_SIZE": str(ranks), "STORE": f"{tmp}/store"}
            env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                                       if env.get("PYTHONPATH") else "")
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.hillclimb",
                 "--overlap-worker", "--device", device, "--n", str(n)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True))
        try:
            outs = [p.communicate(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(p.returncode != 0 for p in procs):
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                print(f"[hillclimb] overlap worker failed:\n{err[-2000:]}",
                      file=sys.stderr)
        return None
    return float(json.loads(
        outs[0][0].strip().splitlines()[-1])["elems_per_s"])


def overlap_worker(device: str = "cuda", n: int = OVERLAP_N) -> dict:
    """One rank of the timed run (RANK / WORLD_SIZE / STORE from the
    environment, else a world of one): the paper-scale pipelined swbf
    ingest, the same global stream on every rank, best of 3 wall-clock
    after a first run. NCCL at one rank per card, or gloo on the CPU."""
    import torch.distributed as dist

    from ..core import DedupConfig
    from ..core.device import resolve_device
    from ..dedup import ShardedDedup, ShardedDedupConfig

    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    dev = resolve_device(device)
    with contextlib.ExitStack() as stack:
        store = os.environ.get("STORE")
        if store is None:
            store = stack.enter_context(tempfile.TemporaryDirectory(
                prefix="hillclimb_worker_")) + "/store"
        kw = {}
        if dev.type == "cuda":
            dev = torch.device("cuda", rank)
            torch.cuda.set_device(dev)
            kw["device_id"] = dev
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{store}", rank=rank,
                                world_size=world, **kw)
        stack.callback(dist.destroy_process_group)
        cfg = DedupConfig.for_variant("swbf", window=8, memory_bits=1 << 20,
                                      batch_size=16384, packed=True)
        sd = ShardedDedup(ShardedDedupConfig(base=cfg, pipeline=True),
                          device=dev)
        keys = np.random.default_rng(5).integers(
            0, 1 << 21, n).astype(np.uint32)

        def run():
            _, dup, _ = sd.run_stream(sd.init(), keys)
            return dup.cpu()

        run()                                  # first use: builds, warms
        best = float("inf")
        for _ in range(3):
            dist.barrier()
            t0 = time.perf_counter()
            dup = run()
            best = min(best, time.perf_counter() - t0)
        out = {"elems_per_s": n / best, "ranks": world,
               "backend": dist.get_backend(), "n": n,
               "dups": int(dup.sum())}
    if rank == 0:
        print(json.dumps(out))
    return out


def accept(best, eps) -> bool:
    """The greedy rule: a set is kept when it beats the incumbent by more
    than ``OVERLAP_ACCEPT``."""
    return eps is not None and best is not None and \
        eps > best * OVERLAP_ACCEPT


def overlap_sweep(device: str = "cuda", timer=None) -> list:
    """The greedy sweep: F0 under the default environment, each candidate
    on top of every set accepted so far, F* the union. ``timer(env)`` ->
    elems/s or None (default: the worker processes)."""
    ranks = overlap_ranks(device)
    timer = timer or (lambda env: _overlap_time(env, device, ranks))
    cell = overlap_cell(ranks)
    readers = OVERLAP_READERS["cpu" if device == "cpu" else "cuda"]
    base = timer({})
    rows = [{"cell": cell, "label": "F0-overlap-baseline",
             "hypothesis": "pipelined §4.5 ingest under default flags — "
                           "the incumbent every candidate must beat",
             "flags": [], "elems_per_s": base, "speedup": 1.0,
             "accepted": base is not None}]
    accepted, best = {}, base
    for label, env, reader, hypothesis in OVERLAP_CANDIDATES:
        row = {"cell": cell, "label": label, "hypothesis": hypothesis,
               "flags": [f"{k}={v}" for k, v in env.items()],
               "read_by": reader}
        if reader not in readers:
            row.update(status="not-read-by-backend", accepted=False)
        else:
            eps = timer({**accepted, **env})
            row["elems_per_s"] = eps
            row["speedup"] = (eps / base) if (eps and base) else None
            row["accepted"] = accept(best, eps)
            if row["accepted"]:
                accepted, best = {**accepted, **env}, eps
        rows.append(row)
    rows.append({"cell": cell, "label": "F*-overlap-accepted",
                 "hypothesis": "greedy union of every accepted set — the "
                               "flag line a deployment should export",
                 "accepted_flags": [f"{k}={v}" for k, v in accepted.items()],
                 "elems_per_s": best,
                 "speedup": (best / base) if (best and base) else None,
                 "accepted": True})
    return rows


@exp("dedup-overlap")
def dedup_overlap(device: str = "cuda"):
    return overlap_sweep(device)


# ---------------- cell B: deepseek decode (memory-bound) --------------- //

@exp("mla-noabsorb")
def mla_noabsorb():
    return lm_variant(
        "deepseek-v2-236b", "decode_32k", "B0-baseline-naive-mla",
        "straightforward MLA decode re-materializes per-head K/V from the "
        "latent over all 32k cached positions each step",
        mutate=lambda c: dataclasses.replace(c, mla_absorb=False))


@exp("mla-absorb")
def mla_absorb():
    return lm_variant(
        "deepseek-v2-236b", "decode_32k", "B1-absorbed-mla",
        "absorbing W_uk/W_uv into the query/output projections keeps "
        "attention in the 576-dim latent: kills the S*H*(nope+v) "
        "re-materialization flops AND its HBM traffic",
        mutate=lambda c: dataclasses.replace(c, mla_absorb=True))


def _seq_latent(name, b):
    if name in ("ckv", "kpe"):
        return P(None, b, "model", None)
    if name == "kpos":
        return P(None, b, "model")
    return None


@exp("mla-seqcache")
def mla_seqcache():
    with replaced(shr, "transformer_cache_specs", _cache_rule(_seq_latent)):
        return lm_variant(
            "deepseek-v2-236b", "decode_32k", "B2-absorbed+seq-cache",
            "after absorbing, the collective term is the latent-dim-sharded "
            "cache being re-gathered per step; sequence-sharding the latent "
            "cache keeps attention psum-only like the qwen3 D1 win",
            mutate=lambda c: dataclasses.replace(c, mla_absorb=True))


# ---------------- cell C: deepseek train (MoE) -------------------------- //

@exp("moe-einsum")
def moe_einsum():
    return lm_variant(
        "deepseek-v2-236b", "train_4k", "C0-baseline-gshard-einsum",
        "GShard dense dispatch (tokens,E,C) einsums — the faithful TPU-MoE "
        "baseline; predicted to exceed expert flops at E=160 top-6",
        mutate=lambda c: dataclasses.replace(c, moe_dispatch="einsum"))


@exp("moe-sort")
def moe_sort():
    return lm_variant(
        "deepseek-v2-236b", "train_4k", "C1-sort-dispatch",
        "argsort token-copies by expert + grouped matmul: dispatch cost "
        "O(T*k) data movement, independent of E -> compute term drops to "
        "the true expert flops",
        mutate=lambda c: dataclasses.replace(c, moe_dispatch="sort"))


@exp("train-bf16accum")
def train_bf16accum():
    from ..train import steps
    orig = steps.make_train_step

    def bf16_accum(loss_fn, opt_cfg, accum_steps=1, accum_dtype=None):
        return orig(loss_fn, opt_cfg, accum_steps, accum_dtype=torch.bfloat16)

    with replaced(steps, "make_train_step", bf16_accum):
        return lm_variant(
            "deepseek-v2-236b", "train_4k", "C2-sort+bf16-accum",
            "fp32 grad-accum buffers are ~3.7GB/device x 2-3 live copies; "
            "bf16 accumulation halves them (optimizer moments stay fp32)")


@exp("train-accum16")
def train_accum16():
    return lm_variant(
        "deepseek-v2-236b", "train_4k", "C3-accum16",
        "halving the microbatch (accum 8->16) halves activation "
        "checkpoints + MoE transients; trades 2x more all-reduce rounds "
        "of the same total gradient bytes",
        accum=16)


@exp("mixtral-einsum")
def mixtral_einsum():
    return lm_variant(
        "mixtral-8x7b", "train_4k", "E0-mixtral-gshard-einsum",
        "inverse prediction of C0/C1: at E=8 top-2 the GShard dispatch "
        "einsums cost ~84 MFLOP/token vs 78 GFLOP/token of experts (0.1%) "
        "— einsum dispatch should be FINE here",
        mutate=lambda c: dataclasses.replace(c, moe_dispatch="einsum"))


@exp("mixtral-sort")
def mixtral_sort():
    return lm_variant(
        "mixtral-8x7b", "train_4k", "E1-mixtral-sort",
        "sort dispatch should be ~neutral at E=8 (the crossover between "
        "dispatch strategies is expert-count-driven, not a universal win)",
        mutate=lambda c: dataclasses.replace(c, moe_dispatch="sort"))


# ---------------- cell C': qwen3 train (most collective-bound) ---------- //

@exp("qwen3-train-baseline")
def qwen3_train_baseline():
    return lm_variant(
        "qwen3-8b", "train_4k", "C'0-baseline-hd-sharded-kv",
        "kv=8 heads don't divide model=16, so wk/wv shard head_dim; every "
        "flash kv-block then needs cross-shard reduction — thousands of "
        "all-gathers/all-reduces per step inside the layer x accum loops")


@exp("qwen3-train-kvrep")
def qwen3_train_kvrep():
    orig = shr.transformer_param_specs

    def kvrep_specs(cfg, mesh, params_shape, fsdp=False):
        return _map_named(
            lambda name, spec: P(*(None for _ in spec))
            if name in ("wk", "wv") else spec,
            orig(cfg, mesh, params_shape, fsdp=fsdp))

    with replaced(shr, "transformer_param_specs", kvrep_specs):
        return lm_variant(
            "qwen3-8b", "train_4k", "C'1-replicated-kv+expand",
            "Megatron GQA treatment: replicate the small wk/wv (16M params), "
            "expand K/V to the 32 query heads pre-attention (no (Kv,G) "
            "grouping reshape) — attention shards on H and goes "
            "collective-free; costs 16x duplicated KV-proj flops "
            "(~0.5% of layer flops)",
            mutate=lambda c: dataclasses.replace(c, gqa_expand_kv=True))


# ---------------- bonus: qwen3 decode cache layout ---------------------- //

def _hd_sharded(name, b):
    if name in ("k", "v"):
        return P(None, b, None, None, "model")
    if name in ("ckv", "kpe"):
        return P(None, b, None, "model")
    if name == "kpos":
        return P(None, b, None)
    return None


def _seq_sharded(name, b):
    if name in ("k", "v"):
        return P(None, b, "model", None, None)
    if name in ("ckv", "kpe"):
        return P(None, b, "model", None)
    if name == "kpos":
        return P(None, b, "model")
    return None


@exp("qwen3-decode-baseline")
def qwen3_decode_baseline():
    """Baseline = the pre-optimization head_dim-sharded cache (the rule
    that was default before §Perf D promoted sequence sharding)."""
    with replaced(shr, "transformer_cache_specs", _cache_rule(_hd_sharded)):
        return lm_variant(
            "qwen3-8b", "decode_32k", "D0-baseline-hd-sharded-cache",
            "kv=8 < model=16 so the cache shards head_dim; SPMD reports "
            "involuntary full remat (full-cache copies) at the attention "
            "einsum")


@exp("qwen3-decode-seqshard")
def qwen3_decode_seqshard():
    with replaced(shr, "transformer_cache_specs", _cache_rule(_seq_sharded)):
        return lm_variant(
            "qwen3-8b", "decode_32k", "D1-seq-sharded-cache",
            "shard the cache on the sequence dim instead (2048 slots/dev): "
            "attention becomes a psum over sequence shards and the "
            "partitioner's full-cache remat copies disappear")


def _print(rec: dict) -> None:
    if "compute_s" in rec:
        temp = rec["temp_bytes"] / 1e9 if rec["temp_bytes"] else 0
        print(f"[hillclimb] {rec['label']}: "
              f"compute={rec['compute_s']:.4f}s "
              f"memory={rec['memory_s']:.4f}s "
              f"collective={rec['collective_s']:.4f}s "
              f"temp={temp:.1f}GB copies={rec['copies_bytes'] / 1e9:.1f}GB "
              f"trace={rec['trace_s']}s")
        return
    eps = rec.get("elems_per_s")
    line = (f"eps={eps:,.0f} " if eps else
            f"{rec.get('status', 'no measurement')} ")
    if rec.get("speedup"):
        line += f"speedup={rec['speedup']:.3f}x "
    print(f"[hillclimb] {rec['label']}: {line}"
          f"flags={rec.get('accepted_flags', rec.get('flags'))} "
          f"accepted={rec.get('accepted')}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exp", help=f"one of {sorted(EXPERIMENTS)} or 'all'")
    ap.add_argument("--device", default="cuda",
                    help="where dedup-overlap and its worker run (cuda; "
                         "cpu: gloo ranks); the dry-run experiments trace "
                         "on the host")
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--overlap-worker", action="store_true",
                    help="run one rank of the timed overlap ingest")
    ap.add_argument("--n", type=int, default=OVERLAP_N,
                    help="records of the overlap worker's stream")
    args = ap.parse_args(argv)
    if args.overlap_worker:
        overlap_worker(args.device, args.n)
        return 0
    if not args.exp:
        ap.error("--exp is required")
    if args.exp != "all" and args.exp not in EXPERIMENTS:
        ap.error(f"--exp: one of {sorted(EXPERIMENTS)} or 'all'")
    names = sorted(EXPERIMENTS) if args.exp == "all" else [args.exp]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    for name in names:
        recs = (dedup_overlap(args.device) if name == "dedup-overlap"
                else EXPERIMENTS[name]())
        for rec in recs if isinstance(recs, list) else [recs]:
            results[:] = [r for r in results if r["label"] != rec["label"]]
            results.append(rec)
            _print(rec)
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
