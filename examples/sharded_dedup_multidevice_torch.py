"""Distributed dedup over a process group on the PyTorch port — the
production layout (the port of ``examples/sharded_dedup_multidevice.py``).

    PYTHONPATH=src python examples/sharded_dedup_multidevice_torch.py    # cards
    PYTHONPATH=src python examples/sharded_dedup_multidevice_torch.py \\
        --device cpu                                  # 8 gloo ranks

Key-space-partitioned RLBSBF filters over a process group with MoE-style
all-to-all routing (DESIGN.md §4): every rank ingests the stream, routes
keys to their owner shard, and the ensemble behaves as one filter with the
aggregate memory. The reference lays 8 simulated devices out as a
(data=4, model=2) mesh; here the group brings itself up: on the card NCCL
at one rank per card (a process each when there is more than one card),
with ``--device cpu`` 8 gloo ranks, each a process of its own, meeting at
a file store in a temporary directory. Beside the sharded run it prints
the one-filter row at the same aggregate memory.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.convert import state_to_numpy
from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.device import resolve_device
from repro_torch.dedup import (ShardedDedup, ShardedDedupConfig,
                               StreamMetrics, truth_from_stream)

BATCH = 8192
STEPS = 40
MEMORY = 1 << 20


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def run_rank(args, dev, rank: int, world: int) -> dict:
    """This rank's part over the group that is up; rank 0 prints and
    returns the check (digests of the global reports and the gathered
    state)."""
    part = not args.original_threefry
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"group: {world} ranks ({dist.get_backend()}) on {dev.type}"
        + (" — the reference's (data=4, model=2) mesh as 8 ranks"
           if world == 8 else ""))
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=MEMORY,
                                  batch_size=BATCH)
    sd = ShardedDedup(ShardedDedupConfig(base=cfg), device=dev,
                      partitionable=part)
    say(f"{sd.n_shards} shards x {sd.local_cfg.s} bits x "
        f"k={sd.local_cfg.k}")

    rng = np.random.default_rng(0)
    keys = rng.integers(0, 120_000, args.n).astype(np.uint32)
    state, dup, ovf = sd.run_stream(sd.init(), keys)
    gathered = sd.gather_state(state)
    dup, ovf = dup.cpu().numpy(), ovf.cpu().numpy()
    truth = truth_from_stream(keys)
    metrics = StreamMetrics()
    metrics.update(dup, truth, load=gathered.load.cpu(),
                   s_bits=sd.n_shards * sd.local_cfg.k * sd.local_cfg.s,
                   overflow=ovf)
    m = metrics.summary()
    n_batches = -(-args.n // BATCH)
    say(f"sharded  : FPR={m['fpr']:.4f} FNR={m['fnr']:.4f} "
        f"overflow={m['overflow']} "
        f"({n_batches} batches in one run_stream; stream shapes="
        f"{sd.stream_cache_size()})")
    leaves = state_to_numpy(gathered)
    if rank != 0:
        return {}

    single = Dedup(DedupConfig.for_variant("rlbsbf", memory_bits=MEMORY,
                                           batch_size=BATCH), dev,
                   partitionable=part)
    _, dup1 = single.run_stream(single.init(), keys)
    dup1 = dup1.cpu().numpy()
    print(f"1 filter : FPR={(dup1 & ~truth).sum()/(~truth).sum():.4f} "
          f"FNR={(~dup1 & truth).sum()/truth.sum():.4f}  (same aggregate "
          f"memory)")
    return {"n": args.n, "check": {"ranks": world, "dup": _digest(dup),
                      "n_dup": int(dup.sum()), "overflow": ovf.tolist(),
                      "state": {k: _digest(v) for k, v in leaves.items()},
                      "single_dup": _digest(dup1),
                      "single_n_dup": int(dup1.sum())}}


def _group(dev, rank: int, world: int, store: str) -> torch.device:
    kw = {}
    if dev.type == "cuda":
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"file://{store}", rank=rank,
                            world_size=world, **kw)
    return dev


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=STEPS * BATCH,
                    help="records in the stream")
    ap.add_argument("--ranks", type=int, default=None,
                    help="group size (default: one per card; 8 on the CPU)")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if "EXAMPLE_RANK" in os.environ:                  # a spawned rank
        rank, world = (int(os.environ[k]) for k in
                       ("EXAMPLE_RANK", "EXAMPLE_WORLD"))
        dev = _group(dev, rank, world, os.environ["EXAMPLE_STORE"])
        try:
            out = run_rank(args, dev, rank, world)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            print(json.dumps(out))
        return out
    world = args.ranks or (torch.cuda.device_count() if dev.type == "cuda"
                           else 8)
    with tempfile.TemporaryDirectory(prefix="sharded_example_") as tmp:
        if world == 1:                                # this process
            dev = _group(dev, 0, 1, f"{tmp}/store")
            try:
                return run_rank(args, dev, 0, 1)
            finally:
                dist.destroy_process_group()
        argv = [sys.executable, os.path.abspath(__file__),
                *(argv if argv is not None else sys.argv[1:])]
        procs = [subprocess.Popen(
            argv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env={**os.environ, "EXAMPLE_RANK": str(r),
                 "EXAMPLE_WORLD": str(world),
                 "EXAMPLE_STORE": f"{tmp}/store", "OMP_NUM_THREADS": "1"})
            for r in range(world)]
        try:
            outs = [p.communicate(timeout=1800) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    for r, (p, (_, err)) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} failed:\n{err[-3000:]}")
    lines = outs[0][0].strip().splitlines()
    print("\n".join(lines[:-1]))
    return json.loads(lines[-1])


if __name__ == "__main__":
    main()
