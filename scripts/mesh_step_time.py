"""Times one LM train step plain and through ``train.jit_sharded`` on a
(1, 1) ("data", "model") mesh over a one-rank process group: what the
port's placement costs on the host where nothing is split (``chip_smoke.py``
phase "mesh" runs the same step). Both forms start from one seeded state
and run on the same batches; prints the step times (host clock, each step
ending in the loss read) and, as its last line, one JSON object.

    PYTHONPATH=src python scripts/mesh_step_time.py                 # the card
    PYTHONPATH=src python scripts/mesh_step_time.py --device cpu \\
        --preset cpu-small

It runs on any checkout whose ``repro_torch`` has ``jit_sharded`` and the
trainer's presets, so one call can time two trees on one card
(``PYTHONPATH=<tree>/src``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import socket
import subprocess
import sys
import time


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no nvidia-smi"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--preset", default="100m")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import LMArch
    from repro_torch.distributed import sharding as shr
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.train import PRESETS, preset_config
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import init_opt_state
    from repro_torch.train import jit_sharded

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(args.device)
    dist.init_process_group(
        "nccl" if args.device == "cuda" else "gloo",
        init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        mesh = make_local_mesh(device=args.device)
        cfg = preset_config(args.preset)
        arch = LMArch(cfg.name, cfg)
        step = arch.step("train_4k")
        bs = shr.transformer_batch_specs(mesh)
        specs = (arch.param_specs(mesh), arch.opt_specs(mesh), bs["tokens"],
                 bs["weights"])
        p = PRESETS[args.preset]
        rng = np.random.default_rng(args.seed)
        batches = [(torch.from_numpy(rng.integers(
            0, cfg.vocab, (p["batch"], p["seq"] + 1)).astype(np.int32)).to(
                dev), torch.ones(p["batch"], device=dev))
            for _ in range(args.steps)]
        params = tfm.init(cfg, args.seed, dev)
        out = {"preset": args.preset, "device": args.device,
               "card": card_line() if args.device == "cuda" else None,
               "torch": torch.__version__,
               "repro_torch": os.path.dirname(os.path.dirname(
                   sys.modules["repro_torch"].__file__))}
        for form in ("plain", "sharded"):
            pr = copy.deepcopy(params)
            o = init_opt_state(arch.opt_config(), pr)
            fn = step if form == "plain" else jit_sharded(step, mesh, specs)
            ms, losses = [], []
            for t, w in batches:
                if args.device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                pr, o, m = fn(pr, o, t, w)
                loss = m["loss"]
                losses.append(float(loss.full_tensor() if hasattr(
                    loss, "full_tensor") else loss))
                ms.append((time.perf_counter() - t0) * 1e3)
            out[form] = {"ms": ms, "losses": losses}
            print(f"[mesh_step_time] {form}: step ms "
                  f"{[round(x, 1) for x in ms]}", flush=True)
        out["same_losses"] = out["plain"]["losses"] == \
            out["sharded"]["losses"]
    finally:
        dist.destroy_process_group()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
