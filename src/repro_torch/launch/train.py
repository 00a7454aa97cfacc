"""End-to-end training driver of the port: dedup-gated LM training with
checkpointing, fault recovery and straggler monitoring (the counterpart of
``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --preset cpu-small \\
        --steps 200 --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --preset 100m

Presets: ``100m`` is the deployment configuration (~106.5M params, fp32);
``cpu-small`` runs the same code path at smaller dims. Duplicate documents
are injected by the corpus at --dup-frac and removed by the
``DedupPipeline`` (mode "drop", rlbsbf over 2^20 bits on dense8, whose step
launches the hashmix kernel on the card) before the optimizer sees them —
the paper's training-corpus application end to end. Everything runs on
``cuda`` unless ``--device cpu`` (or ``device="cpu"``) is given.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from ..core.config import DedupConfig
from ..core.device import resolve_device
from ..data.lm import lm_batches
from ..dedup.pipeline import DedupPipeline
from ..models import transformer as tfm
from ..optim import OptimizerConfig, init_opt_state
from ..train import Trainer, TrainerConfig, make_train_step

PRESETS = {
    "100m": dict(n_layers=10, d_model=640, n_heads=10, n_kv_heads=10,
                 d_ff=2560, vocab=32000, seq=1024, batch=32),
    "cpu-small": dict(n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
                      d_ff=512, vocab=512, seq=128, batch=8),
}


def preset_config(preset: str) -> tfm.TransformerConfig:
    p = PRESETS[preset]
    return tfm.TransformerConfig(
        name=f"lm-{preset}", n_layers=p["n_layers"], d_model=p["d_model"],
        n_heads=p["n_heads"], n_kv_heads=p["n_kv_heads"], d_ff=p["d_ff"],
        vocab=p["vocab"], dtype=torch.float32, attn_q_block=256,
        attn_k_block=256)


def build(preset: str, steps: int, dup_frac: float, ckpt_dir: str,
          fault_at: int = -1, seed: int = 0, device=None, params=None):
    """The trainer of ``preset``: params from the port's seeded init on
    ``device`` unless ``params`` (a ``Params`` tree on that device, e.g.
    converted reference weights) is given; AdamW (lr 1e-3, 20 warmup
    steps); the dedup pipeline; ``lm_batches``; a fault injected once at
    step index ``fault_at`` (>= 0)."""
    device = resolve_device(device)
    p = PRESETS[preset]
    cfg = preset_config(preset)
    if params is None:
        params = tfm.init(cfg, seed, device)
    n_params = sum(x.numel() for x in params.parameters())
    print(f"[train] {cfg.name}: {n_params/1e6:.1f}M params on {device}")

    opt_cfg = OptimizerConfig(kind="adamw", lr=1e-3, warmup_steps=20,
                              total_steps=steps)
    opt_state = init_opt_state(opt_cfg, params)

    def loss_fn(prm, tokens, weights):
        loss, _ = tfm.forward(cfg, prm, tokens, weights)
        return loss

    step = make_train_step(loss_fn, opt_cfg)
    dedup = DedupPipeline(
        DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20,
                                batch_size=p["batch"]),
        mode="drop", device=device)
    data = lm_batches(p["vocab"], p["batch"], p["seq"], dup_frac=dup_frac,
                      seed=seed)

    faults = {"armed": fault_at}

    def fault_hook(step_idx: int):
        if faults["armed"] >= 0 and step_idx == faults["armed"]:
            faults["armed"] = -1          # fire once
            raise RuntimeError("injected fault (node failure simulation)")

    return Trainer(
        TrainerConfig(total_steps=steps, ckpt_every=max(10, steps // 4),
                      ckpt_dir=ckpt_dir, log_every=max(1, steps // 20)),
        train_step=step, params=params, opt_state=opt_state, data=data,
        dedup=dedup,
        batch_to_inputs=lambda b: torch.from_numpy(b["tokens"]).to(device),
        fault_hook=fault_hook if fault_at >= 0 else None)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="cpu-small", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dup-frac", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--inject-fault", type=int, default=-1,
                    help="step index at which to simulate a node failure")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args()

    trainer = build(args.preset, args.steps, args.dup_frac, args.ckpt_dir,
                    fault_at=args.inject_fault, device=args.device)
    if args.resume and trainer.try_restore():
        print(f"[train] resumed from step {trainer.step}")
    t0 = time.perf_counter()
    summary = trainer.run()
    dt = time.perf_counter() - t0
    m = trainer.dedup.metrics.summary()
    print(f"[train] done in {dt:.1f}s: {summary}")
    print(f"[train] dedup: dropped-dup throughput={m['throughput_eps']:.0f}/s"
          f" final_load={m['final_load']}")
    first = np.mean([h["loss"] for h in trainer.history[:10]])
    last = np.mean([h["loss"] for h in trainer.history[-10:]])
    print(f"[train] loss {first:.4f} -> {last:.4f} "
          f"({'LEARNED' if last < first - 0.1 else 'check configuration'})")


if __name__ == "__main__":
    main()
