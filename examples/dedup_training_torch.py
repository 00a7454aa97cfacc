"""End-to-end driver on the PyTorch port: LM training with the dedup data
pipeline in front (the port of ``examples/dedup_training.py``).

    PYTHONPATH=src python examples/dedup_training_torch.py --device cpu
    PYTHONPATH=src python examples/dedup_training_torch.py --preset 100m \\
        --steps 300                                           # on the card

The corpus replays ~30% duplicate documents (web-crawl style); the
DedupPipeline (RLBSBF) zeroes their loss weights so the optimizer never
consumes a document twice. Fault tolerance is live: pass --inject-fault 40
to watch the trainer checkpoint-restore and keep going. The ``100m``
preset is the ~100M-param configuration for real hardware; the default
``cpu-small`` preset runs the identical code path at small dims.
Checkpoints go to ``--ckpt-dir``, by default a temporary directory that is
removed at the end.
"""

import argparse
import tempfile

import numpy as np

from repro_torch.convert import state_to_numpy
from repro_torch.launch.train import build


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="cpu-small")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dup-frac", type=float, default=0.3)
    ap.add_argument("--inject-fault", type=int, default=-1)
    ap.add_argument("--ckpt-dir", default=None)
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="dedup_training_") as tmp:
        trainer = build(args.preset, args.steps, args.dup_frac,
                        args.ckpt_dir or tmp, fault_at=args.inject_fault,
                        device=args.device)
        summary = trainer.run()

        losses = [h["loss"] for h in trainer.history]
        first, last = np.mean(losses[:10]), np.mean(losses[-10:])
        m = trainer.dedup.metrics.summary()
        print("\n=== end-to-end summary ===")
        print(f"steps:            {summary['steps']}")
        print(f"loss:             {first:.4f} -> {last:.4f}")
        print(f"stragglers:       {summary['stragglers']}")
        print(f"dedup throughput: {m['throughput_eps']:.0f} records/s")
        print(f"filter load:      {m['final_load']:.4f}")
        print(f"checkpoints at:   {trainer.ckpt.all_steps()}")
    return {"check": state_to_numpy(trainer.dedup.state),
            "losses": losses, "summary": summary, "trainer": trainer}


if __name__ == "__main__":
    main()
