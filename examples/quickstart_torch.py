"""Quickstart on the PyTorch port: streaming de-duplication with the
paper's structures (the port of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py               # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Builds each of the five structures (SBF baseline + RSBF/BSBF/BSBFSD/RLBSBF),
streams 2M records with 60% distinct through them at the same memory budget,
and prints the paper's headline comparison (Section 6.3): FNR ordering at
comparable FPR. The engine runs on the card unless ``--device cpu``; the
first variant's time includes the kernel build, as the reference's first
includes its compile.
"""

import argparse
import time

from repro_torch.core import Dedup, DedupConfig
from repro_torch.data.streams import controlled_distinct_stream

N = 2_000_000
MEMORY_BITS = 2 * 1024 * 1024 * 8       # 2 MB — 1/256 of the paper's 512 MB
VARIANTS = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="records in the stream")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)

    keys, truth_dup = controlled_distinct_stream(args.n, distinct_frac=0.6,
                                                 seed=0)
    print(f"stream: {args.n:,} records, {int((~truth_dup).sum()):,} "
          f"distinct")
    print(f"{'variant':8s} {'k':>2s} {'FPR %':>8s} {'FNR %':>8s} "
          f"{'Melem/s':>8s}")
    check = {}
    for variant in VARIANTS:
        cfg = DedupConfig.for_variant(variant, memory_bits=MEMORY_BITS,
                                      batch_size=8192)
        engine = Dedup(cfg, args.device,
                       partitionable=not args.original_threefry)
        state = engine.init()
        t0 = time.perf_counter()
        state, reported_dup = engine.run_stream(state, keys)
        reported_dup = reported_dup.cpu().numpy()
        dt = time.perf_counter() - t0
        fpr = (reported_dup & ~truth_dup).sum() / (~truth_dup).sum()
        fnr = (~reported_dup & truth_dup).sum() / truth_dup.sum()
        print(f"{variant:8s} {cfg.k:2d} {fpr*100:8.3f} {fnr*100:8.3f} "
              f"{args.n/dt/1e6:8.2f}")
        check[f"dup/{variant}"] = reported_dup

    print("\nexpected (paper §6.3): FNR  SBF >> RSBF > BSBF > BSBFSD > "
          "RLBSBF")
    return {"n": args.n, "check": check}


if __name__ == "__main__":
    main()
