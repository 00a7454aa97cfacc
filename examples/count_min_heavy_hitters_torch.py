"""Counting sketches as pure sketch-template config on the PyTorch port
(DESIGN.md §3.8; the port of ``examples/count_min_heavy_hitters.py``).

    PYTHONPATH=src python examples/count_min_heavy_hitters_torch.py       # card
    PYTHONPATH=src python examples/count_min_heavy_hitters_torch.py --device cpu

Two sketches the paper's 1-bit structures can't express, each one
`SketchSpec` registry entry consumed by the same counter step as every
other counting variant:

  * variant="cms" — count-min membership: d-bit saturating counters, no
    deletions. The dup verdict is `estimate >= count_threshold`, and
    `Dedup.estimate(state, keys)` serves per-key frequency estimates on the
    side (min over the k probed cells — never under-counts while the cells
    are below the 2^d - 1 cap).
  * variant="hh" — heavy hitters: the same counters with a high threshold
    and no intra-batch seen-OR — the verdict means "this key is HOT", and
    `Dedup.top_cells` surfaces the highest-load cells for monitoring.

The zipf stream below has a handful of keys carrying most of the mass —
the shape where per-key counts matter and membership alone is not enough.
At the end the card's first 4 batches are held bit for bit against the
same engine on the CPU, where the kernels' plain versions run (the
reference holds its Pallas kernel against its jnp step there).
"""

import argparse

import numpy as np

from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.device import resolve_device
from repro_torch.dedup import StreamMetrics

N = 100_000
BATCH = 4096


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="records in the stream")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    n, dev, part = args.n, args.device, not args.original_threefry

    rng = np.random.default_rng(0)
    keys = (rng.zipf(1.3, n) % 50_000).astype(np.uint32)
    true_counts = np.bincount(keys, minlength=50_000)

    # ------------------------------------------------------------ count-min //
    cfg = DedupConfig.for_variant("cms", memory_bits=1 << 22,
                                  batch_size=BATCH)
    print(f"cms: {cfg.s:,} cells x {cfg.count_bits} bits, k={cfg.k}, "
          f"threshold={cfg.count_threshold}")
    eng = Dedup(cfg, dev, partitionable=part)
    state, dup = eng.run_stream(eng.init(), keys)
    dup = dup.cpu().numpy()
    print(f"dup verdicts (estimate >= {cfg.count_threshold}): "
          f"{int(dup.sum()):,} / {n:,}")

    probe = np.argsort(true_counts)[-8:][::-1].astype(np.uint32)  # hottest
    est = eng.estimate(state, probe).cpu().numpy()
    cap = (1 << cfg.count_bits) - 1
    print("key        true  estimate   (estimate >= min(true, cap) always)")
    for k, e in zip(probe, est):
        t = true_counts[k]
        assert e >= min(t, cap)
        print(f"{k:>8}  {t:>5}  {e:>8}{'  (at cap)' if e == cap else ''}")

    # ---------------------------------------------------------- heavy hitters //
    hh_cfg = DedupConfig.for_variant("hh", memory_bits=1 << 22,
                                     batch_size=BATCH)
    hh = Dedup(hh_cfg, dev, partitionable=part)
    hh_state, flagged = hh.run_stream(hh.init(), keys)
    flagged = flagged.cpu().numpy()
    hot = set(keys[flagged].tolist())
    print(f"\nhh (threshold={hh_cfg.count_threshold}): {flagged.sum():,} "
          f"arrivals flagged, {len(hot)} distinct hot keys")

    cells, counts = hh.top_cells(hh_state, m=8)
    metrics = StreamMetrics()
    metrics.update(flagged, None)
    metrics.record_heavy_hitters(cells, counts)
    print("top-load cells (cell id, count upper bound):",
          metrics.summary()["heavy_hitters"])

    # every hot key's true count really crossed the threshold (counters
    # only over-estimate, so the flag has no false negatives below
    # saturation)
    assert all(true_counts[k] >= hh_cfg.count_threshold for k in hot)

    match = None
    if resolve_device(dev).type == "cpu":
        print("card vs CPU counting kernels: the comparison needs the card")
    else:
        cpu = Dedup(cfg, "cpu", partitionable=part)
        _, dup_c = cpu.run_stream(cpu.init(), keys[:4 * BATCH])
        match = bool(np.array_equal(dup_c.numpy(), dup[:4 * BATCH]))
        assert match, "the card's counting kernels diverged from the CPU"
        print("card counting kernels: bit-identical to the CPU's plain step")
    return {"n": args.n, "check": {"dup": dup, "probe": probe, "estimate": est,
                      "flagged": flagged,
                      "top_cells": cells.cpu().numpy(),
                      "top_counts": counts.cpu().numpy()},
            "match": match}


if __name__ == "__main__":
    main()
