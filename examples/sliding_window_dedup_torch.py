"""Sliding-window dedup on the PyTorch port (variant="swbf", DESIGN.md
§3.7; the port of ``examples/sliding_window_dedup.py``).

    PYTHONPATH=src python examples/sliding_window_dedup_torch.py          # card
    PYTHONPATH=src python examples/sliding_window_dedup_torch.py --device cpu

Windowed semantics are the main deployment mode the paper's whole-stream
structures don't cover: "has this click/request/record appeared in the last
N batches?" — after that, the SAME key must count as fresh again (billing
windows, rate limiting, replay detection with a TTL). The swbf rides the
counter-plane path: arriving batches increment their cells' counters, the
batch expiring from the window decrements exactly what it inserted (event
ring in FilterState), so the filter never fills up — load oscillates
around the window occupancy instead of saturating.

The stream below mixes hot keys that re-fire INSIDE the window (must be
flagged — below counter saturation the probe has no false negatives) with
sessions that return AFTER their window expired (must be forgotten). The
card's first 8 batches are then held bit for bit against the same engine
on the CPU, where the kernels' plain versions run (the reference holds
its Pallas kernel against its jnp step there).
"""

import argparse
import time

import numpy as np

from repro_torch.core import Dedup, DedupConfig, state_memory_bytes
from repro_torch.core.device import resolve_device
from repro_torch.dedup import StreamMetrics, windowed_truth_from_stream

N = 200_000
BATCH = 4096
WINDOW = 8          # batches — keys older than 8·4096 elements are forgotten


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="records in the stream")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    n, part = args.n, not args.original_threefry

    rng = np.random.default_rng(0)
    # hot keys: re-fire every ~2 batches (inside the window) — true dups
    # cold sessions: return every ~20 batches (outside) — must read fresh
    hot = rng.integers(0, 2_000, n // 2).astype(np.uint32)
    cold_period = 20 * BATCH
    cold = (np.arange(n - n // 2) % cold_period + (1 << 20)).astype(np.uint32)
    keys = np.empty(n, np.uint32)
    keys[0::2], keys[1::2] = hot, cold
    truth = windowed_truth_from_stream(keys, WINDOW, BATCH)

    cfg = DedupConfig.for_variant("swbf", memory_bits=1 << 22,
                                  batch_size=BATCH, window=WINDOW)
    print(f"swbf: {cfg.s:,} cells x {cfg.cbf_bits} bits, k={cfg.k}, "
          f"window={WINDOW} batches ({WINDOW * BATCH:,} elements)")

    engine = Dedup(cfg, args.device, partitionable=part)
    state = engine.init()
    print(f"state (planes + event ring): {state_memory_bytes(state):,} B")

    metrics = StreamMetrics()
    engine.run_stream(engine.init(), keys)[1].cpu()   # first use at full shape
    t0 = time.perf_counter()
    state, dup = engine.run_stream(state, keys)
    dup = dup.cpu().numpy()
    dt = time.perf_counter() - t0
    metrics.update(dup, truth, load=state.load, s_bits=cfg.s)
    s = metrics.summary()
    fn = (~dup & truth).sum()
    print(f"windowed FPR: {s['fpr']:.4f}   windowed FNR: {s['fnr']:.4f} "
          f"({fn} false negatives — only cells clipped at the "
          f"{cfg.cbf_bits}-bit counter cap can forget early)")
    occupancy = int(state.load[0]) / cfg.s
    print(f"window occupancy (nonzero cells / cells): {occupancy:.3f}")
    print(f"throughput: {n / dt:,.0f} elems/s (after a first run)")

    match = None
    if resolve_device(args.device).type == "cpu":
        print("card vs CPU window step: the comparison needs the card")
    else:
        cpu = Dedup(cfg, "cpu", partitionable=part)
        _, dup_c = cpu.run_stream(cpu.init(), keys[:8 * BATCH])
        match = bool(np.array_equal(dup_c.numpy(), dup[:8 * BATCH]))
        assert match, "the card's window kernels diverged from the CPU"
        print("card window kernels: bit-identical to the CPU's plain step")
    return {"n": args.n, "check": {"dup": dup, "load": state.load.cpu().numpy(),
                      "bits": state.bits.cpu().numpy()},
            "match": match}


if __name__ == "__main__":
    main()
