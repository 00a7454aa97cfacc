"""Dynamic-batching serving front-end on the PyTorch port (DESIGN.md §5.2;
the port of ``examples/serving_frontend.py``).

    PYTHONPATH=src python examples/serving_frontend_torch.py             # card
    PYTHONPATH=src python examples/serving_frontend_torch.py --device cpu

The paper's request-shaped applications (URL probes, online transactions —
Section 1) are many CONCURRENT small requests, while the engine underneath
is fastest fed wide fixed-shape batches. ``ServeFrontend`` is the adapter:
concurrent ``submit()`` calls coalesce into micro-batches padded to fixed
BUCKETS (one step width per bucket, ever), one in-place engine step yields
the dedup verdicts, a vectorized response cache answers repeats without
recomputing, and admission control sheds overload with an explicit
``"retry"`` verdict instead of queueing without bound.

Below: 32 closed-loop clients drive a zipf-heavy request mix through the
front-end; then the same requests replay one-at-a-time through the
synchronous ``ServeSession`` loop (``--loop-n`` of them), and the recorded
admitted schedule is re-run through a fresh synchronous engine to prove
verdict parity.
"""

import argparse
import asyncio
import time

import numpy as np

from repro_torch.core import DedupConfig
from repro_torch.data.streams import zipf_stream
from repro_torch.serve import ServeFrontend, ServeSession, replay_schedule

N = 6_000
N_CLIENTS = 32
BUCKETS = (64, 256)

CFG = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 20, batch_size=64)


def score_fn(batch):
    """Stands in for the expensive per-request model (DESIGN.md §5)."""
    return np.asarray(batch["key"], np.float64) * 2.0


def requests(n: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    hot, _ = zipf_stream(n * 7 // 10, universe=800, a=1.2, seed=0)
    cold = rng.integers(0, 1 << 32, n - hot.size,
                        dtype=np.uint64).astype(np.uint32)
    return np.concatenate([hot, cold])[rng.permutation(n)]


async def drive(keys, device, part):
    fe = ServeFrontend(CFG, score_fn, buckets=BUCKETS, max_live_batches=4,
                       flush_timeout=2e-3, record_schedule=True,
                       device=device, partitionable=part)

    async def client(c):
        for k in keys[c::N_CLIENTS]:
            res = await fe.submit(int(k))
            if res.verdict == "ok":
                assert float(res.value) == 2.0 * int(k)  # answers stay exact

    async with fe:
        t0 = time.perf_counter()
        await asyncio.gather(*(client(c) for c in range(N_CLIENTS)))
        dt = time.perf_counter() - t0
    return fe, dt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="requests")
    ap.add_argument("--loop-n", type=int, default=None,
                    help="requests of the per-request loop (default: all)")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    part = not args.original_threefry
    keys = requests(args.n)

    fe, dt = asyncio.run(drive(keys, args.device, part))
    st = fe.stats()
    print(f"frontend: {st['completed']:,} served in {dt:.2f}s "
          f"({st['completed'] / dt:,.0f} qps), {st['batches']} "
          f"micro-batches, mean fill {st['mean_fill']:.0f}")
    print(f"  shed rate {st['shed_rate']:.3f}   cache hit rate "
          f"{st['cache_hit_rate']:.3f}   dup rate {st['dup_rate']:.3f}")
    print(f"  engine step widths: {st['process_cache']} "
          f"(<= one per bucket x donation flag — the §5.2 no-retrace "
          f"contract)")

    # the pre-frontend story: one synchronous serve() call per request
    loop_keys = keys[:args.loop_n] if args.loop_n is not None else keys
    sess = ServeSession(CFG, score_fn, buckets=BUCKETS, device=args.device,
                        partitionable=part)
    t0 = time.perf_counter()
    for k in loop_keys:
        sess.serve({"key": np.asarray([k], np.uint32)})
    dt_seq = time.perf_counter() - t0
    print(f"per-request loop: {len(loop_keys) / dt_seq:,.0f} qps over "
          f"{len(loop_keys):,} requests -> coalescing speedup "
          f"{(st['completed'] / dt) / (len(loop_keys) / dt_seq):.1f}x")

    # verdict parity: replay the recorded admitted schedule synchronously
    digest = fe.executor.digest()
    replayed = replay_schedule(CFG, fe.executor.schedule, device=args.device,
                               partitionable=part)
    assert replayed == digest
    print("schedule-replay parity: async verdicts == synchronous replay "
          "(DESIGN.md §5.2)")
    return {"check": {"session_dups": sess.n_flagged_dup,
                      "session_cached": sess.n_cached},
            "loop_n": len(loop_keys), "digest": digest,
            "schedule": fe.executor.schedule,
            "cfg": CFG, "stats": st}


if __name__ == "__main__":
    main()
