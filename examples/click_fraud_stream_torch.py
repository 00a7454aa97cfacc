"""Click-fraud detection on the PyTorch port — the paper's §1 motivating
application (the port of ``examples/click_fraud_stream.py``).

    PYTHONPATH=src python examples/click_fraud_stream_torch.py           # card
    PYTHONPATH=src python examples/click_fraud_stream_torch.py --device cpu

A publisher injects bursts of replayed clicks into an organic zipf-skewed
clickstream. The advertising pipeline routes every click through the
RLBSBF DedupPipeline in 'flag' mode; flagged clicks are withheld from
billing. We report fraud recall/precision, and demo the same engine as a
serving-side response cache (ServeSession): duplicate score requests are
answered without recomputing the model.
"""

import argparse

import numpy as np

from repro_torch.core import DedupConfig
from repro_torch.data.streams import clickstream
from repro_torch.dedup import DedupPipeline
from repro_torch.serve import ServeSession

N = 500_000
BATCH = 4096
SERVE_N = 64 * 1024          # score requests, 1024 per call


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="clicks in the stream")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    part = not args.original_threefry

    data, truth, key_collisions = clickstream(args.n, fraud_frac=0.08,
                                              burst=25, seed=0)
    cfg = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 22,
                                  batch_size=BATCH)
    pipe = DedupPipeline(cfg, mode="flag", device=args.device,
                         partitionable=part)

    flags = []
    for i in range(0, args.n - BATCH + 1, BATCH):
        out = pipe.process({"key": data["key"][i:i + BATCH]})
        flags.append(out.dup)
    flags = np.concatenate([f.cpu().numpy() for f in flags]) if flags \
        else np.zeros(0, bool)
    t = truth[:len(flags)]

    tp = (flags & t).sum()
    fp = (flags & ~t).sum()
    fn = (~flags & t).sum()
    print(f"clicks processed:      {len(flags):,} "
          f"({pipe.metrics.throughput:,.0f}/s)")
    print(f"32-bit key collisions: {key_collisions} "
          f"(pairs the hashed key would have conflated — truth uses the "
          f"pairs)")
    print(f"fraud recall:          {tp/max(1, tp+fn):6.2%}")
    print(f"billing precision:     {tp/max(1, tp+fp):6.2%}  "
          f"(false-flag rate {fp/max(1,(~t).sum()):.3%})")
    conv = pipe.metrics.convergence_point()     # reads the loads back
    history = pipe.metrics.load_history
    print(f"filter load:           "
          f"{history[-1] if history else 0.0:.3f} "
          f"(converged batch {conv})")

    # ---- serving-side: duplicate score requests answered from cache --- //
    calls = {"n": 0}

    def score_model(batch):
        calls["n"] += len(batch["key"])
        return np.asarray(batch["key"], np.float64) % 97 / 97.0

    sess = ServeSession(DedupConfig.for_variant(
        "rlbsbf", memory_bits=1 << 20, batch_size=1024), score_model,
        device=args.device, partitionable=part)
    served = min(SERVE_N, args.n)
    values = []
    for i in range(0, served, 1024):
        values.append(sess.serve({"key": data["key"][i:i + 1024]}))
    print(f"\nserving cache hit rate: {sess.hit_rate:6.2%} "
          f"(model invoked for {calls['n']:,}/{served:,} requests)")
    return {"n": args.n, "check": {"flags": flags,
                      "load_history": np.asarray(history, np.float32),
                      "convergence": conv,
                      "served": np.concatenate(values) if values
                      else np.zeros(0),
                      "model_calls": calls["n"]}}


if __name__ == "__main__":
    main()
