"""SBF vs RLBSBF, head to head on the port's plane layout (the port of
``examples/sbf_vs_rlbsbf.py``).

    PYTHONPATH=src python examples/sbf_vs_rlbsbf_torch.py               # card
    PYTHONPATH=src python examples/sbf_vs_rlbsbf_torch.py --device cpu

The paper's headline result (Sections 6-7) is RLBSBF beating Deng &
Rafiei's Stable Bloom Filter at the same memory. BOTH variants run packed
(``layout="planes"``) on the same Zipf-skewed synthetic clickstream at the
same memory budget: sbf through the counter-step kernel, rlbsbf through
the bitset-step kernel, each hand-written for the card. Where the
reference compares its Pallas backend with its jnp one, the port compares
devices: each variant runs on the card and on the CPU, whose plain
versions of the kernels are the referee, and the card's rows must be
bit-identical to them ("==cpu", else "DIVERGED"). With ``--device cpu``
only the CPU rows print; the comparison needs the card.
"""

import argparse
import time

import numpy as np

from repro_torch.core import Dedup, DedupConfig
from repro_torch.core.device import resolve_device
from repro_torch.data.streams import zipf_stream
from repro_torch.dedup import truth_from_stream

N = 200_000
MEMORY_BITS = 1 << 18                    # 32 KB — container-scaled (§8)
UNIVERSE = 60_000


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N, help="records in the stream")
    ap.add_argument("--original-threefry", action="store_true",
                    help="JAX's original threefry layout (jax < 0.5)")
    args = ap.parse_args(argv)
    n = args.n

    keys, _ = zipf_stream(n, universe=UNIVERSE, a=1.3, seed=42)
    truth = truth_from_stream(keys)
    print(f"stream: {n:,} zipf(1.3) records, {int((~truth).sum()):,} "
          f"distinct, {MEMORY_BITS // 8 // 1024} KB per structure\n")

    on_cpu = resolve_device(args.device).type == "cpu"
    devices = ("cpu",) if on_cpu else ("cpu", args.device)
    print(f"{'variant':8s} {'layout':8s} {'device':8s} "
          f"{'FPR %':>8s} {'FNR %':>8s} {'Melem/s':>8s} {'match':>8s}")
    check, match = {}, {}
    for variant in ("sbf", "rlbsbf"):
        cpu_dup = None
        for device in devices:
            cfg = DedupConfig.for_variant(variant, memory_bits=MEMORY_BITS,
                                          batch_size=8192, layout="planes")
            engine = Dedup(cfg, device,
                           partitionable=not args.original_threefry)
            _, dup = engine.run_stream(engine.init(), keys)   # first use
            dup.cpu()
            t0 = time.perf_counter()
            _, dup = engine.run_stream(engine.init(), keys)
            dup = dup.cpu().numpy()
            dt = time.perf_counter() - t0
            fpr = (dup & ~truth).sum() / (~truth).sum()
            fnr = (~dup & truth).sum() / truth.sum()
            if device == "cpu":
                cpu_dup = dup
                tag = ""
            else:
                match[variant] = bool(np.array_equal(dup, cpu_dup))
                tag = "==cpu" if match[variant] else "DIVERGED"
            print(f"{variant:8s} {'planes':8s} {str(engine.device):8s} "
                  f"{fpr * 100:8.3f} {fnr * 100:8.3f} {n / dt / 1e6:8.2f} "
                  f"{tag:>8s}")
        check[f"dup/{variant}"] = dup

    print("\nexpected: FNR(RLBSBF) well below FNR(SBF) at comparable FPR "
          "(paper §6.3)" + (", card rows bit-identical to the CPU's"
                            if not on_cpu else
                            "; the card-vs-CPU comparison needs the card"))
    return {"n": args.n, "check": check, "match": match}


if __name__ == "__main__":
    main()
