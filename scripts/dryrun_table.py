"""The dry run's tables from its records: every cell of two runs (two
torch versions) side by side, the per-layer count against full-depth
traces, and each LM train and prefill cell against the count of its
shapes. Reads directories of ``python -m repro_torch.launch.dryrun``
output files (each a JSON list of cell records, one process per cell).
Computed from shapes on a CPU, never measured.

    PYTHONPATH=src python scripts/dryrun_table.py --a DIR_2.13 --b DIR_2.11 \\
        [--full-a DIR] [--full-b DIR] [--before DIR] [--reference]

``--before DIR``: each traced cell's temp against an earlier run's (a
rise is flagged), with its flops and collective bytes over the earlier
ones. ``--reference``: each LM train_4k and prefill_32k cell's temp
against the reference's (``meshcheck.REFERENCE_TEMP``, from
``scripts/reference_dryrun_memory.py``), a train cell's held to
``REFERENCE_TEMP_TOL`` times it, and arguments plus temp to the card's
memory.
"""

import argparse
import glob
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from dryrun_breakdown import lm_prefill_count, lm_train_count  # noqa: E402

from repro_torch.configs import all_arch_ids, get_arch  # noqa: E402
from repro_torch.launch.hw import CHIP_HBM_BYTES  # noqa: E402
from repro_torch.launch.meshcheck import (REFERENCE_TEMP,  # noqa: E402
                                          REFERENCE_TEMP_TOL)

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all")
AGREE = 0.01


def records(path: str) -> dict:
    """{(arch, shape, mesh): record} of every file in a directory."""
    out = {}
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        for r in json.load(open(f)):
            out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def g(x) -> str:
    return f"{x / 1e9:.3g}"


def entry(r) -> str:
    """arguments + temp GB; TFLOP; the four kinds' GB; trace s."""
    if r is None:
        return "not run"
    if "skipped" in r:
        return "skipped by rule"
    if "error" in r:
        return "error: " + r["error"][:80]
    m, c = r["memory"], r["collectives_bytes"]
    over = m["argument_size_in_bytes"] + m["temp_size_in_bytes"] > \
        CHIP_HBM_BYTES
    return (f"{g(m['argument_size_in_bytes'])} + "
            f"{g(m['temp_size_in_bytes'])}{' **over**' if over else ''}; "
            f"{r['cost']['flops'] / 1e12:.4g}; "
            + " · ".join(g(c.get(k, 0)) for k in KINDS)
            + f"; {r['trace_s']:.0f} s")


def agree(a, b) -> str:
    """"the same" where flops, argument bytes, temp and collective bytes
    agree within AGREE, else what differs."""
    if a is None or b is None or "cost" not in a or "cost" not in b:
        return entry(b)
    terms = {"flops": (a["cost"]["flops"], b["cost"]["flops"]),
             "arguments": (a["memory"]["argument_size_in_bytes"],
                           b["memory"]["argument_size_in_bytes"]),
             "temp": (a["memory"]["temp_size_in_bytes"],
                      b["memory"]["temp_size_in_bytes"]),
             "collectives": (a["collectives_bytes"].get("total", 0),
                             b["collectives_bytes"].get("total", 0))}
    off = [f"{k} {x:.4g} vs {y:.4g}" for k, (x, y) in terms.items()
           if abs(x - y) > AGREE * max(abs(x), abs(y), 1)]
    return "the same" if not off else "; ".join(off)


def shape_ratio(key, r) -> str:
    arch_id, shape, mesh = key
    if r is None or "cost" not in r:
        return ""
    arch = get_arch(arch_id)
    if arch.family != "lm":
        return ""
    kind = arch.shapes[shape].kind
    n = 512 if mesh == "multi" else 256
    if kind == "train":
        return (f"{r['cost']['flops'] / lm_train_count(arch, n):.3f} "
                f"({r['cost']['flops'] / lm_train_count(arch, n, True):.3f}"
                f" as computed)")
    if kind == "prefill":
        return f"{r['cost']['flops'] / lm_prefill_count(arch, n, shape):.3f}"
    return ""


def traced(r) -> bool:
    return r is not None and "cost" in r


def before_table(before: dict, a: dict) -> None:
    """Every cell traced in both runs: temp before and now (a rise
    flagged), and flops and collective bytes now over before."""
    print("| Cell | temp GB before -> now | flops now / before | "
          "collective bytes now / before |\n| --- | --- | --- | --- |")
    rises = 0
    for key in sorted(a):
        r, o = a[key], before.get(key)
        if not (traced(r) and traced(o)):
            continue
        t0, t1 = (x["memory"]["temp_size_in_bytes"] for x in (o, r))
        rises += t1 > t0

        def over(x, y):
            return f"{x / y:.4f}" if y else ("1" if x == y else "inf")

        print(f"| {' '.join(key)} | {g(t0)} -> {g(t1)}"
              f"{' **rose**' if t1 > t0 else ''} | "
              f"{over(r['cost']['flops'], o['cost']['flops'])} | "
              + over(r["collectives_bytes"].get("total", 0),
                     o["collectives_bytes"].get("total", 0)) + " |")
    print(f"\n{rises} cells' temp rose\n")


def reference_table(a: dict) -> None:
    """The LM train_4k and prefill_32k cells' temp against the
    reference's, single / multi mesh."""
    print("| Cell | temp GB single / multi: port | reference | port / "
          "reference | args + temp GB |\n| --- | --- | --- | --- | --- |")
    bad = 0
    for arch_id in all_arch_ids():
        for shape in ("train_4k", "prefill_32k"):
            keys = [f"{arch_id}/{shape}/{m}" for m in ("single", "multi")]
            if keys[0] not in REFERENCE_TEMP:
                continue
            rs = [a.get(tuple(k.split("/"))) for k in keys]
            if not all(traced(r) for r in rs):
                print(f"| {arch_id} {shape} | not traced | | | |")
                continue
            port = [r["memory"]["temp_size_in_bytes"] for r in rs]
            ref = [REFERENCE_TEMP[k] for k in keys]
            total = [r["memory"]["argument_size_in_bytes"] + t
                     for r, t in zip(rs, port)]
            over = [t > CHIP_HBM_BYTES for t in total] + (
                [p > REFERENCE_TEMP_TOL * f for p, f in zip(port, ref)]
                if shape == "train_4k" else [])
            bad += any(over)
            print(f"| {arch_id} {shape} | "
                  + " / ".join(g(t) for t in port) + " | "
                  + " / ".join(g(t) for t in ref) + " | "
                  + " / ".join(f"{p / f:.2f}" for p, f in zip(port, ref))
                  + " | " + " / ".join(g(t) for t in total)
                  + (" **over**" if any(over) else "") + " |")
    print(f"\n{bad} cells over a bound (a train cell above "
          f"{REFERENCE_TEMP_TOL}x the reference's temp, any cell above "
          f"{CHIP_HBM_BYTES / 2**30:.0f} GiB of arguments and temp)\n")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--a", required=True, help="records of torch A")
    ap.add_argument("--b", help="records of torch B")
    ap.add_argument("--full-a", help="full-depth records of torch A")
    ap.add_argument("--full-b", help="full-depth records of torch B")
    ap.add_argument("--before", help="an earlier run's records of A's "
                                     "torch")
    ap.add_argument("--reference", action="store_true",
                    help="the LM train / prefill cells' temp against the "
                         "reference's")
    args = ap.parse_args()
    a = records(args.a)
    b = records(args.b) if args.b else {}
    if args.before:
        before_table(records(args.before), a)
    if args.reference:
        reference_table(a)
    print("| Cell | A: args + temp GB; TFLOP; AG · AR · RS · A2A GB; "
          "trace | B against A | flops / shape count (train: also against "
          "the count as both packages compute it) |")
    print("| --- | --- | --- | --- |")
    n_traced = n_skip = n_same = 0
    for mesh in ("single", "multi"):
        for arch_id in all_arch_ids():
            for shape in get_arch(arch_id).shapes:
                key = (arch_id, shape, mesh)
                ra, rb = a.get(key), b.get(key)
                n_skip += bool(ra and "skipped" in ra)
                n_traced += bool(ra and "cost" in ra)
                same = agree(ra, rb)
                n_same += same == "the same"
                print(f"| {arch_id} {shape} {mesh} | {entry(ra)} | "
                      f"{same if args.b else ''} | "
                      f"{shape_ratio(key, ra)} |")
    print(f"\n{n_traced} traced, {n_skip} skipped by rule; B reads the "
          f"same as A (flops, arguments, temp, collectives within "
          f"{AGREE:.0%}) "
          f"on {n_same}")
    for name, path in (("A", args.full_a), ("B", args.full_b)):
        if not path:
            continue
        full, count = records(path), (a if name == "A" else b)
        print(f"\nPer-layer count against the full-depth trace ({name}): "
              f"count / full of flops, collective bytes, argument bytes, "
              f"temp")
        print("| Cell | flops | collectives | arguments | temp | trace s "
              "(count, full) |")
        print("| --- | --- | --- | --- | --- | --- |")
        for key in sorted(full):
            f, c = full[key], count.get(key)
            if "cost" not in f or c is None or "cost" not in c:
                continue

            def ratio(x, y):
                return f"{x / y:.6f}" if y else ("1" if x == y else "inf")

            print(f"| {' '.join(key)} | "
                  f"{ratio(c['cost']['flops'], f['cost']['flops'])} | "
                  + ratio(c["collectives_bytes"].get("total", 0),
                          f["collectives_bytes"].get("total", 0)) + " | "
                  + ratio(c["memory"]["argument_size_in_bytes"],
                          f["memory"]["argument_size_in_bytes"]) + " | "
                  + ratio(c["memory"]["temp_size_in_bytes"],
                          f["memory"]["temp_size_in_bytes"])
                  + f" | {c['trace_s']:.0f}, {f['trace_s']:.0f} |")


if __name__ == "__main__":
    main()
