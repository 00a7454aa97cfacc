"""The reference's per-device memory of the LM train_4k and prefill_32k
cells on both production meshes, from its own dry run
(``repro.launch.dryrun.dryrun_cell``: XLA's memory analysis of the
module compiled for 256 or 512 forced host devices), the figures that
``repro_torch.launch.meshcheck.REFERENCE_TEMP`` holds the port's dry run
to. Computed from shapes on the host, never measured.

    PYTHONPATH=src python scripts/reference_dryrun_memory.py [--jobs 2]
        [--cells qwen3-8b/train_4k/single ...]
        [--out experiments/reference_dryrun_memory.json]

jax 0.9's ``make_mesh`` gives ``Explicit`` axes, under which the
reference's sharded code fails (a ``ShardingTypeError`` at the batch
reshape); each cell's process swaps the dry run's
``make_production_mesh`` for one with ``Auto`` axes, from outside the
package, the way ``scripts/reference_attn_plan.py`` builds its mesh.
Nothing of ``repro`` is edited. One process per cell (the forced device
count is fixed at a process's first use of jax), ``--jobs`` at once;
records merge into ``--out`` by cell, so a run resumes. Prints the temp
and argument bytes per device of every cell, then the
``REFERENCE_TEMP`` literal. A train_4k cell takes 1 - 6 min and a few
GB of host memory on one core.
"""

import argparse
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("qwen3-8b", "codeqwen1.5-7b", "h2o-danube-3-4b", "mixtral-8x7b",
         "deepseek-v2-236b")
SHAPES = ("train_4k", "prefill_32k")
MESHES = ("single", "multi")

WORKER = """
import json, sys
import repro.launch.dryrun as dryrun      # sets the forced device count
import jax
from jax.sharding import AxisType


def make_production_mesh(*, multi_pod=False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return jax.make_mesh(shape, axes,
                         axis_types=(AxisType.Auto,) * len(axes))


dryrun.make_production_mesh = make_production_mesh
arch, shape, mesh = sys.argv[1:4]
rec = dryrun.dryrun_cell(arch, shape, mesh == "multi")
print(json.dumps(rec, default=str))
"""


def run_cell(cell: str) -> dict:
    arch, shape, mesh = cell.split("/")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
           "JAX_PLATFORMS": "cpu"}
    p = subprocess.run([sys.executable, "-c", WORKER, arch, shape, mesh],
                       capture_output=True, text=True, env=env, cwd=ROOT)
    if p.returncode:
        return {"cell": cell, "error": p.stderr[-2000:]}
    rec = json.loads(p.stdout.strip().splitlines()[-1])
    return {"cell": cell, "memory": rec["memory"],
            "compile_s": rec.get("compile_s"), "lower_s": rec.get("lower_s"),
            "flops": rec.get("cost", {}).get("flops")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", nargs="*",
                    default=[f"{a}/{s}/{m}" for a in ARCHS for s in SHAPES
                             for m in MESHES])
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "experiments", "reference_dryrun_memory.json"))
    args = ap.parse_args(argv)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    done = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            done = {r["cell"]: r for r in json.load(f) if "error" not in r}
    todo = [c for c in args.cells if c not in done]
    with ThreadPoolExecutor(max(1, args.jobs)) as pool:
        for rec in pool.map(run_cell, todo):
            done[rec["cell"]] = rec
            print(f"[reference] {rec['cell']}: "
                  + (rec["error"][-300:] if "error" in rec else
                     f"temp {rec['memory']['temp_size_in_bytes']} B, "
                     f"compile {rec['compile_s']} s"), flush=True)
            with open(args.out, "w") as f:
                json.dump(sorted(done.values(), key=lambda r: r["cell"]), f,
                          indent=1)
    print("\n| cell | temp GB single / multi | argument GB single / "
          "multi |\n| --- | --- | --- |")
    temps = {}
    for a in ARCHS:
        for s in SHAPES:
            row = [done.get(f"{a}/{s}/{m}", {}).get("memory") for m in
                   MESHES]
            if not any(row):
                continue

            def gb(mem, key):
                return "-" if mem is None else f"{mem[key] / 1e9:.2f}"

            print(f"| {a} {s} | "
                  + " / ".join(gb(m, "temp_size_in_bytes") for m in row)
                  + " | " + " / ".join(gb(m, "argument_size_in_bytes")
                                       for m in row) + " |")
            for m, mem in zip(MESHES, row):
                if mem is not None:
                    temps[f"{a}/{s}/{m}"] = int(mem["temp_size_in_bytes"])
    print("\nREFERENCE_TEMP = " + json.dumps(temps, indent=4))
    return 1 if any("error" in r for r in done.values()) else 0


if __name__ == "__main__":
    raise SystemExit(main())
