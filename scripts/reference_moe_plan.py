"""The reference's collective plan for the smoke train steps that
``repro_torch.launch.meshcheck.moe_split`` traces in the port: qwen3-8b,
mixtral-8x7b and deepseek-v2-236b at their smoke configs, one microbatch
of 64 x 128 tokens routed in groups of 64, compiled by XLA for 4 forced
host devices on a ("data", "model") mesh of (1, 1) and (4, 1) with
``Auto`` axes (jax 0.9's ``make_mesh`` defaults to ``Explicit`` ones,
which the reference's sharded code does not run under). Per device, from
the compiled module (``repro.launch.analysis``, loop-aware): flops, temp
bytes and the collectives' bytes by kind. Computed from shapes on the
host, never measured.

    PYTHONPATH=src python scripts/reference_moe_plan.py
"""

import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=4").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import dataclasses  # noqa: E402
import json  # noqa: E402

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, Mesh  # noqa: E402

from repro.configs import get_arch  # noqa: E402
from repro.configs.registry import LMArch, ShapeCell  # noqa: E402
from repro.launch.hillclimb import lower_lm_cell  # noqa: E402

BATCH, SEQ, GROUP = 64, 128, 64


def smoke_step_arch(arch_id: str) -> LMArch:
    base = get_arch(arch_id)
    cfg = base.smoke()
    if cfg.is_moe:
        cfg = dataclasses.replace(cfg, moe_group_size=GROUP)
    arch = LMArch(arch_id, cfg, accum={"train_4k": 1})
    arch.shapes["train_4k"] = ShapeCell("train_4k", "train",
                                        {"batch": BATCH, "seq": SEQ})
    return arch


def main() -> None:
    for arch_id in ("qwen3-8b", "mixtral-8x7b", "deepseek-v2-236b"):
        arch = smoke_step_arch(arch_id)
        for data in (1, 4):
            mesh = Mesh(np.array(jax.devices()[:data]).reshape(data, 1),
                        ("data", "model"), axis_types=(AxisType.Auto,) * 2)
            rec = lower_lm_cell(arch, "train_4k", mesh)
            la = rec["loop_aware"]
            print(json.dumps({
                "arch": arch_id, "mesh": [data, 1], "flops": la["flops"],
                "temp_bytes": rec["memory"].get("temp_size_in_bytes"),
                "collectives_bytes": la["collectives_bytes"],
                "collectives_counts": la["collectives_counts"]}))


if __name__ == "__main__":
    main()
