"""The reference's plan for the smoke GQA train steps that
``repro_torch.launch.meshcheck.attention_split`` traces in the port:
qwen3-8b's and mixtral-8x7b's smoke configs with 8 query heads, 2 KV
heads and head_dim 16 (a "model" split of 4 divides the query heads but
not the KV heads, as 16 does mixtral's and qwen3-8b's 32 and 8), one
microbatch of 16 x 128 tokens in 32-token attention blocks, compiled by
XLA for 4 forced host devices on a ("data", "model") mesh of (1, 1) and
(1, 4) with ``Auto`` axes (jax 0.9's ``make_mesh`` defaults to
``Explicit`` ones, which the reference's sharded code does not run
under). Per device, from the compiled module (``repro.launch.analysis``,
loop-aware): flops, temp bytes and the collectives' bytes by kind.
Computed from shapes on the host, never measured.

    PYTHONPATH=src python scripts/reference_attn_plan.py
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

# the port's side: repro_torch.launch.meshcheck.ATTN_SPLIT / ATTN_HEADS
BATCH, SEQ = 16, 128
HEADS, KV_HEADS, HEAD_DIM = 8, 2, 16


def gqa_step_arch(arch_id: str) -> LMArch:
    cfg = dataclasses.replace(get_arch(arch_id).smoke(), n_heads=HEADS,
                              n_kv_heads=KV_HEADS, head_dim=HEAD_DIM)
    arch = LMArch(arch_id, cfg, accum={"train_4k": 1})
    arch.shapes["train_4k"] = ShapeCell("train_4k", "train",
                                        {"batch": BATCH, "seq": SEQ})
    return arch


def main() -> None:
    for arch_id in ("qwen3-8b", "mixtral-8x7b"):
        arch = gqa_step_arch(arch_id)
        for model in (1, 4):
            mesh = Mesh(np.array(jax.devices()[:model]).reshape(1, model),
                        ("data", "model"), axis_types=(AxisType.Auto,) * 2)
            rec = lower_lm_cell(arch, "train_4k", mesh)
            la = rec["loop_aware"]
            print(json.dumps({
                "arch": arch_id, "mesh": [1, model], "flops": la["flops"],
                "temp_bytes": rec["memory"].get("temp_size_in_bytes"),
                "collectives_bytes": la["collectives_bytes"],
                "collectives_counts": la["collectives_counts"]}))


if __name__ == "__main__":
    main()
