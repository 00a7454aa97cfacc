"""Architecture registry of the port — the LM part of
``repro.configs.registry``: ``LMArch`` with its shape cells, its reduced
``smoke()`` config, its optimizer and its ``train`` / ``prefill`` /
``decode`` steps, and ``register`` / ``get_arch`` / ``all_arch_ids``.

The mesh and partition-spec methods wait for the model-spec functions of
``distributed/sharding.py`` (ROADMAP item 14e), and the GNN and recsys
archs for their slice (14d).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from ..models import transformer as tfm
from ..optim import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str                     # train | prefill | decode
    dims: dict
    skip: Optional[str] = None


class LMArch:
    """An LM id's config and shape cells; ``accum`` is the reference's
    gradient-accumulation steps per train cell, which ``step`` reads."""
    family = "lm"

    def __init__(self, arch_id: str, cfg: tfm.TransformerConfig,
                 accum: Dict[str, int] | None = None):
        self.arch_id = arch_id
        self.cfg = cfg
        self.accum = accum or {}
        full_attn = cfg.attention == "full"
        skip = ("long_500k needs sub-quadratic attention; "
                f"{arch_id} is pure full-attention (DESIGN.md §5)"
                ) if full_attn else None
        self.shapes = {
            "train_4k": ShapeCell("train_4k", "train",
                                  {"seq": 4096, "batch": 256}),
            "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                     {"seq": 32768, "batch": 32}),
            "decode_32k": ShapeCell("decode_32k", "decode",
                                    {"seq": 32768, "batch": 128}),
            "long_500k": ShapeCell("long_500k", "decode",
                                   {"seq": 524288, "batch": 1}, skip=skip),
        }

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(kind="adamw", lr=3e-4)

    def step(self, shape: str) -> Callable:
        """The cell's step: ``train_step(params, opt_state, tokens,
        weights)`` -> (params, opt_state, metrics) with the cell's
        gradient accumulation; ``prefill_step(params, tokens)`` ->
        last-token logits (serving emits those); or ``serve_step(params,
        cache, token, pos)`` -> (logits, cache)."""
        cell = self.shapes[shape]
        cfg = self.cfg
        if cell.kind == "train":
            from ..train.steps import make_train_step

            def loss_fn(params, batch, weights):
                loss, _ = tfm.forward(cfg, params, batch, weights)
                return loss

            return make_train_step(loss_fn, self.opt_config(),
                                   accum_steps=self.accum.get(shape, 1))
        if cell.kind == "prefill":
            def prefill_step(params, tokens):
                return tfm.prefill(cfg, params, tokens)[:, -1]
            return prefill_step

        def serve_step(params, cache, token, pos):
            return tfm.decode_step(cfg, params, cache, token, pos)
        return serve_step

    def smoke(self) -> tfm.TransformerConfig:
        """The reference's reduced CPU config: 2 layers, d 64, fp32."""
        return dataclasses.replace(
            self.cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(4, self.cfg.n_kv_heads),
            head_dim=16, d_ff=128, vocab=512,
            d_ff_expert=32 if self.cfg.is_moe else 0,
            n_experts=min(4, self.cfg.n_experts),
            moe_top_k=min(self.cfg.moe_top_k,
                          max(1, min(4, self.cfg.n_experts))),
            q_lora_rank=32 if self.cfg.q_lora_rank else 0,
            kv_lora_rank=32 if self.cfg.use_mla else 512,
            qk_nope_dim=16 if self.cfg.use_mla else 128,
            qk_rope_dim=8 if self.cfg.use_mla else 64,
            v_head_dim=16 if self.cfg.use_mla else 128,
            window=16 if self.cfg.attention == "swa" else 4096,
            dtype=torch.float32, remat="none",
            attn_q_block=32, attn_k_block=32)


_REGISTRY: Dict[str, Callable[[], LMArch]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_arch(arch_id: str) -> LMArch:
    from . import lm_archs  # noqa: F401 — populate the registry
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def all_arch_ids() -> list:
    from . import lm_archs  # noqa: F401
    return sorted(_REGISTRY)
