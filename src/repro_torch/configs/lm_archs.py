"""The five assigned LM transformer architectures (exact public configs),
as data — the port's copy of ``repro.configs.lm_archs``: the dense three
(codeqwen1.5-7b, qwen3-8b, h2o-danube-3-4b) and the MoE two
(mixtral-8x7b; deepseek-v2-236b with MLA).

The ``accum`` factors are the reference's per train cell.
"""

from __future__ import annotations

import torch

from ..models.transformer import TransformerConfig
from .registry import LMArch, register


@register("codeqwen1.5-7b")
def codeqwen() -> LMArch:
    # [hf:Qwen/CodeQwen1.5-7B] 32L d4096 32H GQA kv=32 d_ff 13440 vocab 92416
    cfg = TransformerConfig(
        name="codeqwen1.5-7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=32, head_dim=128, d_ff=13440, vocab=92416,
        attention="full", rope_theta=1_000_000.0,
        dtype=torch.bfloat16, remat="full")
    return LMArch("codeqwen1.5-7b", cfg, accum={"train_4k": 4})


@register("qwen3-8b")
def qwen3() -> LMArch:
    # [hf:Qwen/Qwen3-8B] 36L d4096 32H GQA kv=8 d_ff 12288 vocab 151936 qk_norm
    cfg = TransformerConfig(
        name="qwen3-8b", n_layers=36, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=12288, vocab=151936,
        attention="full", qk_norm=True, rope_theta=1_000_000.0,
        dtype=torch.bfloat16, remat="full")
    return LMArch("qwen3-8b", cfg, accum={"train_4k": 4})


@register("h2o-danube-3-4b")
def danube3() -> LMArch:
    # [arXiv:2401.16818] 24L d3840 32H GQA kv=8 d_ff 10240 vocab 32000, SWA
    cfg = TransformerConfig(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, head_dim=120, d_ff=10240, vocab=32000,
        attention="swa", window=4096, rope_theta=10_000.0,
        dtype=torch.bfloat16, remat="full")
    return LMArch("h2o-danube-3-4b", cfg, accum={"train_4k": 2})


@register("deepseek-v2-236b")
def deepseek_v2() -> LMArch:
    # [arXiv:2405.04434] 60L d5120 128H MLA kv_lora 512, rope 64, nope 128,
    # v 128, q_lora 1536; MoE: 160 routed top-6 @ d_ff 1536 + 2 shared;
    # first layer dense (d_ff 12288); vocab 102400.
    cfg = TransformerConfig(
        name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
        n_kv_heads=128, head_dim=128, d_ff=12288, vocab=102400,
        attention="full", rope_theta=10_000.0,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, mla_absorb=True,
        n_experts=160, moe_top_k=6, n_shared_experts=2, d_ff_expert=1536,
        moe_dispatch="sort", moe_group_size=8192, capacity_factor=1.25,
        first_dense_layers=1, dtype=torch.bfloat16, remat="full")
    # sort-dispatch (not GShard einsum) is the TPU adaptation for 160
    # fine-grained experts — einsum dispatch FLOPs would exceed expert FLOPs
    # (DESIGN.md §3, EXPERIMENTS.md §Perf baseline comparison).
    return LMArch("deepseek-v2-236b", cfg, accum={"train_4k": 8})


@register("mixtral-8x7b")
def mixtral() -> LMArch:
    # [arXiv:2401.04088] 32L d4096 32H GQA kv=8 d_ff 14336 vocab 32000,
    # 8 experts top-2, SWA(4096)
    cfg = TransformerConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, head_dim=128, d_ff=14336, vocab=32000,
        attention="swa", window=4096, rope_theta=1_000_000.0,
        n_experts=8, moe_top_k=2, d_ff_expert=14336,
        moe_dispatch="sort", capacity_factor=1.25,
        dtype=torch.bfloat16, remat="full")
    # sort dispatch: GShard einsum dispatch costs E*C = g*k*cf tokens-worth
    # of d-dim matmul per token — independent of E — so it dominates expert
    # FLOPs at any expert count (§Perf E0/E1: 2.8x compute, 165->38 GB temp).
    return LMArch("mixtral-8x7b", cfg, accum={"train_4k": 4})
