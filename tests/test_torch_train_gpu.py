"""The port's train step on the card at smoke width, against the port's
own CPU run from the same weights (the reference holds the CPU run,
``tests/test_torch_train.py``). These tests import neither jax nor the
JAX package:

    PYTHONPATH=src python -m pytest -q -rP -m gpu \\
        tests/test_torch_train_gpu.py

(``-rP`` prints each case's numbers.) Without a CUDA device they skip.
Three AdamW steps (the training driver's optimizer), one record weighted
0, through ``chip_smoke.py``'s ``train_card_vs_cpu`` — the check of its
phase "train", part 3 — in lockstep (each step from the state the CPU's
fp32 run reached): the fp32 losses within 1e-4 of the CPU's; the card's
float64 gradients within 1e-8 of the CPU's float64 referee (the card
computes the referee's function); its fp32 gradients (each leaf, after
accumulation, in the 2-norm) and grad norms no further from the referee
than 4 times the run's fp32 noise (the CPU's largest such distance; or
1e-4); its param updates within 1e-4 of the lr (plus fp32's rounding of
the param) of the referee's wherever the referee's gradient stands above
the fp32 noise, and of float64 AdamW on its own gradients everywhere. For
the MoE configs (mixtral's, and deepseek's with MLA, routed and shared
experts and its dense first layer) the route ids of the four runs are
held equal layer by layer before any gradient is compared. A fault
planted in the card's step alone must fail the same check."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import train_card_vs_cpu, train_parity_ok, train_parity_text
from repro_torch.configs import get_arch

pytestmark = pytest.mark.gpu
DENSE = ("qwen3-8b", "codeqwen1.5-7b", "h2o-danube-3-4b")
MOE = ("mixtral-8x7b", "deepseek-v2-236b")
B, S, STEPS = 4, 40, 3


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the train step runs on the card")
    return torch.device("cuda")


def smoke_batches(cfg) -> list:
    r = np.random.default_rng(2)
    return [(r.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32),
             np.array([1.0, 0.0, 1.0, 1.0], np.float32))
            for _ in range(STEPS)]


@pytest.mark.parametrize("accum", (1, 2))
@pytest.mark.parametrize("arch_id", DENSE + MOE)
def test_train_steps_on_card_match_cpu(card, arch_id, accum):
    cfg = get_arch(arch_id).smoke()
    res = train_card_vs_cpu(cfg, smoke_batches(cfg), accum)
    print(f"{arch_id} accum {accum}: {train_parity_text(res)}")
    assert train_parity_ok(res), train_parity_text(res)
    n_moe = cfg.n_layers - cfg.first_dense_layers if cfg.is_moe else 0
    assert res["routes"] == STEPS * accum * n_moe


@pytest.mark.parametrize("fault", ("tf32", "final_norm_decayed",
                                   "bf16_buffer"))
def test_the_check_fails_on_a_faulty_card_step(card, monkeypatch, fault):
    """The check can fail: with a fault planted in the card's fp32 step
    alone — TF32 in its matmuls, the (d,) final norm decayed (the
    optimizer's rank trap) or a bf16 accumulation buffer — the same run is
    out of bounds."""
    import repro_torch.train as train
    made = train.make_train_step

    def planted(loss_fn, opt, accum=1, accum_dtype=None):
        def step(params, state, tokens, weights):
            on_card = tokens.is_cuda and weights.dtype == torch.float32
            buf = (torch.bfloat16 if on_card and fault == "bf16_buffer"
                   else accum_dtype)
            torch.backends.cuda.matmul.allow_tf32 = (on_card
                                                     and fault == "tf32")
            try:
                params, state, m = made(loss_fn, opt, accum, buf)(
                    params, state, tokens, weights)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            if on_card and fault == "final_norm_decayed":
                with torch.no_grad():
                    params["final_norm"].mul_(
                        1 - float(m["lr"]) * opt.weight_decay)
            return params, state, m
        return step

    monkeypatch.setattr(train, "make_train_step", planted)
    cfg = get_arch("h2o-danube-3-4b").smoke()
    res = train_card_vs_cpu(cfg, smoke_batches(cfg), 2)
    print(f"planted {fault}: {train_parity_text(res)}")
    assert not train_parity_ok(res), train_parity_text(res)


def test_the_check_fails_on_a_faulty_moe_step(card, monkeypatch):
    """A fault only an MoE step can have: the card's fp32 sort dispatch
    takes each expert's capacity one short. At mixtral's smoke config with
    capacity factor 1.0 an expert's capacity is its mean load, so some
    expert fills it in every microbatch and the card drops a pair the
    other runs keep. That moves the next layer's input, so the check
    fails at its route comparison where that layer routes a token
    elsewhere (it raises), or else at the gradients."""
    from repro_torch.models import moe
    sort, capacity = moe._moe_sort, moe._capacity

    def short(n_tokens, cfg):
        return capacity(n_tokens, cfg) - 1

    def planted(params, x, cfg):
        if not (x.is_cuda and x.dtype == torch.float32):
            return sort(params, x, cfg)
        moe._capacity = short
        try:
            return sort(params, x, cfg)
        finally:
            moe._capacity = capacity

    monkeypatch.setattr(moe, "_moe_sort", planted)
    cfg = dataclasses.replace(get_arch("mixtral-8x7b").smoke(),
                              capacity_factor=1.0)
    try:
        res = train_card_vs_cpu(cfg, smoke_batches(cfg), 2)
    except AssertionError as exc:
        print(f"planted capacity one short: {exc}")
        assert "route differently" in str(exc), exc
        return
    print(f"planted capacity one short: {train_parity_text(res)}")
    assert not train_parity_ok(res), train_parity_text(res)
