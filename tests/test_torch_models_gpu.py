"""The port's models on the card at smoke width — the transformer (the
five LM archs: dense, MoE, MLA), MeshGraphNet and the four recsys rankers
— against the port's own CPU run from the same weights (the reference
holds the CPU run: ``tests/test_torch_transformer.py``,
``test_torch_gnn.py``, ``test_torch_recsys.py``). These tests import
neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_models_gpu.py

Without a CUDA device they skip. fp32 on both sides with TF32 off, so the
card's logits agree with the CPU's to 1e-4 (reductions in another
order); the full-width run is ``chip_smoke.py``'s phase "lm". GNN and
recsys go through ``chip_smoke.py``'s ``model_card_vs_cpu`` (the check
of its phase "graph_recsys"): two AdamW steps in lockstep, forward and
loss within 1e-5 of the max |value|, each gradient within 1e-4 of its
max |g|, params after the step within 1e-5 of their max |value| plus
1e-2 x the lr."""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (model_card_vs_cpu, model_parity_ok,
                        model_parity_text, smoke_batches)
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.models import gnn as TG
from repro_torch.models import recsys as TR
from repro_torch.models import transformer as TT
from repro_torch.models.layers import tensor_batch
from torch_lm_scorer import make_lm_scorer

pytestmark = pytest.mark.gpu
ALL = ("qwen3-8b", "codeqwen1.5-7b", "h2o-danube-3-4b", "mixtral-8x7b",
       "deepseek-v2-236b")
GR = ("meshgraphnet", "wide-deep", "xdeepfm", "dlrm-rm2", "dcn-v2")
B, S = 2, 40                 # past danube's window of 16 twice over
ATOL = 1e-4


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the model runs on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def both(arch_id):
    """(cfg, CPU params, card params, tokens): one seeded CPU init copied
    to the card through the converter."""
    cfg = get_arch(arch_id).smoke()
    cpu = TT.init(cfg, 0, "cpu")
    gpu = convert.transformer_params_from_numpy(
        cfg, convert.transformer_params_to_numpy(cfg, cpu), "cuda")
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S)).astype(np.int32))
    return cfg, cpu, gpu, toks


@pytest.mark.parametrize("arch_id", ALL)
def test_prefill_on_card_matches_cpu(card, arch_id):
    cfg, cpu, gpu, toks = both(arch_id)
    want = TT.prefill(cfg, cpu, toks)
    got = TT.prefill(cfg, gpu, toks.to(card))
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=ATOL)


@pytest.mark.parametrize("arch_id", ALL)
def test_decode_on_card_matches_cpu(card, arch_id):
    """Teacher-forced decode on both devices: logits at every position and
    the cache leaves at the end (danube's ring of 16 slots wraps twice;
    deepseek's MLA latent), and decode == prefill on the card at the
    reference's 3e-4 (no MoE pair drops at the smoke configs)."""
    cfg, cpu, gpu, toks = both(arch_id)
    full = TT.prefill(cfg, gpu, toks.to(card)).cpu()
    c_cpu = TT.init_cache(cfg, B, S, "cpu")
    c_gpu = TT.init_cache(cfg, B, S)
    assert c_gpu["kpos"].device.type == "cuda"
    for s in range(S):
        pos = torch.full((B,), s, dtype=torch.int32)
        lc, c_cpu = TT.decode_step(cfg, cpu, c_cpu, toks[:, s], pos)
        lg, c_gpu = TT.decode_step(cfg, gpu, c_gpu, toks[:, s].to(card),
                                   pos.to(card))
        np.testing.assert_allclose(lg.cpu().numpy(), lc.numpy(), atol=ATOL,
                                   err_msg=f"position {s}")
        np.testing.assert_allclose(lg.cpu().numpy(), full[:, s].numpy(),
                                   atol=3e-4, err_msg=f"position {s}")
    got = convert.decode_cache_to_numpy(c_gpu)
    want = convert.decode_cache_to_numpy(c_cpu)
    np.testing.assert_array_equal(got["kpos"], want["kpos"])
    for n in set(got) - {"kpos"}:
        np.testing.assert_allclose(got[n], want[n], atol=ATOL)
    if cfg.attention == "swa":
        assert got["kpos"].shape[-1] == cfg.window
        assert sorted(got["kpos"][0, 0]) == list(range(S - cfg.window, S))


def test_lm_scorer_on_card_matches_cpu(card):
    cfg, cpu, gpu, _ = both("qwen3-8b")
    keys = np.random.default_rng(2).integers(0, 1 << 32, 100,
                                             dtype=np.uint64).astype(np.uint32)
    got = make_lm_scorer(cfg, gpu)({"key": keys})
    want = make_lm_scorer(cfg, cpu)({"key": keys})
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bf16_init_on_card(card):
    """The seeded init on the card: bf16 weights, fp32 norms, finite
    logits of the right shape."""
    cfg = dataclasses.replace(get_arch("qwen3-8b").smoke(),
                              dtype=torch.bfloat16)
    p = TT.init(cfg, 0)
    assert p["lm_head"].dtype == torch.bfloat16
    assert p["layers"][0]["attn"]["q_norm"].dtype == torch.float32
    lg = TT.prefill(cfg, p, torch.zeros((2, 8), dtype=torch.int32,
                                        device=card))
    assert lg.shape == (2, 8, cfg.vocab) and bool(torch.isfinite(lg).all())


@pytest.mark.parametrize("arch_id", ("h2o-danube-3-4b", "mixtral-8x7b",
                                     "deepseek-v2-236b"))
def test_steps_wait_for_nothing_on_the_host(card, arch_id):
    """Prefill and decode issue no host-device synchronisation (a blocking
    copy in a layer would serialise the host's launches with the card; the
    MoE dispatch counts with a scatter, not ``bincount``)."""
    cfg, _, gpu, toks = both(arch_id)
    toks = toks.to(card)
    cache = TT.init_cache(cfg, B, S)
    pos = torch.zeros((B,), dtype=torch.int32, device=card)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TT.prefill(cfg, gpu, toks)
        TT.decode_step(cfg, gpu, cache, toks[:, 0], pos)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("arch_id", GR)
def test_gnn_and_recsys_train_steps_on_card_match_cpu(card, arch_id):
    """Two AdamW steps of each smoke config on the card and on the CPU in
    lockstep, one record weighted 0 by the dedup stage (MeshGraphNet on a
    random graph, then a neighbor sample; recsys on CTR batches with
    replays): the card's forward, loss, gradients and updates within the
    stated bounds; the scatter-sum's atomics and the embedding gradient's
    ``index_put_`` run on the card."""
    arch = get_arch(arch_id)
    cfg = arch.smoke()
    res = model_card_vs_cpu(arch.family, cfg, smoke_batches(arch.family,
                                                            cfg))
    print(f"{arch_id}: {model_parity_text(res)}")
    assert model_parity_ok(res), model_parity_text(res)


def test_the_model_check_fails_on_tf32(card, monkeypatch):
    """The check can fail: with TF32 planted in the card's matmuls alone,
    DCN-v2's forward is out of bounds."""
    real = TR.forward

    def planted(cfg, params, batch):
        torch.backends.cuda.matmul.allow_tf32 = batch["dense"].is_cuda
        try:
            return real(cfg, params, batch)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    monkeypatch.setattr(TR, "forward", planted)
    cfg = get_arch("dcn-v2").smoke()
    res = model_card_vs_cpu("recsys", cfg, smoke_batches("recsys", cfg, 1))
    print(f"planted tf32: {model_parity_text(res)}")
    assert not model_parity_ok(res)


def test_gnn_and_recsys_forward_wait_for_nothing_on_the_host(card):
    """MeshGraphNet's forward and loss (gathers, the scatter-sum's masks),
    the rankers' serving forward with ``dedup_gather`` (``unique_gather``
    on the card) and retrieval's tie-ordered top-k issue no host-device
    synchronisation."""
    gcfg = get_arch("meshgraphnet").smoke()
    gparams = TG.init(gcfg, 0)
    gbatch = tensor_batch(smoke_batches("gnn", gcfg, 1)[0][0])
    rec = []
    for aid in GR[1:]:
        cfg = dataclasses.replace(get_arch(aid).smoke(), dedup_gather=True)
        batch = tensor_batch(smoke_batches("recsys", cfg, 1)[0][0])
        batch["candidates"] = torch.randn((5000, cfg.embed_dim),
                                          device=card)
        rec.append((cfg, TR.init(cfg, 0), batch))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        TG.loss_fn(gcfg, gparams, gbatch)
        with torch.inference_mode():
            for cfg, params, batch in rec:
                TR.forward(cfg, params, batch)
                TR.retrieval_scores(cfg, params, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
