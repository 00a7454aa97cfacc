"""The serving benchmark's ``transformer`` scorer
(``benchmarks/serving_qps.py``) over the port's model, shared by
``test_torch_lm_serving.py`` and the card tests of
``test_torch_models_gpu.py``: request key -> SEQ_LEN pseudo-tokens -> the
mean of the last position's first 8 logits. Imports torch and numpy only,
so the card tests run without jax."""

import contextlib

import numpy as np
import torch

from repro_torch.core.engine import next_pow2
from repro_torch.serve import make_prefill_step

SEQ_LEN = 16                # the scorer's context, as the benchmark's
MIN_WIDTH = 32              # its smallest padded miss-batch


def lm_scorer_tokens(keys, width: int, vocab: int) -> np.ndarray:
    """(width, SEQ_LEN) int32 pseudo-tokens of request keys, the rows past
    ``len(keys)`` padding (key 0): key * (j + 1) * 0x9E3779B97F4A7C15 mod
    2^64, its high word, mod ``vocab`` — the benchmark's mapping."""
    mults = (np.arange(1, SEQ_LEN + 1, dtype=np.uint64)
             * np.uint64(0x9E3779B97F4A7C15))
    keys_p = np.pad(np.asarray(keys, np.uint64), (0, width - len(keys)))
    return ((keys_p[:, None] * mults[None, :]) >> np.uint64(32)
            ).astype(np.int32) % vocab


def make_lm_scorer(cfg, params):
    """A scorer for ``ServeSession`` / ``ServeFrontend`` on the params'
    device: a miss-batch of m is padded to ``max(32, next_pow2(m))`` rows;
    -> float32 host array of m scores."""
    prefill_step = make_prefill_step(cfg)
    device = params["embed"].device

    def scorer(batch: dict) -> np.ndarray:
        keys = np.asarray(batch["key"], np.uint64)
        m = keys.shape[0]
        width = max(MIN_WIDTH, next_pow2(m))
        tokens = torch.from_numpy(lm_scorer_tokens(keys, width, cfg.vocab))
        on_card = (torch.cuda.device(device) if device.type == "cuda"
                   else contextlib.nullcontext())
        with on_card:
            logits = prefill_step(params, tokens.to(device))
            return logits[:, -1, :8].mean(-1).float().cpu().numpy()[:m]

    return scorer
