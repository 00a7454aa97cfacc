"""Train steps — the port of ``repro.train.steps``.

``make_train_step`` builds a (params, opt_state, batch, weights) ->
(params, opt_state, metrics) function with optional gradient
accumulation: the batch is split into ``accum_steps`` microbatches, each
one's gradients (in the param dtype, as autograd gives them) are added
into a buffer of ``accum_dtype`` (fp32 by default) — never summed in
bf16 in ``.grad`` — and the result is ``loss / accum`` and ``grads /
accum`` in fp32. Each microbatch's loss normalises by its own weight sum;
weights of None are ones. The params are updated in place
(``optim.apply_updates``); the reference donates them instead.

Loss weights flow in from the dedup pipeline (the paper's technique
gating what the optimizer sees).

The reference's ``jit_sharded`` places a step on a JAX mesh with named
shardings. It has no meaning on one card and waits for the port of the
mesh launcher (``launch/mesh.py``, ROADMAP item 14e).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..optim import OptimizerConfig, apply_updates


def batch_leading(batch) -> int:
    """The leading (batch) size of a tensor or of a dict of tensors'
    first leaf, in the reference's tree order."""
    while isinstance(batch, dict):
        batch = batch[sorted(batch)[0]]
    return batch.shape[0]


def _rows(batch, lo: int, hi: int):
    if isinstance(batch, dict):
        return {k: _rows(v, lo, hi) for k, v in batch.items()}
    return batch[lo:hi]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig,
                    accum_steps: int = 1, accum_dtype=None):
    """loss_fn(params, batch, weights) -> scalar loss; ``params`` is a
    module (``models.layers.Params``) whose parameters the step trains.

    ``accum_dtype``: dtype of the gradient-accumulation buffer (fp32 by
    default; bf16 halves it, the update still runs on fp32 moments)."""

    def train_step(params, opt_state, batch, weights=None):
        named = list(params.named_parameters())
        tensors = [p for _, p in named]

        def grads_of(loss):
            return torch.autograd.grad(loss, tensors, allow_unused=True,
                                       materialize_grads=True)

        if accum_steps == 1:
            loss = loss_fn(params, batch, weights)
            grads = dict(zip((n for n, _ in named), grads_of(loss)))
        else:
            acc_dt = accum_dtype or torch.float32
            n = batch_leading(batch)
            if n % accum_steps:
                raise ValueError(f"a batch of {n} does not split into "
                                 f"{accum_steps} microbatches")
            mb = n // accum_steps
            device = tensors[0].device
            if weights is None:
                weights = torch.ones((n,), dtype=torch.float32,
                                     device=device)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            acc = [torch.zeros(p.shape, dtype=acc_dt, device=p.device)
                   for p in tensors]
            for i in range(accum_steps):
                lo, hi = i * mb, (i + 1) * mb
                l_i = loss_fn(params, _rows(batch, lo, hi), weights[lo:hi])
                for a, g in zip(acc, grads_of(l_i)):
                    a.add_(g.to(acc_dt))
                loss = loss + l_i.detach()
            loss = loss / accum_steps
            # in place where the buffer is already fp32 (or wider, a
            # float64 referee's): g / accum either way
            grads = {name: a.to(torch.promote_types(a.dtype, torch.float32)
                                ).div_(accum_steps)
                     for (name, _), a in zip(named, acc)}
            del acc
        params, opt_state, metrics = apply_updates(opt_cfg, params, grads,
                                                   opt_state)
        metrics["loss"] = loss.detach()
        return params, opt_state, metrics

    return train_step
