"""The port's training objective and train step (``repro_torch.models``,
``repro_torch.train``) against the reference's on the CPU, from one set of
weights (the reference's seeded tree crossed through
``repro_torch.convert``), inputs made with numpy from a seed, in fp32 (the
smoke configs' dtype). Tolerances, each relative to the max |value| of
what is compared: 1e-5 for ``weighted_xent``, ``forward``'s loss and
logits (fp32 einsums reduce in another order in each framework); 1e-4
for gradients (a backward pass is a longer chain of such sums); after
three AdamW steps 1e-4 for params, m and v with an fp32 accumulation
buffer, and 8e-3 with a bf16 one (a gradient within an ulp of a bf16
rounding boundary may round the other way: one bf16 ulp is 2^-8 of the
value); 1e-6 for the learning rate (fp32 cosines of two libraries, an ulp
apart); remat is held bit for bit against none."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.configs.registry import LMArch as JLMArch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import init_opt_state as j_init_opt
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch import convert
from repro_torch.configs import LMArch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.layers import module_leaves, rebuild_params
from repro_torch.optim import (OptimizerConfig, apply_updates,
                               init_opt_state)
from repro_torch.train import make_train_step

DENSE = ("qwen3-8b", "codeqwen1.5-7b", "h2o-danube-3-4b")
MOE = ("mixtral-8x7b", "deepseek-v2-236b")
B, S = 4, 40          # S past the smoke configs' 32-wide attention blocks
WEIGHTS = np.array([1.0, 0.0, 0.5, 1.0], np.float32)   # one record dropped


def t(x):
    return torch.from_numpy(np.array(x))


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def model(arch_id):
    """(ref cfg, ref params, port cfg, tokens (B, S+1)) of an arch's smoke
    config; the reference's params hold zeros in two leaves, so an unused
    and a dead weight are in the tree."""
    rc = j_get_arch(arch_id).smoke()
    rp = JT.init(rc, jax.random.PRNGKey(0))
    ffn = rp["layers"]["moe" if rc.is_moe else "ffn"]
    ffn["w_up"] = ffn["w_up"].at[..., :3].set(0.0)
    rp["lm_head"] = rp["lm_head"].at[:, :7].set(0.0)
    tc = TT.TransformerConfig(**dataclasses.asdict(rc))
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, S + 1)
                                             ).astype(np.int32)
    return rc, rp, tc, toks


def port_params(tc, rp):
    return convert.transformer_params_from_numpy(
        tc, jax.tree.map(np.asarray, rp), "cpu")


def grads_as_tree(tc, params, grads: dict) -> dict:
    """The port's {name: grad} in the reference's tree (stacked)."""
    return convert.transformer_params_to_numpy(
        tc, rebuild_params(params, {n: g.detach() for n, g in
                                    grads.items()}))


# --------------------------------------------------------- the objective //

def test_weighted_xent_matches_reference():
    r = np.random.default_rng(0)
    logits = (r.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = r.integers(0, 50, (3, 7)).astype(np.int32)
    w = r.random((3, 7)).astype(np.float32)
    w[1] = 0.0
    for weights in (w, np.zeros_like(w), np.full_like(w, 0.01)):
        want = float(JL.weighted_xent(jnp.asarray(logits),
                                      jnp.asarray(labels),
                                      jnp.asarray(weights)))
        got = TL.weighted_xent(t(logits), t(labels), t(weights))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-5 * max(abs(want), 1e-30)
    # all-zero weights: the denominator is max(sum w, 1), the loss 0
    assert float(TL.weighted_xent(t(logits), t(labels),
                                  t(np.zeros_like(w)))) == 0.0
    # bf16 logits are taken in fp32, as the reference does
    got = TL.weighted_xent(t(logits).bfloat16(), t(labels), t(w))
    want = JL.weighted_xent(jnp.asarray(logits, jnp.bfloat16),
                            jnp.asarray(labels), jnp.asarray(w))
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@functools.lru_cache(maxsize=None)
def ref_forward(arch_id):
    rc, rp, _, toks = model(arch_id)

    def loss(p):
        return JT.forward(rc, p, jnp.asarray(toks), jnp.asarray(WEIGHTS))

    (l, logits), g = jax.jit(jax.value_and_grad(loss, has_aux=True))(rp)
    return float(l), np.asarray(logits), jax.tree.map(np.asarray, g)


@pytest.mark.parametrize("arch_id", DENSE + MOE)
def test_forward_and_grads_match_reference(arch_id):
    """Loss and logits within 1e-5, every gradient leaf within 1e-4 of
    its max |g| — the zeroed leaves' gradients included; for the MoE
    configs the router's and the experts', and deepseek's MLA and its
    unstacked dense first layer."""
    _, rp, tc, toks = model(arch_id)
    want_l, want_logits, want_g = ref_forward(arch_id)
    params = port_params(tc, rp)
    loss, logits = TT.forward(tc, params, t(toks), t(WEIGHTS))
    assert loss.dtype == torch.float32 and logits.dtype == tc.dtype
    assert abs(loss.item() - want_l) <= 1e-5 * abs(want_l)
    assert rel_err(logits.detach(), want_logits) <= 1e-5
    names = [n for n, _ in params.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(params.parameters()))))
    got_g = grads_as_tree(tc, params, grads)
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want_g)
    flat_g = dict(jax.tree_util.tree_flatten_with_path(got_g)[0])
    assert len(flat_w) == len(flat_g)
    for path, want in flat_w:
        assert rel_err(flat_g[path], want) <= 1e-4, \
            jax.tree_util.keystr(path)
    # weights None are ones
    l1, _ = TT.forward(tc, params, t(toks))
    l2, _ = TT.forward(tc, params, t(toks), torch.ones(B))
    assert l1.item() == l2.item()


@pytest.mark.parametrize("remat", ("full", "dots"))
def test_remat_equals_none_bit_for_bit(remat):
    """Recomputing a layer in the backward pass changes nothing: the loss
    and every gradient equal remat="none"'s exactly."""
    _, rp, tc, toks = model("qwen3-8b")
    out = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(tc, remat=mode)
        params = port_params(cfg, rp)
        loss, _ = TT.forward(cfg, params, t(toks), t(WEIGHTS))
        out[mode] = [loss.detach()] + list(torch.autograd.grad(
            loss, list(params.parameters())))
    for a, b in zip(out["none"], out[remat]):
        assert torch.equal(a, b)
    # serving never remats and records no graph
    cfg = dataclasses.replace(tc, remat=remat)
    params = port_params(cfg, rp)
    assert not TT.prefill(cfg, params, t(toks[:, :S])).requires_grad


# ------------------------------------------------------ the train step -- //

TRAIN_TOL = {"float32": 1e-4, "bfloat16": 8e-3}


@pytest.mark.parametrize("accum, accum_dtype", (
    (1, "float32"), (2, "float32"), (2, "bfloat16")))
def test_make_train_step_matches_reference(accum, accum_dtype):
    """Three AdamW steps with and without gradient accumulation (the
    buffer's dtype matters only with it): loss, grad_norm, lr, params, m
    and v against the reference's step."""
    rc, rp, tc, toks = model("qwen3-8b")
    kw = dict(kind="adamw", lr=1e-3, warmup_steps=2, total_steps=10)
    jdt = getattr(jnp, accum_dtype)
    tdt = getattr(torch, accum_dtype)
    tol = TRAIN_TOL[accum_dtype]

    def j_loss(p, b, w):
        return JT.forward(rc, p, b, w)[0]

    def t_loss(p, b, w):
        return TT.forward(tc, p, b, w)[0]

    jstep = jax.jit(j_make_train_step(j_loss, JOptConfig(**kw), accum,
                                      jdt if accum > 1 else None))
    tstep = make_train_step(t_loss, OptimizerConfig(**kw), accum,
                            tdt if accum > 1 else None)
    jp, tp = rp, port_params(tc, rp)
    js = j_init_opt(JOptConfig(**kw), jp)
    ts = init_opt_state(OptimizerConfig(**kw), tp)
    r = np.random.default_rng(9)
    for i in range(3):
        batch = r.integers(0, rc.vocab, (B, S + 1)).astype(np.int32)
        w = None if i == 1 else WEIGHTS
        jp, js, jm = jstep(jp, js, jnp.asarray(batch),
                           None if w is None else jnp.asarray(w))
        tp, ts, tm = tstep(tp, ts, t(batch), None if w is None else t(w))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"])), i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            tol * float(jm["grad_norm"]), i
        # the cosine in fp32: XLA's cos under jit and torch's, an ulp apart
        assert abs(float(tm["lr"]) - float(jm["lr"])) <= \
            1e-6 * float(jm["lr"]), i
        assert int(ts.step) == int(js.step) == i + 1
        got_p = convert.transformer_params_to_numpy(tc, tp)
        for tree_t, tree_j, what in ((got_p, jp, "params"),
                                     (ts.m, js.m, "m"), (ts.v, js.v, "v")):
            flat_t = dict(jax.tree_util.tree_flatten_with_path(
                jax.tree.map(lambda x: np.asarray(x, np.float32) if
                             isinstance(x, np.ndarray) else
                             x.detach().numpy(), tree_t))[0])
            for path, want in jax.tree_util.tree_flatten_with_path(
                    tree_j)[0]:
                assert rel_err(flat_t[path], want) <= tol, \
                    (what, jax.tree_util.keystr(path), i)


def test_make_train_step_refuses_a_ragged_split():
    _, rp, tc, toks = model("qwen3-8b")
    step = make_train_step(lambda p, b, w: TT.forward(tc, p, b, w)[0],
                           OptimizerConfig(), accum_steps=3)
    params = port_params(tc, rp)
    with pytest.raises(ValueError, match="microbatches"):
        step(params, init_opt_state(OptimizerConfig(), params), t(toks))


@pytest.mark.parametrize("arch_id", ("qwen3-8b", "h2o-danube-3-4b") + MOE)
def test_lm_arch_train_step_matches_reference(arch_id):
    """``LMArch(...).step("train_4k")`` at the smoke config — the
    reference's optimizer and its accumulation factor (4 / 2 / 4 / 8) —
    one step against the reference's. The batch is B rows, or one row
    per microbatch where the factor is larger (deepseek's 8)."""
    rc, rp, tc, toks = model(arch_id)
    accum = j_get_arch(arch_id).accum
    n = max(B, accum["train_4k"])
    toks = np.resize(toks, (n, S + 1))
    weights = np.resize(WEIGHTS, n)
    jarch = JLMArch(arch_id, rc, accum=accum)
    tarch = LMArch(arch_id, tc, accum=dict(accum))
    jp, tp = rp, port_params(tc, rp)
    js = j_init_opt(jarch.opt_config(), jp)
    ts = init_opt_state(tarch.opt_config(), tp)
    jp, js, jm = jax.jit(jarch.step("train_4k"))(
        jp, js, jnp.asarray(toks), jnp.asarray(weights))
    tp, ts, tm = tarch.step("train_4k")(tp, ts, t(toks), t(weights))
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    got = convert.transformer_params_to_numpy(tc, tp)
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        have = dict(jax.tree_util.tree_flatten_with_path(got)[0])[path]
        assert rel_err(have, want) <= 1e-4, jax.tree_util.keystr(path)


def test_dense_layers_are_unstacked_leaves():
    """deepseek's dense first layer is a list item of the reference's
    tree: ``module_leaves`` gives its parameters as unstacked leaves
    (``dense_layers/0/...``), so AdamW leaves its (d,) norms undecayed
    while the stacked (L, d) norms of ``layers`` decay — with zero
    gradients one step moves exactly the decayed leaves, as the
    reference's step does."""
    rc, rp, tc, toks = model("deepseek-v2-236b")
    params = port_params(tc, rp)
    leaves = {lf.path: lf for lf in module_leaves(params)}
    dense = {p: lf for p, lf in leaves.items() if p[0] == "dense_layers"}
    assert dense and all(p[1] == 0 and not lf.stacked
                         for p, lf in dense.items())
    assert dense["dense_layers", 0, "attn", "norm"].ref_shape == (64,)
    assert leaves["layers", "attn", "norm"].ref_shape == (1, 64)
    assert [lf.path for lf in module_leaves(params)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(rp)[0]]
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=0)
    jp, _ = j_apply_updates(JOptConfig(**dataclasses.asdict(cfg)), rp,
                            jax.tree.map(jnp.zeros_like, rp),
                            j_init_opt(JOptConfig(), rp))[:2]
    before = convert.transformer_params_to_numpy(tc, params)
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    apply_updates(cfg, params, grads, init_opt_state(cfg, params))
    after = convert.transformer_params_to_numpy(tc, params)
    np.testing.assert_array_equal(
        after["dense_layers"][0]["attn"]["norm"], np.ones(64, np.float32))
    assert (after["layers"]["attn"]["norm"] < 1).all()
    for path, want in jax.tree_util.tree_flatten_with_path(jp)[0]:
        have = dict(jax.tree_util.tree_flatten_with_path(after)[0])[path]
        old = dict(jax.tree_util.tree_flatten_with_path(before)[0])[path]
        assert np.array_equal(have, old) == np.array_equal(
            np.asarray(want), old), jax.tree_util.keystr(path)
        assert rel_err(have, want) <= 1e-6, jax.tree_util.keystr(path)


def fp32_distances_from_float64(seeds=range(4)):
    """-> (port's, reference's) global distance (2-norm, relative) of the
    fp32 gradients from the port's float64 gradients, one per seed: the
    training driver's cpu-small config at the reference's init of that
    seed, on the first batch ``lm_batches`` draws for it, weights ones.

        PYTHONPATH=src python -c "from tests.test_torch_train import \\
            fp32_distances_from_float64 as f; print(f())"
    """
    from repro.data.lm import lm_batches
    from repro_torch.launch.train import preset_config
    cfg = preset_config("cpu-small")
    rc = JT.TransformerConfig(**{**dataclasses.asdict(cfg),
                                 "dtype": jnp.float32})
    j_grad = jax.jit(jax.grad(lambda p, x, w: JT.forward(rc, p, x, w)[0]))

    def distance(g, ref):
        num = sum(float(((g[n] - ref[n]) ** 2).sum()) for n in ref)
        return np.sqrt(num / sum(float((ref[n] ** 2).sum()) for n in ref))

    port, jax_ = [], []
    for seed in seeds:
        rp = JT.init(rc, jax.random.PRNGKey(seed))
        toks = next(lm_batches(cfg.vocab, 8, 128, dup_frac=0.3,
                               seed=seed))["tokens"]
        w = np.ones(8, np.float32)
        jg = port_params(cfg, j_grad(rp, jnp.asarray(toks), jnp.asarray(w)))
        jg = {n: p.detach().double() for n, p in jg.named_parameters()}
        tg = {}
        for dt in (torch.float32, torch.float64):
            c = dataclasses.replace(cfg, dtype=dt)
            prm = port_params(c, rp).to(dt)
            loss = TT.forward(c, prm, t(toks), t(w).to(dt))[0]
            tg[dt] = {n: g.double() for (n, _), g in zip(
                prm.named_parameters(),
                torch.autograd.grad(loss, list(prm.parameters())))}
        port.append(distance(tg[torch.float32], tg[torch.float64]))
        jax_.append(distance(jg, tg[torch.float64]))
    return port, jax_


def test_fp32_gradients_as_near_float64_as_the_reference():
    """At the training driver's cpu-small config and the reference's init
    (fan-in on the heads axis: attention saturates, so its softmax
    backward cancels), both frameworks' fp32 gradients sit measurably off
    the float64 gradients of the same step. Held against one referee, the
    port's float64 forward (its norms, softmax, cross entropy and RoPE
    frequencies in the compute dtype where that is wider than fp32), the
    port is about as accurate as the reference: over four seeds its
    summed distance is within 1.5x of the reference's. Per seed either
    may be nearer; a referee that kept the reference's fp32 reductions
    (its float64 run under ``jax_enable_x64``) would share their rounding
    and flatter the reference's distance."""
    port, jax_ = fp32_distances_from_float64()
    assert all(np.isfinite(port + jax_)) and max(port + jax_) > 1e-4
    assert sum(port) <= 1.5 * sum(jax_), (port, jax_)



def test_grouped_routing_with_drops_matches_reference(monkeypatch):
    """The backward of grouped routing where pairs drop — the path of a
    routed layer's train step at full width, where a microbatch of 4 x
    4096 tokens routes in two groups of 8192: deepseek's smoke config
    (MLA, routed and shared experts, the dense first layer) with 8 routed
    experts (its top 4 of the smoke config's 4 experts route every token
    to every expert, so nothing could drop) and ``moe_group_size`` 20.
    One ``LMArch.step("train_4k")`` (accumulation 8: microbatches of 1 x
    40 tokens, each routed in 2 groups at capacity 13 per expert; pairs
    drop) from the port's seeded init crossed to the reference, against
    the reference's step: the loss within 1e-5, the grad norm, the first
    and second moments (the clipped, accumulated gradients and their
    squares) and every param after the update within 1e-4 of their max
    |value|."""
    from repro_torch.models import moe as TM
    rc = dataclasses.replace(j_get_arch("deepseek-v2-236b").smoke(),
                             n_experts=8, moe_group_size=20)
    tc = TT.TransformerConfig(**dataclasses.asdict(rc))
    params = TT.init(tc, 0, "cpu")
    rp = jax.tree.map(jnp.asarray,
                      convert.transformer_params_to_numpy(tc, params))
    accum = j_get_arch("deepseek-v2-236b").accum
    n = accum["train_4k"]
    toks = np.random.default_rng(1).integers(0, rc.vocab, (n, S + 1)
                                             ).astype(np.int32)
    weights = np.resize(WEIGHTS, n)
    routed, route = [], TM._route

    def recording(prm, x, cfg):
        ids, w = route(prm, x, cfg)
        flat = ids.reshape(ids.shape[0], -1)
        load = torch.zeros((flat.shape[0], cfg.n_experts), dtype=torch.int64
                           ).scatter_add_(1, flat, torch.ones_like(flat))
        cap = TM._capacity(x.shape[-2], cfg)
        routed.append((ids.shape[0], cap,
                       int((load - cap).clamp(min=0).sum())))
        return ids, w

    monkeypatch.setattr(TM, "_route", recording)
    jarch = JLMArch("deepseek-v2-236b", rc, accum=accum)
    tarch = LMArch("deepseek-v2-236b", tc, accum=dict(accum))
    jp, js, jm = jax.jit(jarch.step("train_4k"))(
        rp, j_init_opt(jarch.opt_config(), rp), jnp.asarray(toks),
        jnp.asarray(weights))
    tp, ts, tm = tarch.step("train_4k")(
        params, init_opt_state(tarch.opt_config(), params), t(toks),
        t(weights))
    assert len(routed) == n and {r[:2] for r in routed} == {(2, 13)}
    assert sum(r[2] for r in routed) > 0, routed
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
        1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
        1e-4 * float(jm["grad_norm"])
    got_p = convert.transformer_params_to_numpy(tc, tp)
    for tree_t, tree_j, what in ((got_p, jp, "params"), (ts.m, js.m, "m"),
                                 (ts.v, js.v, "v")):
        flat_t = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(
            lambda x: x if isinstance(x, np.ndarray) else
            x.detach().numpy(), tree_t))[0])
        for path, want in jax.tree_util.tree_flatten_with_path(tree_j)[0]:
            assert rel_err(flat_t[path], want) <= 1e-4, \
                (what, jax.tree_util.keystr(path))
