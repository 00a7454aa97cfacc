"""The port's optimizer (``repro_torch.optim``) on the CPU against
``repro.optim``: the reference's four optimizer tests mirrored, and
``apply_updates`` over 5 steps for adamw and sgd on a tree that has a
stacked (L, d) norm and a (d,) norm. Tolerances: fp32 params, m and v to
1e-6 of the leaf's max |value| (two frameworks' fp32 elementwise math and
reductions, a few ulps apart); bf16 params exactly, after the cast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from repro.optim import OptimizerConfig as JOptConfig
from repro.optim import apply_updates as j_apply
from repro.optim import init_opt_state as j_init
from repro_torch.models.layers import Params, module_leaves
from repro_torch.optim import (OptimizerConfig, apply_updates,
                               clip_by_global_norm, init_opt_state,
                               schedule)

L, D, V = 3, 8, 16
RTOL = 1e-6


# ------------------------------------------ the reference's tests, mirrored //

def test_adamw_minimizes_quadratic():
    cfg = OptimizerConfig(kind="adamw", lr=0.1, weight_decay=0.0,
                          warmup_steps=1, total_steps=200)
    params = Params(w=torch.tensor([5.0, -3.0]))
    state = init_opt_state(cfg, params)
    for _ in range(150):
        grads = {"w": 2 * params["w"].detach()}
        params, state, _ = apply_updates(cfg, params, grads, state)
    assert float(params["w"].abs().max()) < 0.1


def test_sgd_momentum_minimizes():
    cfg = OptimizerConfig(kind="sgd", lr=0.05, momentum=0.9,
                          warmup_steps=1, total_steps=100)
    params = Params(w=torch.tensor(4.0))
    state = init_opt_state(cfg, params)
    for _ in range(80):
        params, state, _ = apply_updates(
            cfg, params, {"w": 2 * params["w"].detach()}, state)
    assert abs(float(params["w"])) < 0.2


def test_clip_by_global_norm():
    g = {"a": torch.full((10,), 10.0)}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert np.isclose(float(gn), np.sqrt(1000.0), rtol=1e-5)
    total = float(torch.sqrt(sum((x ** 2).sum()
                                 for x in clipped.values())))
    assert np.isclose(total, 1.0, rtol=1e-4)


def test_schedule_warmup_cosine():
    cfg = OptimizerConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
    assert float(schedule(cfg, torch.tensor(5))) == 0.5
    assert float(schedule(cfg, torch.tensor(10))) >= 0.99
    assert np.isclose(float(schedule(cfg, torch.tensor(100))), 0.1,
                      atol=1e-3)


# ----------------------------------------------- against the reference ---- //

def _ref_tree(rng, dtype):
    """The reference's tree: per-layer leaves stacked on L."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"embed": f(V, D).astype(dtype),
            "layers": {"norm": 1 + f(L, D), "w": f(L, D, D).astype(dtype)},
            "final_norm": 1 + f(D)}


def _port_params(tree, torch_dtype):
    def t(a, dt=torch.float32):
        return torch.from_numpy(np.array(a, np.float32)).to(dt)
    return Params(
        embed=t(tree["embed"], torch_dtype),
        layers=nn.ModuleList(
            Params(norm=t(tree["layers"]["norm"][i]),
                   w=t(tree["layers"]["w"][i], torch_dtype))
            for i in range(L)),
        final_norm=t(tree["final_norm"]))


def _port_grads(gtree):
    out = {"embed": gtree["embed"], "final_norm": gtree["final_norm"]}
    for i in range(L):
        out[f"layers.{i}.norm"] = gtree["layers"]["norm"][i]
        out[f"layers.{i}.w"] = gtree["layers"]["w"][i]
    return {k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in
            out.items()}


def _port_tree(params):
    """The port's params in the reference's structure (stacked), fp32."""
    out = {"embed": params["embed"], "final_norm": params["final_norm"],
           "layers": {n: torch.stack([lp[n] for lp in params["layers"]])
                      for n in ("norm", "w")}}
    return jax.tree.map(lambda x: x.detach().float().numpy(), out)


def _close(got, want, ctx):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, ctx
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= RTOL * scale, ctx


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("adamw", "sgd"))
def test_apply_updates_matches_reference(kind, dtype):
    """Five steps of clipped updates, the stacked (L, d) norm decayed and
    the (d,) final norm not, as in the reference."""
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kw = dict(kind=kind, lr=0.05, warmup_steps=2, total_steps=6)
    jcfg, tcfg = JOptConfig(**kw), OptimizerConfig(**kw)
    rng = np.random.default_rng(3)
    tree = _ref_tree(rng, np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    jparams = {"embed": jparams["embed"].astype(jdt),
               "layers": {"norm": jparams["layers"]["norm"],
                          "w": jparams["layers"]["w"].astype(jdt)},
               "final_norm": jparams["final_norm"]}
    tparams = _port_params(tree, tdt)
    leaves = module_leaves(tparams)
    assert [lf.path for lf in leaves] == [
        ("embed",), ("final_norm",), ("layers", "norm"), ("layers", "w")]
    assert [lf.ref_shape for lf in leaves] == [(V, D), (D,), (L, D),
                                               (L, D, D)]
    js, ts = j_init(jcfg, jparams), init_opt_state(tcfg, tparams)
    for step in range(5):
        g = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 3).astype(
            np.float32), tree)
        jparams, js, jm = j_apply(jcfg, jparams, jax.tree.map(
            lambda a, p: jnp.asarray(a).astype(p.dtype), g, jparams), js)
        tparams, ts, tm = apply_updates(tcfg, tparams, {
            k: v.to(tdt) if k in ("embed",) or k.endswith(".w") else v
            for k, v in _port_grads(g).items()}, ts)
        assert int(ts.step) == int(js.step) == step + 1
        assert float(tm["lr"]) == float(jm["lr"])
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            RTOL * float(jm["grad_norm"])
        got = _port_tree(tparams)
        for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
            name = jax.tree_util.keystr(path)
            have = _get(got, path)
            if dtype == "bfloat16" and want.dtype == jnp.bfloat16:
                assert np.array_equal(have, np.asarray(want, np.float32)), \
                    (name, step)
            else:
                _close(have, want, (name, step))
        for which in ("m", "v"):
            for path, want in jax.tree_util.tree_flatten_with_path(
                    getattr(js, which))[0]:
                have = _get(getattr(ts, which), path).numpy()
                _close(have, want, (which, jax.tree_util.keystr(path), step))


def _get(tree, path):
    for p in path:
        tree = tree[p.key]
    return tree


def test_decay_follows_the_reference_rank():
    """With zero gradients the update is the decay alone: the stacked
    (L, d) norm shrinks, the (d,) final norm and nothing else stays."""
    cfg = OptimizerConfig(kind="adamw", lr=0.5, warmup_steps=0,
                          weight_decay=0.1)
    params = _port_params(_ref_tree(np.random.default_rng(0), np.float32),
                          torch.float32)
    before = {n: p.detach().clone() for n, p in params.named_parameters()}
    grads = {n: torch.zeros_like(p) for n, p in params.named_parameters()}
    apply_updates(cfg, params, grads, init_opt_state(cfg, params))
    for n, p in params.named_parameters():
        moved = not torch.equal(p, before[n])
        assert moved == (n != "final_norm"), n


def test_opt_state_crosses_packages():
    """The reference's optimizer state through ``convert`` and back: the
    same tree, step and moments, and the port's update from it equal to
    the reference's."""
    from repro_torch.convert import opt_state_from_numpy, opt_state_to_numpy
    kw = dict(kind="adamw", lr=0.05, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(4)
    tree = _ref_tree(rng, np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    js = j_init(JOptConfig(**kw), jparams)
    g = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                     tree)
    jparams, js, _ = j_apply(JOptConfig(**kw), jparams,
                             jax.tree.map(jnp.asarray, g), js)
    ts = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert ts.step.dtype == torch.int32 and ts.step.device.type == "cpu"
    back = opt_state_to_numpy(ts)
    assert back.step == np.asarray(js.step)
    for which in ("m", "v"):
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_flatten_with_path(getattr(back, which))[0],
                jax.tree_util.tree_flatten_with_path(getattr(js, which))[0]):
            assert pa == pb and np.array_equal(a, np.asarray(b))
    tparams = _port_params(jax.tree.map(np.asarray, jparams), torch.float32)
    jparams, js, _ = j_apply(JOptConfig(**kw), jparams,
                             jax.tree.map(jnp.asarray, g), js)
    tparams, ts, _ = apply_updates(OptimizerConfig(**kw), tparams,
                                   _port_grads(g), ts)
    got = _port_tree(tparams)
    for path, want in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        _close(_get(got, path), want, jax.tree_util.keystr(path))
