"""The port's MoE FFN and MLA attention (``repro_torch.models.moe``, the
MLA functions of ``repro_torch.models.transformer``) against the
reference's (``repro.models``) on the CPU, in fp32, from one set of
weights: the reference's seeded params cross as numpy, inputs are made
with numpy from a seed. Tolerances: router ids exactly, router weights
1e-6 (two frameworks' fp32 softmax); ``moe_apply`` 1e-5 (its combine is a
scatter-add, summed in another order); each MLA function 2e-5 of max(1,
max |value|) (the reference's layer tolerance); the reference's own three
target tests (``tests/test_models.py``) at their tolerances."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TT
from repro_torch.models.layers import Params


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def as_params(tree) -> Params:
    """A ``Params`` node of a (nested) dict of the reference's arrays."""
    out = Params()
    for k, v in tree.items():
        out[k] = as_params(v) if isinstance(v, dict) else t(v)
    return out


def moe_pair(seed=0, **kw):
    """(reference cfg, reference params, port cfg, port params)."""
    cfg = JM.MoEConfig(**{"d_model": 32, "d_ff_expert": 64, **kw})
    p = JM.moe_init(jax.random.PRNGKey(seed), cfg, jnp.float32)
    return cfg, p, TM.MoEConfig(*cfg), as_params(p)


def ref_overflow(cfg, p, x) -> int:
    """(token, slot) pairs the reference drops: past each expert's
    capacity in each routing group."""
    T = x.shape[0]
    g = cfg.group_size if (cfg.group_size and T > cfg.group_size
                           and T % cfg.group_size == 0) else T
    dropped = 0
    for xi in x.reshape(T // g, g, -1):
        ids, _ = JM._route(p, xi, cfg)
        load = np.bincount(np.asarray(ids).ravel(), minlength=cfg.n_experts)
        dropped += int(np.maximum(load - JM._capacity(g, cfg), 0).sum())
    return dropped


# -------------------------------------------------------------- routing //

@pytest.mark.parametrize("E, k", [(4, 2), (8, 2), (16, 4), (160, 6)])
def test_route_matches_reference(E, k):
    """The same top-k ids in the same order, weights within 1e-6; with a
    zero router every expert ties, and both pick ids 0 .. k-1 in order
    (``lax.top_k`` breaks a tie toward the lower id)."""
    cfg, p, tc, tp = moe_pair(n_experts=E, top_k=k)
    x = rand((96, 32), E)
    for router in (p["router"], np.zeros((32, E), np.float32)):
        q = dict(p, router=router)
        ids, w = JM._route(q, x, cfg)
        tids, tw = TM._route(as_params(q), t(x), tc)
        np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
        np.testing.assert_allclose(tw.detach().numpy(), np.asarray(w),
                                   atol=1e-6)
    np.testing.assert_array_equal(tids.numpy(),
                                  np.broadcast_to(np.arange(k), (96, k)))


def test_capacity_matches_reference():
    for T in (1, 2, 7, 8, 64, 256, 1000, 1024, 8192):
        for E, k in ((4, 2), (8, 2), (16, 4), (160, 6)):
            for cf in (0.5, 1.0, 1.25, 2.0, E / k):
                cfg = JM.MoEConfig(E, k, 32, 64, capacity_factor=cf)
                assert TM._capacity(T, TM.MoEConfig(*cfg)) == \
                    JM._capacity(T, cfg), (T, E, k, cf)


# ------------------------------------------------------------ moe_apply //

DROPS = dict(n_experts=16, top_k=4, capacity_factor=1.0)   # T 256: drops
LOSSLESS = dict(n_experts=4, top_k=2, capacity_factor=4.0)


@pytest.mark.parametrize("shared", [0, 2])
@pytest.mark.parametrize("group", [0, 16])
@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
@pytest.mark.parametrize("case", ["drops", "lossless"])
def test_moe_apply_matches_reference(case, dispatch, group, shared):
    """Both dispatches, one group and groups of 16, with and without
    shared experts. Where the reference drops pairs (asserted), equality
    shows the port drops the same ones."""
    kw = DROPS if case == "drops" else LOSSLESS
    T = 256 if case == "drops" else 64
    cfg, p, tc, tp = moe_pair(seed=3, dispatch=dispatch, group_size=group,
                              n_shared=shared, **kw)
    x = rand((T, 32), 4)
    dropped = ref_overflow(cfg, p, x)
    assert (dropped > 0) == (case == "drops"), dropped
    want = np.asarray(JM.moe_apply(p, x, cfg))
    got = TM.moe_apply(tp, t(x), tc)
    assert got.shape == (T, 32)
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    # a leading batch shape is the same tokens
    np.testing.assert_allclose(
        TM.moe_apply(tp, t(x.reshape(4, T // 4, 32)), tc).detach().numpy(),
        want.reshape(4, T // 4, 32), atol=1e-5)


@pytest.mark.parametrize("dispatch", ["einsum", "sort"])
def test_dropped_pairs_are_the_reference_queue_tail(dispatch):
    """The tokens whose output changes between capacity factor 1.0 and a
    factor where nothing drops are exactly those with a pair past its
    expert's capacity in the reference's (token, slot) queue order."""
    cfg, p, tc, tp = moe_pair(seed=3, dispatch=dispatch, **DROPS)
    x = rand((256, 32), 4)
    lossy = TM.moe_apply(tp, t(x), tc).detach().numpy()
    full = TM.moe_apply(tp, t(x), tc._replace(
        capacity_factor=16 / 4)).detach().numpy()
    ids = np.asarray(JM._route(p, x, cfg)[0])              # (T, k)
    seen = np.zeros(16, int)
    tail = np.zeros(256, bool)
    for tok, e in zip(np.repeat(np.arange(256), 4), ids.ravel()):
        tail[tok] |= seen[e] >= JM._capacity(256, cfg)
        seen[e] += 1
    assert 0 < tail.sum() < 256
    np.testing.assert_array_equal(np.abs(lossy - full).max(-1) > 1e-5,
                                  tail)


# ------------------------------------ the reference's three target tests //

def port_moe(cfg: TM.MoEConfig, seed: int = 0) -> Params:
    gen = torch.Generator().manual_seed(seed)
    return TM.moe_init(gen, cfg, torch.float32, "cpu")


def test_moe_sort_equals_einsum():
    """``tests/test_models.py::test_moe_sort_equals_einsum`` on the port."""
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff_expert=64,
                       capacity_factor=4.0)
    p = port_moe(cfg)
    x = t(rand((64, 32), 1))
    a = TM.moe_apply(p, x, cfg)
    b = TM.moe_apply(p, x, cfg._replace(dispatch="sort"))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=1e-5)


def test_moe_grouping_preserves_routing():
    """``tests/test_models.py::test_moe_grouping_preserves_routing`` on
    the port."""
    cfg = TM.MoEConfig(n_experts=4, top_k=2, d_model=32, d_ff_expert=64,
                       capacity_factor=8.0, dispatch="sort")
    p = port_moe(cfg)
    x = t(rand((64, 32), 1))
    a = TM.moe_apply(p, x, cfg)
    b = TM.moe_apply(p, x, cfg._replace(group_size=16))
    np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                               atol=1e-5)


BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab=128, dtype=torch.float32, attn_q_block=32, attn_k_block=32)
MLA = dict(use_mla=True, q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
           qk_rope_dim=8, v_head_dim=16)


def test_mla_absorbed_equals_naive_decode():
    """``tests/test_models.py::test_mla_absorbed_equals_naive_decode`` on
    the port: greedy decode, absorbed and naive, within 1e-4."""
    c1 = TT.TransformerConfig(name="a", mla_absorb=False, **BASE, **MLA)
    c2 = TT.TransformerConfig(name="b", mla_absorb=True, **BASE, **MLA)
    params = TT.init(c1, 0, "cpu")
    cache1, cache2 = TT.init_cache(c1, 2, 16, "cpu"), \
        TT.init_cache(c2, 2, 16, "cpu")
    tok = torch.tensor([5, 7], dtype=torch.int32)
    for s in range(5):
        pos = torch.full((2,), s, dtype=torch.int32)
        l1, cache1 = TT.decode_step(c1, params, cache1, tok, pos)
        l2, cache2 = TT.decode_step(c2, params, cache2, tok, pos)
        np.testing.assert_allclose(l1.numpy(), l2.numpy(), atol=1e-4)
        tok = l1.argmax(-1).to(torch.int32)


# ------------------------------------------------------- MLA functions //

def mla_pair(q_lora: bool):
    """(reference cfg, its attention params, port cfg, port params)."""
    rc = JT.TransformerConfig(name="m", **{**BASE, "dtype": jnp.float32},
                              **{**MLA, "q_lora_rank": 32 if q_lora else 0})
    rp = JT._attn_init(rc, jax.random.PRNGKey(5))
    tc = TT.TransformerConfig(**dataclasses.asdict(rc))
    return rc, rp, tc, as_params(rp)


MLA_FNS = ("_mla_q", "_mla_latent", "_mla_kv_heads", "_mla_attention",
           "_mla_attention_absorbed", "_attn_apply")


@pytest.mark.parametrize("q_lora", [True, False])
@pytest.mark.parametrize("fn", MLA_FNS)
def test_mla_function_matches_reference(fn, q_lora):
    """Each MLA function on the same inputs within 2e-5 of max(1,
    max |value|) (the absorbed form's outputs reach ~10): the queries (with
    and without q compression), the latent, its per-head K/V, naive and
    absorbed attention over a cache with empty slots, and the prefill's
    blocked attention (S past its 32-wide blocks)."""
    rc, rp, tc, tp = mla_pair(q_lora)
    B, S = 2, 40
    x = rand((B, S, 64), 6)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    c_kv, k_pe = rand((B, S, 32), 7), rand((B, S, 8), 8)
    kpos = pos.copy()
    kpos[:, 30:] = -1                                     # empty slots
    qpos = np.full((B, 1), 29, np.int32)
    mask = np.asarray(JT.attention_scores_mask(qpos, kpos)) & (
        kpos >= 0)[:, None, :]
    xq = x[:, 29:30]
    args = {
        "_mla_q": (x, pos),
        "_mla_latent": (x, pos),
        "_mla_kv_heads": (c_kv, k_pe),
        "_mla_attention": (xq, qpos, kpos, c_kv, k_pe, mask),
        "_mla_attention_absorbed": (xq, qpos, c_kv, k_pe, mask),
        "_attn_apply": (x, pos),
    }[fn]
    want = getattr(JT, fn)(rp, rc, *args)
    got = getattr(TT, fn)(tp, tc, *map(t, args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        w = np.asarray(w)
        np.testing.assert_allclose(g.detach().numpy(), w,
                                   atol=2e-5 * max(1.0, np.abs(w).max()))
