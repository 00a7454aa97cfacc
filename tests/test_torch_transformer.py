"""The port's transformer (``repro_torch.models``), dense, MoE and MLA,
against the reference's (``repro.models``) on the CPU, from one set of
weights: the
reference's seeded param tree crosses through
``repro_torch.convert.transformer_params_from_numpy``, inputs are made
with numpy from a seed. Everything runs in fp32, the reference's own smoke
dtype, so the tolerances are the reference's: 2e-5 for the layers (its
flash tolerance), 1e-4 for logits and cache leaves across the two
frameworks (fp32 einsums reduce in another order), 3e-4 for decode against
prefill inside the port (the reference's ``test_decode_matches_prefill``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as j_all_arch_ids
from repro.configs import get_arch as j_get_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch import convert
from repro_torch.configs import LMArch, all_arch_ids, get_arch
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT

DENSE = ("qwen3-8b", "codeqwen1.5-7b", "h2o-danube-3-4b")
MOE_MLA = ("mixtral-8x7b", "deepseek-v2-236b")
ALL = DENSE + MOE_MLA
B, S = 2, 40          # S > the smoke configs' 32-wide attention blocks, and
                      # past danube's window of 16 twice over


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


def port_cfg(ref_cfg):
    return TT.TransformerConfig(**dataclasses.asdict(ref_cfg))


@functools.lru_cache(maxsize=None)
def model(arch_id):
    """(ref cfg, ref params, port cfg, port params, tokens) of an arch's
    smoke config, built once per worker."""
    rc = j_get_arch(arch_id).smoke()
    rp = JT.init(rc, jax.random.PRNGKey(0))
    tc = port_cfg(rc)
    tp = convert.transformer_params_from_numpy(
        tc, jax.tree.map(np.asarray, rp), "cpu")
    toks = np.random.default_rng(1).integers(0, rc.vocab, (B, S)
                                             ).astype(np.int32)
    return rc, rp, tc, tp, toks


# ------------------------------------------------------------- layers --- //

def test_rmsnorm_matches_reference():
    x, s = rand((3, 5, 64), 0), rand((64,), 1)
    np.testing.assert_allclose(TL.rmsnorm(t(x), t(s)).numpy(),
                               np.asarray(JL.rmsnorm(x, s)), atol=2e-5)


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    """Interleaved (even, odd) pairs, not the half-split form."""
    x = rand((2, 40, 4, 16), 2)
    pos = np.broadcast_to(np.arange(40, dtype=np.int32), (2, 40))
    np.testing.assert_allclose(
        TL.apply_rope(t(x), t(pos), theta).numpy(),
        np.asarray(JL.apply_rope(x, pos, theta)), atol=2e-5)
    np.testing.assert_allclose(TL.rope_freqs(16, theta).numpy(),
                               np.asarray(JL.rope_freqs(16, theta)),
                               rtol=1e-6)


@pytest.mark.parametrize("win", [None, 5])
def test_attention_mask_matches_reference(win):
    q = np.arange(12, dtype=np.int32)[None]
    k = np.concatenate([np.arange(10), [-1, -1]]).astype(np.int32)[None]
    np.testing.assert_array_equal(
        TL.attention_scores_mask(t(q), t(k), win).numpy(),
        np.asarray(JL.attention_scores_mask(q, k, win)))


def test_sdpa_matches_reference():
    q, k, v = rand((2, 7, 2, 3, 16), 3), rand((2, 9, 2, 16), 4), \
        rand((2, 9, 2, 16), 5)
    mask = np.random.default_rng(6).random((2, 7, 9)) < 0.7
    mask[0, 0] = False                       # a fully masked row: uniform
    np.testing.assert_allclose(
        TL.sdpa(t(q), t(k), t(v), t(mask)).numpy(),
        np.asarray(JL.sdpa(q, k, v, mask)), atol=2e-5)


@pytest.mark.parametrize("win", [None, 17])
@pytest.mark.parametrize("shape", [(2, 100, 2, 2, 16), (1, 257, 1, 4, 8)])
def test_flash_sdpa_matches_reference(win, shape):
    """The reference's ``test_flash_equals_naive`` shapes and blocks, the
    port's blocked path against the reference's and against its own naive
    path; a padded k_pos (-1) masks its keys out."""
    Bq, Sq, Kv, G, D = shape
    q, k, v = rand((Bq, Sq, Kv, G, D), 7), rand((Bq, Sq, Kv, D), 8), \
        rand((Bq, Sq, Kv, D), 9)
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32), (Bq, Sq)).copy()
    got = TL.flash_sdpa(t(q), t(k), t(v), t(pos), t(pos), win,
                        q_block=32, k_block=48).numpy()
    ref = np.asarray(JL.flash_sdpa(q, k, v, pos, pos, win,
                                   q_block=32, k_block=48))
    np.testing.assert_allclose(got, ref, atol=2e-5)
    naive = TL.sdpa(t(q), t(k), t(v),
                    TL.attention_scores_mask(t(pos), t(pos), win)).numpy()
    np.testing.assert_allclose(got, naive, atol=2e-5)
    kpos = pos.copy()
    kpos[:, Sq // 2:] = -1
    np.testing.assert_allclose(
        TL.flash_sdpa(t(q), t(k), t(v), t(pos), t(kpos), win,
                      q_block=32, k_block=48).numpy(),
        np.asarray(JL.flash_sdpa(q, k, v, pos, kpos, win, q_block=32,
                                 k_block=48)), atol=2e-5)


def test_swiglu_matches_reference():
    p = {n: rand(s, i) * 0.1 for i, (n, s) in enumerate(
        (("w_gate", (64, 128)), ("w_up", (64, 128)), ("w_down", (128, 64))))}
    x = rand((2, 5, 64), 10)
    got = TL.swiglu_apply(TL.Params(**{n: t(w) for n, w in p.items()}),
                          t(x)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(JL.swiglu_apply(p, x)),
                               atol=2e-5)


# -------------------------------------------------------------- model --- //

@pytest.mark.parametrize("arch_id", ALL)
def test_prefill_matches_reference(arch_id):
    rc, rp, tc, tp, toks = model(arch_id)
    want = np.asarray(JT.prefill(rc, rp, jnp.asarray(toks)))
    got = TT.prefill(tc, tp, t(toks)).numpy()
    assert got.shape == (B, S, rc.vocab)
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("arch_id", ALL)
def test_decode_matches_reference(arch_id):
    """Teacher-forced decode from an empty cache: the logits at every
    position and the cache leaves (danube's SWA ring of 16 slots wraps
    twice; deepseek's MLA latent, absorbed decode) equal the
    reference's."""
    rc, rp, tc, tp, toks = model(arch_id)
    step = jax.jit(functools.partial(JT.decode_step, rc))
    rcache = JT.init_cache(rc, B, S)
    tcache = TT.init_cache(tc, B, S, "cpu")
    for n, (shape, _) in TT.cache_spec(tc, B, S).items():
        assert tuple(rcache[n].shape) == shape == tuple(tcache[n].shape)
    for s in range(S):
        pos = np.full((B,), s, np.int32)
        rl, rcache = step(rp, rcache, toks[:, s], pos)
        tl, tcache = TT.decode_step(tc, tp, tcache, t(toks[:, s]), t(pos))
        np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4,
                                   err_msg=f"{arch_id} position {s}")
    got = convert.decode_cache_to_numpy(tcache)
    assert set(got) == set(rcache)
    for n in got:
        if n != "kpos":
            np.testing.assert_allclose(got[n], np.asarray(rcache[n]),
                                       atol=1e-4)
    np.testing.assert_array_equal(got["kpos"], np.asarray(rcache["kpos"]))


@pytest.mark.parametrize("arch_id, absorb", [(a, None) for a in ALL] + [
    ("deepseek-v2-236b", False)])
def test_decode_matches_prefill(arch_id, absorb):
    """Inside the port: teacher-forced decode logits == prefill logits
    position by position (the cache write and read, the SWA ring, MLA's
    latent cache in both decode forms; at the smoke configs no MoE pair
    drops at either T)."""
    _, _, tc, tp, toks = model(arch_id)
    if absorb is not None:
        tc = dataclasses.replace(tc, mla_absorb=absorb)
    full = TT.prefill(tc, tp, t(toks))
    cache = TT.init_cache(tc, B, S, "cpu")
    for s in range(S):
        lg, cache = TT.decode_step(tc, tp, cache, t(toks[:, s]),
                                   torch.full((B,), s, dtype=torch.int32))
        np.testing.assert_allclose(lg.numpy(), full[:, s].numpy(),
                                   atol=3e-4, err_msg=f"position {s}")


def test_gqa_expand_kv_equivalence():
    """Expanding K/V to H heads is a pure layout change: the same prefill
    and decode logits."""
    _, _, tc, tp, toks = model("qwen3-8b")
    te = dataclasses.replace(tc, gqa_expand_kv=True)
    np.testing.assert_allclose(TT.prefill(te, tp, t(toks)).numpy(),
                               TT.prefill(tc, tp, t(toks)).numpy(),
                               atol=1e-5)
    c1, c2 = TT.init_cache(tc, B, 8, "cpu"), TT.init_cache(te, B, 8, "cpu")
    for s in range(3):
        pos = torch.full((B,), s, dtype=torch.int32)
        o1, c1 = TT.decode_step(tc, tp, c1, t(toks[:, s]), pos)
        o2, c2 = TT.decode_step(te, tp, c2, t(toks[:, s]), pos)
        np.testing.assert_allclose(o1.numpy(), o2.numpy(), atol=1e-5)


@pytest.mark.parametrize("arch_id", ALL)
def test_param_count_matches_reference(arch_id):
    """At full width, counted on the meta device (nothing allocated); the
    active count too."""
    ours, ref = get_arch(arch_id).cfg, j_get_arch(arch_id).cfg
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()


def test_qwen3_full_width_param_count():
    assert get_arch("qwen3-8b").cfg.param_count() == 8_190_735_360


@pytest.mark.parametrize("arch_id, total, active, cut, at_cut", [
    ("mixtral-8x7b", 46_702_792_704, 12_879_925_248, 16, 23_482_470_400),
    ("deepseek-v2-236b", 235_741_434_880, 21_375_800_320, 8,
     29_191_377_920)])
def test_moe_full_width_param_counts(arch_id, total, active, cut, at_cut):
    """The published totals and active counts at full depth, and at the
    depth the card runs (deepseek's dense first layer kept)."""
    cfg = get_arch(arch_id).cfg
    assert (cfg.param_count(), cfg.active_param_count()) == (total, active)
    assert dataclasses.replace(cfg, n_layers=cut).param_count() == at_cut


# ------------------------------------------------ init, convert, configs //

@pytest.mark.parametrize("arch_id", ALL)
def test_init_tree_matches_reference_shapes(arch_id):
    """The port's seeded params, as the reference's tree: the same leaves,
    shapes and dtypes as ``jax.eval_shape(init)`` (deepseek's
    ``dense_layers`` a list); the same seed gives the same weights,
    another seed others; fp32 norms and router, the norms at one."""
    rc = j_get_arch(arch_id).smoke()
    tc = port_cfg(rc)
    want = jax.eval_shape(lambda k: JT.init(rc, k), jax.random.PRNGKey(0))
    p0 = TT.init(tc, 0, "cpu")
    tree = convert.transformer_params_to_numpy(tc, p0)
    assert (jax.tree.structure(jax.tree.map(lambda x: 0, tree))
            == jax.tree.structure(jax.tree.map(lambda x: 0, want)))
    for a, w in zip(jax.tree.leaves(tree), jax.tree.leaves(want)):
        assert a.shape == w.shape
    for name, p in p0.named_parameters():
        assert p.requires_grad                  # trainable, as the reference
        assert p.dtype == (torch.float32 if "norm" in name
                           or "router" in name else tc.dtype)
        if "norm" in name:
            assert torch.equal(p, torch.ones_like(p))
    again = TT.init(tc, 0, "cpu")
    other = TT.init(tc, 1, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(p0.parameters(),
                                                 again.parameters()))
    assert not torch.equal(p0["lm_head"], other["lm_head"])
    # fan-in init on the penultimate axis, as the reference's
    for leaf, fan_in in (("lm_head", tc.d_model), ("embed", None)):
        std = float(p0[leaf].std())
        assert abs(std - (0.02 if fan_in is None else fan_in ** -0.5)) \
            < 0.1 * std


@pytest.mark.parametrize("arch_id", ALL)
def test_params_round_trip_and_refusals(arch_id):
    """The reference's tree crosses and comes back with its structure
    (deepseek's ``dense_layers`` a list of unstacked layers) bit for bit;
    a wrong shape and an unknown leaf are refused by name."""
    rc, rp, tc, tp, _ = model(arch_id)
    tree = jax.tree.map(np.asarray, rp)
    back = convert.transformer_params_to_numpy(tc, tp)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    assert isinstance(back.get("dense_layers", []), list)
    assert len(back.get("dense_layers", [])) == rc.first_dense_layers
    bad = jax.tree.map(lambda x: x, tree)
    bad["layers"]["attn"]["wo"] = bad["layers"]["attn"]["wo"][:, :-1]
    with pytest.raises(ValueError, match="attn/wo"):
        convert.transformer_params_from_numpy(tc, bad, "cpu")
    extra = dict(tree, bias=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="bias"):
        convert.transformer_params_from_numpy(tc, extra, "cpu")
    if rc.first_dense_layers:
        bad = jax.tree.map(lambda x: x, tree)
        bad["dense_layers"][0]["ffn"]["w_up"] = np.zeros(3, np.float32)
        with pytest.raises(ValueError, match="dense_layers/0/ffn/w_up"):
            convert.transformer_params_from_numpy(tc, bad, "cpu")


def test_bf16_params_cross_as_float32():
    """A bf16 tree becomes bf16 weights (fp32 norms) and comes back
    widened to float32, bit for bit."""
    rc = dataclasses.replace(j_get_arch("qwen3-8b").smoke(),
                             dtype=jnp.bfloat16)
    tree = jax.tree.map(np.asarray, JT.init(rc, jax.random.PRNGKey(3)))
    tc = port_cfg(rc)
    assert tc.dtype == torch.bfloat16
    tp = convert.transformer_params_from_numpy(tc, tree, "cpu")
    assert tp["lm_head"].dtype == torch.bfloat16
    assert tp["final_norm"].dtype == torch.float32
    back = convert.transformer_params_to_numpy(tc, tp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b.astype(np.float32))


@pytest.mark.parametrize("arch_id", ("h2o-danube-3-4b", "deepseek-v2-236b"))
def test_cache_round_trip_and_refusals(arch_id):
    """The reference's cache (danube's SWA ring; deepseek's MLA latent
    over all layers, the dense first one included) crosses, comes back bit
    for bit and continues to the reference's logits."""
    rc, rp, tc, tp, toks = model(arch_id)
    step = jax.jit(functools.partial(JT.decode_step, rc))
    rcache = JT.init_cache(rc, B, S)
    for s in range(20):
        _, rcache = step(rp, rcache, toks[:, s], np.full((B,), s, np.int32))
    host = jax.tree.map(np.asarray, rcache)
    tcache = convert.decode_cache_from_numpy(tc, host, "cpu")
    lead = next(iter(tcache.values())).shape
    assert lead[0] == rc.n_layers
    assert lead[2] == (16 if rc.attention == "swa" else S)   # the ring
    back = convert.decode_cache_to_numpy(tcache)
    for n in host:
        np.testing.assert_array_equal(back[n], host[n])
    # the port continues the reference's cache to the reference's logits
    pos = np.full((B,), 20, np.int32)
    rl, _ = step(rp, rcache, toks[:, 20], pos)
    tl, _ = TT.decode_step(tc, tp, tcache, t(toks[:, 20]), t(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(rl), atol=1e-4)
    leaf = "ckv" if rc.use_mla else "k"
    with pytest.raises(ValueError, match=f"cache {leaf}"):
        convert.decode_cache_from_numpy(
            tc, dict(host, **{leaf: host[leaf][:, :, :, :1]}), "cpu")


def test_registry_matches_reference():
    """The five LM ids (among the reference's ten, all registered; the
    other five are held in test_torch_recsys_train.py), their full configs
    field for field, the smoke configs, the optimizer config and the
    accumulation factors (the train step itself is held in
    test_torch_train.py)."""
    ref_lm = [a for a in j_all_arch_ids() if j_get_arch(a).family == "lm"]
    assert all_arch_ids() == j_all_arch_ids()
    assert [a for a in all_arch_ids() if get_arch(a).family == "lm"] == \
        sorted(ref_lm)
    for a in ref_lm:
        for ours, theirs in ((get_arch(a).cfg, j_get_arch(a).cfg),
                             (get_arch(a).smoke(), j_get_arch(a).smoke())):
            assert ours == port_cfg(theirs), a
        assert ({n: (c.kind, c.dims, c.skip)
                 for n, c in get_arch(a).shapes.items()}
                == {n: (c.kind, c.dims, c.skip)
                    for n, c in j_get_arch(a).shapes.items()})
        assert get_arch(a).accum == j_get_arch(a).accum
        assert dataclasses.asdict(get_arch(a).opt_config()) == \
            dataclasses.asdict(j_get_arch(a).opt_config())
    assert callable(get_arch("qwen3-8b").step("train_4k"))
    with pytest.raises(KeyError):
        get_arch("no-such-arch")


@pytest.mark.parametrize("arch_id", ("qwen3-8b",) + MOE_MLA)
def test_registry_steps(arch_id):
    """The prefill and decode cells' steps at the smoke width (the train
    cell's is held in test_torch_train.py)."""
    _, _, tc, tp, toks = model(arch_id)
    arch = LMArch(arch_id, tc)                 # at the smoke width
    last = arch.step("prefill_32k")(tp, t(toks))
    np.testing.assert_array_equal(last.numpy(),
                                  TT.prefill(tc, tp, t(toks))[:, -1].numpy())
    cache = TT.init_cache(tc, B, 4, "cpu")
    pos = torch.zeros((B,), dtype=torch.int32)
    lg, _ = arch.step("decode_32k")(tp, cache, t(toks[:, 0]), pos)
    ref, _ = TT.decode_step(tc, tp, TT.init_cache(tc, B, 4, "cpu"),
                            t(toks[:, 0]), pos)
    np.testing.assert_array_equal(lg.numpy(), ref.numpy())


def test_config_crosses_whole():
    for a in DENSE + MOE_MLA:
        ref = j_get_arch(a).cfg
        ours = port_cfg(ref)
        for f in dataclasses.fields(ref):
            want = getattr(ref, f.name)
            got = getattr(ours, f.name)
            if f.name == "dtype":
                assert got == torch.bfloat16
            else:
                assert got == want, (a, f.name)
        assert (ours.hd, ours.sliding_window, ours.is_moe) == \
            (ref.hd, ref.sliding_window, ref.is_moe)
        assert tuple(ours.moe_cfg) == tuple(ref.moe_cfg)


def test_entry_points_run_on_the_card_unless_told(monkeypatch):
    """``cuda`` by default; without a card that is an error, never a CPU
    fallback."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_cfg(j_get_arch("qwen3-8b").smoke())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.init_cache(cfg, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert.transformer_params_from_numpy(
            cfg, convert.transformer_params_to_numpy(
                cfg, TT.init(cfg, 0, "cpu")))
