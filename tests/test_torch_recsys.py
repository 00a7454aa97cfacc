"""The port's recsys rankers (``repro_torch.models.recsys``: wide-deep,
xDeepFM, DLRM-RM2, DCN-v2) against the reference's on the CPU (their
registry steps, converters and data: ``test_torch_recsys_train.py``),
from one set of weights (the reference's seeded tree crossed through
``repro_torch.convert``), inputs made with numpy from a seed, in fp32. Tolerances, each relative to the
max |value| of what is compared: 1e-5 for logits, the weighted loss and
retrieval scores (fp32 sums in another order in each framework); 1e-4
for every gradient leaf; ``dedup_gather`` and the top-k order are
exact."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.models import recsys as JR
from repro_torch import convert
from repro_torch.configs import get_arch
from repro_torch.data import recsys_data as TD
from repro_torch.models import recsys as TR
from repro_torch.models.layers import rebuild_params, tensor_batch

REC = ("wide-deep", "xdeepfm", "dlrm-rm2", "dcn-v2")
B = 32


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_trees_close(got, want, tol, what=""):
    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k in want:
        assert rel_err(got[k], want[k]) <= tol, (what, k)


@functools.lru_cache(maxsize=None)
def model(arch_id, multi_hot=1):
    """(ref cfg, ref params, port cfg) of an arch's smoke config."""
    rc = dataclasses.replace(j_get_arch(arch_id).smoke(), multi_hot=multi_hot)
    rp = JR.init(rc, jax.random.PRNGKey(0))
    return rc, rp, TR.RecSysConfig(**dataclasses.asdict(rc))


def port_params(tc, rp):
    return convert.recsys_params_from_numpy(
        tc, jax.tree.map(np.asarray, rp), "cpu")


def ctr_batch(rc, n=B, seed=0):
    """A ``CTRStream`` batch of the smoke config (Zipf ids, with replays)."""
    s = TD.CTRStream(rc.n_dense, rc.vocab_sizes, multi_hot=rc.multi_hot,
                     dup_frac=0.25, seed=seed)
    s.batch(n)
    b = s.batch(n)
    return {k: b[k] for k in ("dense", "sparse_ids", "labels")}


def jb(batch):
    return jax.tree.map(jnp.asarray, batch)


@functools.lru_cache(maxsize=None)
def _j_fns(rc):
    fwd = jax.jit(lambda p, b: JR.forward(rc, p, b))
    vg = jax.jit(jax.value_and_grad(lambda p, b, w: JR.loss_fn(rc, p, b, w)))
    return fwd, vg


def port_grads(tc, params, loss) -> dict:
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    return convert.recsys_params_to_numpy(
        tc, rebuild_params(params, dict(zip(names, grads))))


# --------------------------------------------------------- the forward //

@pytest.mark.parametrize("multi_hot", (1, 3))
@pytest.mark.parametrize("arch_id", REC)
def test_forward_loss_and_grads_match_reference(arch_id, multi_hot):
    """Logits and the weighted BCE within 1e-5 (weights from the dedup
    stage: a record dropped, one halved), every gradient leaf
    within 1e-4 — the tables' (rows no id reads get exactly 0), the
    wide tower's, CIN's, the cross layers' — with one-hot and multi-hot
    (mean) bags."""
    rc, rp, tc = model(arch_id, multi_hot)
    batch = ctr_batch(rc)
    assert batch["sparse_ids"].ndim == (2 if multi_hot == 1 else 3)
    params = port_params(tc, rp)
    fwd, vg = _j_fns(rc)
    got = TR.forward(tc, params, tensor_batch(batch, "cpu"))
    assert got.shape == (B,) and got.dtype == torch.float32
    assert rel_err(got.detach(), fwd(rp, jb(batch))) <= 1e-5
    w = np.ones(B, np.float32)
    w[0], w[3] = 0.0, 0.5
    want_l, want_g = vg(rp, jb(batch), jnp.asarray(w))
    loss = TR.loss_fn(tc, params, tensor_batch(batch, "cpu"),
                      torch.from_numpy(w))
    assert loss.dtype == torch.float32
    assert abs(loss.item() - float(want_l)) <= 1e-5 * abs(float(want_l))
    got_g = port_grads(tc, params, loss)
    assert_trees_close(got_g, jax.tree.map(np.asarray, want_g), 1e-4, arch_id)
    untouched = np.setdiff1d(np.arange(rc.vocab_sizes[0]),
                             batch["sparse_ids"][:, 0])
    assert (got_g["tables"]["table_0"][untouched] == 0).all()


def test_weighted_loss_edges():
    """All-zero weights give a loss of 0 (the denominator is max(sum w,
    1)); weights of ones equal None."""
    rc, rp, tc = model("dlrm-rm2")
    batch = tensor_batch(ctr_batch(rc), "cpu")
    params = port_params(tc, rp)
    assert TR.loss_fn(tc, params, batch, torch.zeros(B)).item() == 0.0
    assert TR.loss_fn(tc, params, batch, torch.ones(B)).item() == \
        TR.loss_fn(tc, params, batch).item()


@pytest.mark.parametrize("arch_id", REC)
def test_dedup_gather_equals_plain_gather(arch_id):
    """``dedup_gather=True`` (``unique_gather`` ahead of each table's
    gather) gives the plain gather's logits exactly, and the reference's;
    so do its gradients (the reference's own
    ``test_recsys_dedup_gather_equivalence``, for every arch)."""
    rc, rp, tc = model(arch_id, 2)
    batch = tensor_batch(ctr_batch(rc), "cpu")
    params = port_params(tc, rp)
    tc2 = dataclasses.replace(tc, dedup_gather=True)
    a = TR.loss_fn(tc, params, batch)
    b = TR.loss_fn(tc2, params, batch)
    assert a.item() == b.item()
    assert_trees_close(port_grads(tc2, params, b), port_grads(tc, params, a),
                       0.0)
    rc2 = dataclasses.replace(rc, dedup_gather=True)
    want = JR.forward(rc2, rp, jb({k: v.numpy() for k, v in batch.items()}))
    assert rel_err(TR.forward(tc2, params, batch).detach(), want) <= 1e-5


def test_the_reference_dedup_gather_case_on_the_port():
    common = dict(n_dense=4, n_sparse=6, embed_dim=8,
                  vocab_sizes=tuple([100] * 6), mlp_dims=(32, 16))
    rc = JR.RecSysConfig(name="wd", interaction="concat", **common)
    tc = TR.RecSysConfig(**dataclasses.asdict(rc))
    rp = JR.init(rc, jax.random.PRNGKey(0))
    params = port_params(tc, rp)
    r = np.random.default_rng(0)
    batch = {"dense": r.normal(size=(32, 4)).astype(np.float32),
             "sparse_ids": r.integers(0, 100, (32, 6)).astype(np.int32)}
    a = TR.forward(tc, params, tensor_batch(batch, "cpu")).detach()
    b = TR.forward(dataclasses.replace(tc, dedup_gather=True), params,
                   tensor_batch(batch, "cpu")).detach()
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    assert rel_err(a, JR.forward(rc, rp, jb(batch))) <= 1e-5


def test_wide_crosses_near_2_31_and_out_of_range_ids():
    """The wide tower's uint32 crosses in int64: ids up to 2^31 - 1 (the
    product wraps mod 2^32 in the reference) give the reference's hashed
    rows; and ids outside a table's rows read it as a jnp gather does
    (negative from the end, then clamped), on every arch."""
    rc, rp, tc = model("wide-deep")
    r = np.random.default_rng(5)
    ids = r.integers(0, 1000, (8, rc.n_sparse)).astype(np.int64)
    ids[0] = 2**31 - 1
    ids[1, ::2] = 2**31 - 2
    ids[2] = np.arange(rc.n_sparse) + 2**31 - 1 - rc.n_sparse
    ids32 = ids.astype(np.int32)
    want = (ids32[:, :-1].astype(np.uint32) * np.uint32(0x9E3779B9)) ^ \
        ids32[:, 1:].astype(np.uint32)
    want = (want & np.uint32((1 << 20) - 1)).astype(np.int64)
    got = TR.wide_crosses(torch.from_numpy(ids32))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # negative ids (not emitted by CTRStream) cross as their uint32
    neg = -torch.arange(1, 2 * rc.n_sparse + 1, dtype=torch.int32).reshape(
        2, rc.n_sparse)
    want = (neg.numpy()[:, :-1].astype(np.uint32) * np.uint32(0x9E3779B9)) \
        ^ neg.numpy()[:, 1:].astype(np.uint32)
    np.testing.assert_array_equal(TR.wide_crosses(neg).numpy(),
                                  want & ((1 << 20) - 1))
    for arch_id in REC:
        rc, rp, tc = model(arch_id)
        batch = ctr_batch(rc, 8)
        batch["sparse_ids"] = ids32[:, :rc.n_sparse].copy()
        batch["sparse_ids"][3, :4] = [-1, -2, -5000, 1000]
        want = JR.forward(rc, rp, jb(batch))
        got = TR.forward(tc, port_params(tc, rp), tensor_batch(batch, "cpu"))
        assert rel_err(got.detach(), want) <= 1e-5, arch_id


def test_dot_interaction_lower_triangle_order():
    """DLRM's pairs in ``jnp.tril_indices(n, k=-1)``'s row-major order."""
    for n in (2, 4, 27):
        ii, jj = torch.tril_indices(n, n, offset=-1)
        ji, jj_ = np.tril_indices(n, k=-1)
        wi, wj = jnp.tril_indices(n, k=-1)
        np.testing.assert_array_equal(ii.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(jj.numpy(), np.asarray(wj))
        np.testing.assert_array_equal(ji, np.asarray(wi))
    r = np.random.default_rng(0)
    emb = r.standard_normal((3, 5, 4)).astype(np.float32)
    bot = r.standard_normal((3, 4)).astype(np.float32)
    want = JR._dot_interaction(jnp.asarray(emb), jnp.asarray(bot))
    got = TR._dot_interaction(torch.from_numpy(emb), torch.from_numpy(bot))
    assert got.shape == (3, 15) and rel_err(got, want) <= 1e-6


# ------------------------------------------------------------ retrieval //

@pytest.mark.parametrize("arch_id", REC)
def test_retrieval_scores_match_reference(arch_id):
    rc, rp, tc = model(arch_id)
    r = np.random.default_rng(0)
    batch = {"dense": r.normal(size=(1, rc.n_dense)).astype(np.float32),
             "sparse_ids": r.integers(0, 1000, (1, rc.n_sparse)
                                      ).astype(np.int32),
             "candidates": TD.candidates_matrix(5000, rc.embed_dim, seed=1)}
    ws, wts, wti = JR.retrieval_scores(rc, rp, jb(batch))
    step = get_arch(arch_id).step("retrieval_cand")
    s, ts, ti = step(port_params(tc, rp), tensor_batch(batch, "cpu"))
    assert s.shape == (5000,) and ts.shape == ti.shape == (100,)
    assert rel_err(s, ws) <= 1e-5 and rel_err(ts, wts) <= 1e-5
    np.testing.assert_array_equal(ti.numpy(), np.asarray(wti))
    assert float(ts[0]) == float(s.max())


def test_top_k_orders_ties_by_the_lower_index():
    """``jax.lax.top_k``'s order: descending score, and among equal
    scores the lower index first — planted ties across the cut-off, both
    signs and both zeros; a stable descending sort agrees."""
    r = np.random.default_rng(3)
    scores = r.standard_normal(4000).astype(np.float32)
    scores[[5, 900, 77, 3999, 1200]] = 3.5            # a tie at the top
    scores[r.choice(4000, 300, replace=False)] = 0.25  # a tie at the cut
    scores[[10, 11]] = -0.0
    scores[[12]] = 0.0
    scores[r.choice(4000, 50, replace=False)] = -1.5
    for k in (1, 7, 100, 400):
        wv, wi = jax.lax.top_k(jnp.asarray(scores), k)
        tv, ti = TR.top_k(torch.from_numpy(scores), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(wv))
        order = torch.sort(torch.from_numpy(scores), descending=True,
                           stable=True).indices[:k]
        np.testing.assert_array_equal(ti.numpy(), order.numpy())
    neg = -np.abs(scores) - 1.0
    wv, wi = jax.lax.top_k(jnp.asarray(neg), 50)
    np.testing.assert_array_equal(TR.top_k(torch.from_numpy(neg), 50)[1],
                                  np.asarray(wi))
