"""The port's MeshGraphNet (``repro_torch.models.gnn``), its layers and
its registry step against the reference's on the CPU, from one set of
weights (the reference's seeded tree crossed through
``repro_torch.convert``), graphs made with the data modules from a seed,
in fp32. Tolerances, each relative to the max |value| of what is
compared: 1e-5 for predictions and the loss (fp32 matmuls and the
scatter-sum reduce in another order in each framework); 1e-4 for every
gradient leaf and for params, m and v after AdamW steps; remat is held
bit for bit against none."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.data import graphs as JD
from repro.models import gnn as JG
from repro.models import layers as JL
from repro.optim import init_opt_state as j_init_opt
from repro_torch import convert
from repro_torch.configs import get_arch, pad_graph
from repro_torch.data import graphs as TD
from repro_torch.models import gnn as TG
from repro_torch.models import layers as TL
from repro_torch.models.layers import rebuild_params, tensor_batch
from repro_torch.optim import init_opt_state


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
def model(remat="none", d_node_in=16):
    """(ref cfg, ref params, port cfg) of MeshGraphNet's smoke config."""
    rc = dataclasses.replace(j_get_arch("meshgraphnet").smoke(), remat=remat,
                             d_node_in=d_node_in)
    rp = JG.init(rc, jax.random.PRNGKey(0))
    return rc, rp, TG.GNNConfig(**dataclasses.asdict(rc))


def port_params(tc, rp):
    return convert.gnn_params_from_numpy(tc, jax.tree.map(np.asarray, rp),
                                         "cpu")


def sampler_batch(seed=1):
    g = TD.random_graph(n_nodes=300, n_edges=3000, d_feat=16, seed=0)
    csr = TD.CSRGraph.from_edges(300, g["src"], g["dst"], g["nodes"],
                                 g["targets"])
    return TD.NeighborSampler(csr, (5, 3), batch_nodes=8, seed=seed).sample()


GRAPHS = {
    "random_graph": lambda: TD.random_graph(40, 120, 16, seed=3),
    "molecule_batch": lambda: TD.molecule_batch(6, 7, 9, 16, seed=4),
    "neighbor_sample": sampler_batch,
}


def ref_loss_and_grads(rc, rp, batch, weights=None):
    jb = jax.tree.map(jnp.asarray, batch)
    jw = None if weights is None else jnp.asarray(weights)
    loss, g = jax.jit(jax.value_and_grad(
        lambda p, b, w: JG.loss_fn(rc, p, b, w)))(rp, jb, jw)
    return float(loss), jax.tree.map(np.asarray, g)


def ref_forward(rc, rp, batch):
    return jax.jit(lambda p, b: JG.forward(rc, p, b))(
        rp, jax.tree.map(jnp.asarray, batch))


def port_loss_and_grads(tc, params, batch, weights=None):
    tb = tensor_batch(batch, "cpu")
    tw = None if weights is None else torch.from_numpy(weights)
    loss = TG.loss_fn(tc, params, tb, tw)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, list(params.parameters()))
    tree = convert.gnn_params_to_numpy(tc, rebuild_params(
        params, dict(zip(names, grads))))
    return loss, tree


# ----------------------------------------------------------- the layers //

def test_layernorm_and_mlp_match_reference():
    r = np.random.default_rng(0)
    x = (r.standard_normal((5, 7, 12)) * 3 + 1).astype(np.float32)
    scale = r.standard_normal(12).astype(np.float32)
    bias = r.standard_normal(12).astype(np.float32)
    want = JL.layernorm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = TL.layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                       torch.from_numpy(bias))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5
    # bf16 in, fp32 inside, bf16 out
    got = TL.layernorm(torch.from_numpy(x).bfloat16(),
                       torch.from_numpy(scale), torch.from_numpy(bias))
    want = JL.layernorm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(scale),
                        jnp.asarray(bias))
    assert got.dtype == torch.bfloat16
    assert rel_err(got.float(), np.asarray(want, np.float32)) <= 1e-2
    # an MLP of the reference's list of {"w", "b"} dicts
    layers = JL.mlp_init(jax.random.PRNGKey(0), [12, 16, 8, 3], jnp.float32)
    tl = TL.mlp_init(torch.Generator().manual_seed(0), [12, 16, 8, 3],
                     torch.float32)
    assert [sorted(p) for p in layers] == [sorted(dict(p.named_parameters()))
                                           for p in tl]
    with torch.no_grad():
        for p, q in zip(tl, layers):
            p["w"].copy_(torch.from_numpy(np.array(q["w"])))
            p["b"].copy_(torch.from_numpy(np.array(q["b"]) + 0.1))
            q["b"] = q["b"] + 0.1
    for final_act in (False, True):
        want = JL.mlp_apply(layers, jnp.asarray(x), final_act=final_act)
        got = TL.mlp_apply(tl, torch.from_numpy(x), final_act=final_act)
        assert rel_err(got.detach(), want) <= 1e-5
    assert (TL.mlp_apply(tl, torch.from_numpy(x), final_act=True) >= 0).all()
    # init helpers: shapes, dtypes and the fan-in draw's scale
    assert TL.zeros_init(None, (3, 2), torch.float32, "cpu").eq(0).all()
    assert TL.ones_init(None, (4,), torch.bfloat16, "cpu").eq(1).all()
    assert TL.ones_init(None, (4,), torch.float32, "meta").is_meta
    assert TL.zeros_init(torch.Generator(), (2,), torch.float32).device == \
        torch.device("cpu")
    assert not any(hasattr(p, "b") for p in TL.mlp_init(
        torch.Generator(), [4, 4], torch.float32, bias=False))


# --------------------------------------------------------- the forward //

@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_forward_loss_and_grads_match_reference(graph):
    """Predictions and loss within 1e-5, every gradient leaf within 1e-4,
    on each of the data modules' graphs (the sampler's padded subgraph
    with its masked-off edges and loss only on the seeds); node weights
    from the dedup stage, one node dropped."""
    rc, rp, tc = model()
    batch = GRAPHS[graph]()
    params = port_params(tc, rp)
    want = ref_forward(rc, rp, batch)
    got = TG.forward(tc, params, tensor_batch(batch, "cpu"))
    assert got.shape == (batch["nodes"].shape[0], rc.d_out)
    assert rel_err(got.detach(), want) <= 1e-5
    weights = np.ones(batch["nodes"].shape[0], np.float32)
    weights[1] = 0.0
    for w in (None, weights):
        want_l, want_g = ref_loss_and_grads(rc, rp, batch, w)
        loss, got_g = port_loss_and_grads(tc, params, batch, w)
        assert loss.dtype == torch.float32
        assert abs(loss.item() - want_l) <= 1e-5 * abs(want_l)
        assert_trees_close(got_g, want_g, 1e-4, graph)


def test_segment_aggregation_and_masked_edges_as_reference():
    """The reference's ``test_gnn_segment_aggregation_correct`` on the
    port: 1 layer, d 8, a fifth of the edges masked; masked edges carry
    no message, so changing their features changes nothing; and the port
    equals the reference."""
    rc = JG.GNNConfig(n_layers=1, d_hidden=8, d_node_in=4, d_edge_in=4,
                      d_out=2, mlp_layers=1)
    tc = TG.GNNConfig(**dataclasses.asdict(rc))
    rp = JG.init(rc, jax.random.PRNGKey(0))
    params = port_params(tc, rp)
    N, E = 6, 10
    r = np.random.default_rng(0)
    batch = {
        "nodes": r.normal(size=(N, 4)).astype(np.float32),
        "edges": r.normal(size=(E, 4)).astype(np.float32),
        "src": r.integers(0, N, E).astype(np.int32),
        "dst": r.integers(0, N, E).astype(np.int32),
        "edge_mask": r.random(E) < 0.8,
        "node_mask": np.ones(N, bool),
        "targets": np.zeros((N, 2), np.float32),
    }
    assert not batch["edge_mask"].all()
    out = TG.forward(tc, params, tensor_batch(batch, "cpu")).detach()
    assert out.shape == (N, 2) and torch.isfinite(out).all()
    want = ref_forward(rc, rp, batch)
    assert rel_err(out, want) <= 1e-5
    batch2 = dict(batch)
    batch2["edges"] = np.where(batch["edge_mask"][:, None], batch["edges"],
                               np.float32(999.0))
    out2 = TG.forward(tc, params, tensor_batch(batch2, "cpu")).detach()
    np.testing.assert_allclose(out2.numpy(), out.numpy(), atol=1e-5)


def test_padding_to_4k_changes_nothing():
    """``pad_graph`` to the registry's ``_pad4k`` widths adds masked-off
    nodes and edges: the real nodes' predictions and the loss are those of
    the unpadded graph."""
    rc, rp, tc = model()
    batch = GRAPHS["molecule_batch"]()
    arch = get_arch("meshgraphnet")
    n, e = (arch._pad4k(batch["nodes"].shape[0]),
            arch._pad4k(batch["src"].shape[0]))
    assert (n, e) == (4096, 4096)
    padded = pad_graph(batch, n, e)
    assert padded["node_mask"].sum() == batch["node_mask"].sum()
    assert padded["edge_mask"].sum() == batch["edge_mask"].sum()
    params = port_params(tc, rp)
    a = TG.forward(tc, params, tensor_batch(batch, "cpu")).detach()
    b = TG.forward(tc, params, tensor_batch(padded, "cpu")).detach()
    np.testing.assert_allclose(b[:a.shape[0]].numpy(), a.numpy(), atol=1e-5)
    la = TG.loss_fn(tc, params, tensor_batch(batch, "cpu"))
    lb = TG.loss_fn(tc, params, tensor_batch(padded, "cpu"))
    assert abs(la.item() - lb.item()) <= 1e-5 * la.item()
    with pytest.raises(ValueError, match="does not pad"):
        pad_graph(padded, n - 1, e)


def test_out_of_range_ids_follow_the_reference():
    """Ids outside [0, N) as the reference treats them, on the device
    with no host check: the gathers clamp (a negative index counts from
    the end first) and the scatter-sum drops the message (segment_sum)."""
    rc, rp, tc = model()
    batch = dict(GRAPHS["random_graph"]())
    N = batch["nodes"].shape[0]
    batch["src"] = batch["src"].copy()
    batch["dst"] = batch["dst"].copy()
    batch["src"][:4] = [N, N + 7, -1, -N - 3]
    batch["dst"][4:8] = [N, N + 2, -1, -N - 5]
    want = ref_forward(rc, rp, batch)
    got = TG.forward(tc, port_params(tc, rp), tensor_batch(batch, "cpu"))
    assert rel_err(got.detach(), want) <= 1e-5
    x = torch.arange(5)
    assert TG.gather_rows(x, torch.tensor([7, -1, -9, 2])).tolist() == [
        4, 4, 0, 2]


def test_remat_full_equals_none_bit_for_bit():
    """Recomputing each block in the backward pass changes nothing: the
    loss and every gradient equal remat="none"'s exactly; and remat
    "full" is the published config's."""
    assert get_arch("meshgraphnet").base_cfg.remat == "full"
    batch = GRAPHS["neighbor_sample"]()
    out = {}
    for mode in ("none", "full"):
        rc, rp, tc = model(mode)
        params = port_params(tc, rp)
        loss = TG.loss_fn(tc, params, tensor_batch(batch, "cpu"))
        out[mode] = [loss.detach()] + list(torch.autograd.grad(
            loss, list(params.parameters())))
    for a, b in zip(out["none"], out["full"]):
        assert torch.equal(a, b)


# ------------------------------------------------------ the train step -- //

@pytest.mark.parametrize("shape", ("full_graph_sm", "molecule"))
def test_gnn_arch_train_step_matches_reference(shape):
    """``GNNArch.step`` (value and grad, then AdamW with weight_decay 0)
    for two steps against the reference's at the smoke width with the
    cell's node feature width: loss, grad_norm, params, m and v."""
    jarch, tarch = j_get_arch("meshgraphnet"), get_arch("meshgraphnet")
    d_feat = tarch.shapes[shape].dims["d_feat"]
    rc, rp, tc = model("full", d_feat)
    jstep = jax.jit(type(jarch)(jarch.arch_id, rc).step(shape))
    tstep = type(tarch)(tarch.arch_id, tc).step(shape)
    jp, tp = rp, port_params(tc, rp)
    js = j_init_opt(jarch.opt_config(), jp)
    ts = init_opt_state(tarch.opt_config(), tp)
    for i in range(2):
        batch = TD.random_graph(30, 90, d_feat, seed=10 + i)
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        tp, ts, tm = tstep(tp, ts, tensor_batch(batch, "cpu"))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"])), i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"]), i
        assert_trees_close(convert.gnn_params_to_numpy(tc, tp), jp, 1e-4,
                           ("params", i))
        for got, want in ((ts.m, js.m), (ts.v, js.v)):
            assert_trees_close(jax.tree.map(lambda x: x.numpy(), got), want,
                               1e-4, ("moments", i))


# --------------------------------------------------------- the converter //

def test_converter_round_trip_and_refusals():
    """The reference's tree — ``blocks`` stacked on n_layers, each MLP's
    ``ws`` / ``bs`` lists — crosses both ways exactly, in the reference's
    leaf order; a missing leaf, an unknown one or a wrong shape is
    refused."""
    rc, rp, tc = model()
    tree = jax.tree.map(np.asarray, rp)
    params = port_params(tc, rp)
    back = convert.gnn_params_to_numpy(tc, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for k, v in flat(tree).items():
        assert flat(back)[k].dtype == v.dtype
        np.testing.assert_array_equal(flat(back)[k], v)
    assert back["blocks"]["edge"]["ws"][0].shape == (3, 96, 32)
    assert back["dec"]["ln_scale"].shape == (3,)
    assert [lf.path for lf in TL.module_leaves(params)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    bad = jax.tree.map(lambda x: x, tree)
    del bad["dec"]["ln_bias"]
    with pytest.raises(ValueError, match="missing"):
        convert.gnn_params_from_numpy(tc, bad, "cpu")
    bad = jax.tree.map(lambda x: x, tree)
    bad["blocks"]["node"]["ws"][1] = bad["blocks"]["node"]["ws"][1][:2]
    with pytest.raises(ValueError, match="shape"):
        convert.gnn_params_from_numpy(tc, bad, "cpu")
    # the port's own init: the reference's shapes and the meta device
    own = TG.init(tc, 0, "cpu")
    assert {k: v.shape for k, v in flat(
        convert.gnn_params_to_numpy(tc, own)).items()} == {
        k: v.shape for k, v in flat(tree).items()}
    lg = get_arch("meshgraphnet").params("minibatch_lg", 0, "cpu")
    assert lg["enc_node"]["ws"][0].shape == (602, 128) and len(
        lg["blocks"]) == 15
    with pytest.raises(RuntimeError, match="CUDA"):
        if not torch.cuda.is_available():
            TG.init(tc)
        else:
            raise RuntimeError("CUDA present")


def test_opt_state_crosses_for_the_gnn_tree():
    rc, rp, tc = model()
    jstate = j_init_opt(j_get_arch("meshgraphnet").opt_config(), rp)
    r = np.random.default_rng(0)
    jstate = jstate._replace(
        m=jax.tree.map(lambda x: r.standard_normal(x.shape).astype(
            np.float32), jstate.m))
    state = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                         "cpu")
    back = convert.opt_state_to_numpy(state)
    assert_trees_close(back.m, jstate.m, 0.0)
    ts = init_opt_state(get_arch("meshgraphnet").opt_config(),
                        port_params(tc, rp))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, ts.m)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jstate.m))


def test_data_modules_equal_the_reference():
    """``random_graph``, ``molecule_batch``, ``CSRGraph.from_edges`` and
    ``NeighborSampler.sample`` (three draws of one sampler) give the
    reference's arrays bit for bit."""
    def same(a, b):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k

    same(TD.random_graph(50, 300, 7, seed=5),
         JD.random_graph(50, 300, 7, seed=5))
    same(TD.molecule_batch(4, 5, 6, 3, seed=2),
         JD.molecule_batch(4, 5, 6, 3, seed=2))
    g = JD.random_graph(500, 4000, 8, seed=0)
    tcsr = TD.CSRGraph.from_edges(500, g["src"], g["dst"], g["nodes"],
                                  g["targets"])
    jcsr = JD.CSRGraph.from_edges(500, g["src"], g["dst"], g["nodes"],
                                  g["targets"])
    same(dataclasses.asdict(tcsr), dataclasses.asdict(jcsr))
    ts = TD.NeighborSampler(tcsr, (5, 3), 16, seed=1)
    js = JD.NeighborSampler(jcsr, (5, 3), 16, seed=1)
    assert (ts.max_nodes, ts.max_edges) == (js.max_nodes, js.max_edges) \
        == (16 * 21, 16 * 20)
    for _ in range(3):
        same(ts.sample(), js.sample())
