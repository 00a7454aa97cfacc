"""The port's recsys registry steps (``RecsysArch``), the ten arch ids
and 40 cells, the recsys converters and data modules against the
reference's on the CPU (the models themselves: ``test_torch_recsys.py``),
in fp32. Tolerances, each relative to the max |value| of what is
compared: 1e-5 for the loss and logits, 1e-4 for the grad norm, m and v
after AdamW steps; params within 1e-4 of their max |value| plus 1e-2 x
the step's lr (where a gradient is near AdamW's eps, 1e-8, the update
g / (|g| + eps) turns on the gradient's last digits, so a leaf still near
its zero init, a bias, is compared in units of the lr); the converters
and data modules exactly."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import all_arch_ids as j_all_arch_ids
from repro.configs import all_cells as j_all_cells
from repro.configs import get_arch as j_get_arch
from repro.data import recsys_data as JD
from repro.models import recsys as JR
from repro.optim import init_opt_state as j_init_opt
from repro_torch import convert
from repro_torch.configs import all_arch_ids, all_cells, get_arch
from repro_torch.data import recsys_data as TD
from repro_torch.models import recsys as TR
from repro_torch.models.layers import module_leaves, tensor_batch
from repro_torch.optim import init_opt_state
from test_torch_recsys import (B, REC, assert_trees_close, ctr_batch, flat,
                               jb, model, port_params, rel_err)


# ------------------------------------------------------ the train step -- //

@pytest.mark.parametrize("arch_id", REC)
def test_recsys_arch_train_step_matches_reference(arch_id):
    """``RecsysArch.step("train_batch")`` (value and grad, then AdamW
    with weight_decay 0): two steps against the reference's, one record
    weighted 0 by the dedup stage: loss, grad_norm, params, m and v; and
    serve_p99's infer step records no graph."""
    rc, rp, tc = model(arch_id)
    jarch, tarch = j_get_arch(arch_id), get_arch(arch_id)
    jarch, tarch = type(jarch)(arch_id, rc), type(tarch)(arch_id, tc)
    jstep = jax.jit(jarch.step("train_batch"))
    tstep = tarch.step("train_batch")
    jp, tp = rp, port_params(tc, rp)
    js = j_init_opt(jarch.opt_config(), jp)
    ts = init_opt_state(tarch.opt_config(), tp)
    for i in range(2):
        batch = ctr_batch(rc, B, seed=7 + i)
        w = np.ones(B, np.float32)
        w[i] = 0.0
        jp, js, jm = jstep(jp, js, jb(batch), jnp.asarray(w))
        tp, ts, tm = tstep(tp, ts, tensor_batch(batch, "cpu"),
                           torch.from_numpy(w))
        assert abs(float(tm["loss"]) - float(jm["loss"])) <= \
            1e-5 * abs(float(jm["loss"])), i
        assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) <= \
            1e-4 * float(jm["grad_norm"]), i
        got = flat(convert.recsys_params_to_numpy(tc, tp))
        for k, want in flat(jp).items():
            tol = 1e-4 * np.abs(want).max() + 1e-2 * float(jm["lr"])
            assert np.abs(got[k] - want).max() <= tol, ("params", k, i)
        for got, want in ((ts.m, js.m), (ts.v, js.v)):
            assert_trees_close(jax.tree.map(lambda x: x.numpy(), got), want,
                               1e-4, ("moments", i))
    out = tarch.step("serve_p99")(tp, tensor_batch(batch, "cpu"))
    assert out.shape == (B,) and not out.requires_grad
    assert rel_err(out, jax.jit(jarch.step("serve_p99"))(jp, jb(batch))) \
        <= 1e-5


# ----------------------------------------------------- registry, convert //

def test_the_ten_archs_and_forty_cells():
    """The reference's ten ids and its 40 (arch, shape, skip) triples,
    and each cell's dims."""
    assert all_arch_ids() == j_all_arch_ids() and len(all_arch_ids()) == 10
    assert all_cells() == j_all_cells() and len(all_cells()) == 40
    for aid in all_arch_ids():
        j, t = j_get_arch(aid), get_arch(aid)
        assert t.family == j.family
        assert {k: (c.kind, c.dims, c.skip) for k, c in t.shapes.items()} \
            == {k: (c.kind, c.dims, c.skip) for k, c in j.shapes.items()}
        assert t.opt_config() == type(t.opt_config())(
            **dataclasses.asdict(j.opt_config()))
        if t.family == "recsys":
            cfg = dict(dataclasses.asdict(t.cfg), dtype=None)
            assert cfg == dict(dataclasses.asdict(j.cfg), dtype=None)
            assert t.smoke() == TR.RecSysConfig(**dataclasses.asdict(
                j.smoke()))
    g, jg = get_arch("meshgraphnet"), j_get_arch("meshgraphnet")
    assert dataclasses.asdict(g.smoke()) == dict(
        dataclasses.asdict(jg.smoke()), dtype=torch.float32)
    for shape in g.shapes:
        assert g.cfg_for(shape).d_node_in == jg.cfg_for(shape).d_node_in
        assert g.padded(shape) == (jg._pad4k(jg.shapes[shape].dims[
            "n_nodes"]), jg._pad4k(jg.shapes[shape].dims["n_edges"]))
    assert g.padded("minibatch_lg") == (172032, 172032)


@pytest.mark.parametrize("arch_id", REC)
def test_converter_round_trip_and_meta_counts(arch_id):
    """The reference's tree (``tables``, the MLP lists, ``cin``,
    ``cross``) crosses both ways exactly in its leaf order; a missing
    table is refused; the published config's parameter count, from the
    meta device, is the reference's."""
    rc, rp, tc = model(arch_id)
    tree = jax.tree.map(np.asarray, rp)
    params = port_params(tc, rp)
    back = convert.recsys_params_to_numpy(tc, params)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    assert_trees_close(back, tree, 0.0)
    assert [lf.path for lf in module_leaves(params)] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]
    bad = dict(tree, tables=dict(tree["tables"]))
    del bad["tables"]["table_1"]
    with pytest.raises(ValueError, match="missing"):
        convert.recsys_params_from_numpy(tc, bad, "cpu")
    full = get_arch(arch_id).cfg
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(
        j_get_arch(arch_id).params_shape()))
    assert sum(p.numel() for p in TR._build(
        full, None, torch.device("meta")).parameters()) == want
    own = convert.recsys_params_to_numpy(tc, TR.init(tc, 0, "cpu"))
    assert {k: v.shape for k, v in flat(own).items()} == {
        k: v.shape for k, v in flat(tree).items()}


def test_data_modules_equal_the_reference():
    """``CTRStream`` (one-hot and multi-hot, replays across batches) and
    ``candidates_matrix`` give the reference's arrays bit for bit, and
    ``default_vocab_sizes`` its tables."""
    for kw in (dict(), dict(multi_hot=3, zipf_a=1.1, dup_frac=0.5)):
        ts = TD.CTRStream(5, [100, 7, 3000], seed=4, **kw)
        js = JD.CTRStream(5, [100, 7, 3000], seed=4, **kw)
        for n in (64, 64, 17, 64):
            a, b = ts.batch(n), js.batch(n)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k])
    np.testing.assert_array_equal(TD.candidates_matrix(300, 16, seed=2),
                                  JD.candidates_matrix(300, 16, seed=2))
    for n in (26, 39, 40):
        assert TR.default_vocab_sizes(n) == JR.default_vocab_sizes(n)
