"""The port's partition specs (``repro_torch.distributed.sharding`` and the
registry's mesh methods) held against the reference's, entry for entry,
on both production meshes: every parameter leaf's spec and its per-device
shard shape, every ZeRO-1 moment spec, and every cell's input shapes,
batch specs and decode-cache specs. The reference plans on a
``jax.sharding.AbstractMesh`` (no devices); the port on a ``MeshAxes``
record of the same names and sizes."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding
from jax.sharding import PartitionSpec as JP

from repro import configs as ref_configs
from repro.models import transformer as ref_tfm
from repro.optim.optimizers import OptState
from repro_torch import configs
from repro_torch.distributed import sharding as shr
from repro_torch.launch.mesh import production_axes
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import module_leaves

MESHES = {"single": False, "multi": True}
ARCHS = configs.all_arch_ids()


def _norm(entry):
    """A one-name tuple and the name are the same split (jax normalises
    the first to the second in newer versions)."""
    if isinstance(entry, tuple):
        return entry[0] if len(entry) == 1 else (entry or None)
    return entry


def _spec(p) -> tuple:
    return tuple(_norm(e) for e in p)


def _ref_flat(tree) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (JP, jax.ShapeDtypeStruct)))[0]
    return {tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path):
            leaf for path, leaf in leaves}


def _port_flat(tree, path=()) -> dict:
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _port_flat(tree[key], path + (key,)).items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree)
                for k, v in _port_flat(t, path + (i,)).items()}
    return {path: tree}


def _meshes(multi):
    ax = production_axes(multi)
    ref = AbstractMesh(tuple(ax.shape[a] for a in ax.axis_names),
                       ax.axis_names)
    return ref, ax


def _ref_specs(ref_arch, ref_mesh, shape):
    if ref_arch.family == "gnn":
        return ref_arch.param_specs(ref_mesh, shape)
    return ref_arch.param_specs(ref_mesh)


def _shapes(arch, ref_arch, shape):
    if arch.family == "gnn":
        return arch.params_shape(shape), ref_arch.params_shape(shape)
    return arch.params_shape(), ref_arch.params_shape()


@pytest.mark.parametrize("multi", MESHES.values(), ids=MESHES.keys())
@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_and_zero_specs_match_reference(arch_id, multi):
    ref_mesh, mesh = _meshes(multi)
    arch, ref_arch = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    shape = "full_graph_sm"
    pshape, ref_pshape = _shapes(arch, ref_arch, shape)
    got = _port_flat(arch.param_specs(mesh, shape) if arch.family == "gnn"
                     else arch.param_specs(mesh))
    want = _ref_flat(_ref_specs(ref_arch, ref_mesh, shape))
    assert got.keys() == want.keys()
    shapes = _port_flat(shr.shape_tree(pshape))
    ref_leaves = _ref_flat(ref_pshape)
    port_dtypes = {lf.path: lf.tensors[0].dtype
                   for lf in module_leaves(pshape)}
    for path, spec in want.items():
        assert _spec(got[path]) == _spec(spec), path
        assert tuple(shapes[path]) == tuple(ref_leaves[path].shape), path
        assert str(port_dtypes[path]).split(".")[-1] == \
            str(ref_leaves[path].dtype)
        # the per-device shard the spec gives, as the reference's
        # NamedSharding cuts it and as DTensor's Shard placements do
        ref_shard = NamedSharding(ref_mesh, spec).shard_shape(
            tuple(ref_leaves[path].shape))
        assert shr.shard_shape(shapes[path], got[path], mesh) == \
            tuple(ref_shard), path

    # the optimizer state: ZeRO-1 moments for the LMs, the param specs
    # otherwise (the reference dry run's ``_opt_specs``; that module is
    # not imported here: it sets XLA_FLAGS when imported)
    if arch.family == "lm":
        want_o = ref_arch.opt_specs(ref_mesh)
    else:
        want_o = OptState(step=JP(), m=_ref_specs(ref_arch, ref_mesh, shape),
                          v=_ref_specs(ref_arch, ref_mesh, shape))
    got_o = arch.opt_specs(mesh, shape) if arch.family == "gnn" \
        else arch.opt_specs(mesh)
    assert _spec(got_o.step) == _spec(want_o.step) == ()
    for name in ("m", "v"):
        g, w = _port_flat(getattr(got_o, name)), _ref_flat(getattr(want_o,
                                                                   name))
        assert g.keys() == w.keys()
        assert all(_spec(g[k]) == _spec(w[k]) for k in w)


@pytest.mark.parametrize("multi", MESHES.values(), ids=MESHES.keys())
@pytest.mark.parametrize("arch_id", ARCHS)
def test_cell_inputs_and_batch_specs_match_reference(arch_id, multi):
    ref_mesh, mesh = _meshes(multi)
    arch, ref_arch = configs.get_arch(arch_id), ref_configs.get_arch(arch_id)
    assert list(arch.shapes) == list(ref_arch.shapes)
    for shape, cell in arch.shapes.items():
        assert cell.skip == ref_arch.shapes[shape].skip
        got_in = _port_flat(arch.input_specs(shape))
        want_in = _ref_flat(ref_arch.input_specs(shape))
        assert got_in.keys() == want_in.keys(), shape
        for k, sd in want_in.items():
            shp, dt = sd.shape, sd.dtype
            assert tuple(got_in[k].shape) == tuple(shp), (shape, k)
            assert got_in[k].device.type == "meta"
            assert str(got_in[k].dtype).split(".")[-1] == str(dt), (shape, k)
        got = _port_flat(arch.batch_specs(shape, mesh))
        want = _ref_flat(ref_arch.batch_specs(shape, ref_mesh))
        assert got.keys() == want.keys(), shape
        for k in want:
            assert _spec(got[k]) == _spec(want[k]), (shape, k)


@pytest.mark.parametrize("multi", MESHES.values(), ids=MESHES.keys())
def test_spec_functions_on_a_small_mesh(multi):
    """The preference chains on a mesh whose model axis is 2: KV heads,
    experts and vocab rows divide it, the fallbacks show."""
    from repro.distributed import sharding as ref_shr
    names = ("pod", "data", "model") if multi else ("data", "model")
    sizes = (2, 4, 2) if multi else (4, 2)
    ref_mesh = AbstractMesh(sizes, names)
    mesh = shr.MeshAxes(names, dict(zip(names, sizes)))
    assert shr.batch_axes(mesh) == ref_shr.batch_axes(ref_mesh)
    assert shr.axis_size(mesh, ("data", "model")) == \
        ref_shr.axis_size(ref_mesh, ("data", "model"))
    for arch_id in ("qwen3-8b", "deepseek-v2-236b", "mixtral-8x7b"):
        arch = configs.get_arch(arch_id)
        ref_arch = ref_configs.get_arch(arch_id)
        cfg = arch.smoke()
        ref_cfg = ref_arch.smoke()
        got = _port_flat(shr.transformer_param_specs(
            cfg, mesh, tfm._build(cfg, None, torch.device("meta")),
            fsdp=True))
        want = _ref_flat(ref_shr.transformer_param_specs(
            ref_cfg, ref_mesh, jax.eval_shape(
                lambda k: ref_tfm.init(ref_cfg, k), jax.random.PRNGKey(0)),
            fsdp=True))
        assert got.keys() == want.keys()
        assert all(_spec(got[k]) == _spec(want[k]) for k in want), arch_id
        for b, s in ((4, 64), (1, 30)):
            cache = tfm.cache_spec(cfg, b, s)
            g = shr.transformer_cache_specs(cfg, mesh, cache)
            w = ref_shr.transformer_cache_specs(
                ref_cfg, ref_mesh, ref_tfm.cache_spec(ref_cfg, b, s))
            assert {k: _spec(v) for k, v in g.items()} == \
                {k: _spec(v) for k, v in w.items()}
    for shp in ((8, 6), (6, 8), (1, 5), (16,)):
        for spec in (JP(), JP("model"), JP(None, "model"), JP(("data",))):
            if len(spec) > len(shp):
                continue
            assert _spec(shr.zero_shard_spec(shr.P(*spec), shp, mesh)) == \
                _spec(ref_shr.zero_shard_spec(spec, shp, ref_mesh))


def test_placements_of_a_tuple_entry():
    """A tuple entry shards one dimension over several mesh dimensions in
    mesh order; out of order, twice or off the mesh, it raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = shr.MeshAxes(("pod", "data", "model"),
                        {"pod": 2, "data": 4, "model": 2})
    assert shr.placements(shr.P(("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert shr.placements(shr.P(None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    assert shr.shard_shape((10, 8, 6), shr.P(("pod", "data"), None, "model"),
                           mesh) == (2, 8, 3)
    for bad in (shr.P(("data", "pod")), shr.P("data", "data"),
                shr.P("expert")):
        with pytest.raises(ValueError):
            shr.placements(bad, mesh)
    assert shr.P(("data",), ()) == ("data", None)
