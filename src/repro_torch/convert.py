"""State and config carried across between the JAX package and the port.

A filter state is the system's "weights": a stream started under one
framework continues under the other from the same leaves —

    {"bits": (k, s) uint8 | (k, W) | (d, 1, W) | (1, W) uint32,
     "position": () int32, "load": (k,) int32, "rng": (2,) uint32}

plus, for swbf, ``"ring_events"`` (window, E) int32 and ``"ring_slot"`` ()
int32 — the reference's ``state.ring.events`` and ``state.ring.slot`` —
and, for an elastic sharded state, ``"router_assign"`` (n_buckets,) and
``"router_n_rebalances"`` () int32, its ``state.router``.
``bits`` is the dense8 layout's (n_rows, s) uint8 cells, the bitset
family's (k, W) rows or the counter family's (d, 1, W) bit-planes,
squeezed to (1, W) at d == 1 — as the config's layout says, which
``state_from_numpy`` checks; ``rng`` is
``jax.random.key_data(state.rng)``. ``state_from_numpy`` builds the port's
``FilterState`` from such a dict, ``state_to_numpy`` returns one with the
same dtypes and bytes, and ``config_from_dict`` takes a config from
``dataclasses.asdict`` of either package's ``DedupConfig``.

A tenant fleet's state (DESIGN §4.6, ``core.fleet``) crosses the same way
with ``fleet=True``: every leaf carries a leading axis of T =
``cfg.n_tenants`` — the reference ``FleetDedup``'s stacked leaves, its
(T, 2) rng key data and its stacked ring included.

An LM's weights cross as the reference's param tree of numpy leaves
(``jax.tree.map(np.asarray, params)``: ``embed``, ``layers`` with every
leaf stacked on a leading axis of n_layers - first_dense_layers,
``final_norm``, ``lm_head``, and where there are dense first layers
``dense_layers``, a Python list of unstacked layers) through
``transformer_params_from_numpy`` / ``transformer_params_to_numpy``, and
its decode cache (``k``, ``v`` or MLA's ``ckv``, ``kpe``, and ``kpos``,
stacked on all n_layers) through
``decode_cache_from_numpy`` / ``decode_cache_to_numpy``, and its
optimizer state (``OptState(step, m, v)``, the moments in the param
tree's structure, stacked) through ``opt_state_from_numpy`` /
``opt_state_to_numpy``. MeshGraphNet's weights (``enc_node``,
``enc_edge``, ``dec`` and the stacked ``blocks``, each MLP's ``ws`` /
``bs`` lists) cross through ``gnn_params_from_numpy`` /
``gnn_params_to_numpy``, and a recsys model's (``tables``, the MLP
lists, ``cin``, ``cross``, ``wide``, ...) through
``recsys_params_from_numpy`` / ``recsys_params_to_numpy``; the same
optimizer-state converters carry their AdamW state. numpy has no bf16
of its own, so a bf16 leaf comes back as float32 (exact widening).
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from .core import u32
from .core.config import DedupConfig
from .core.device import resolve_device
from .core.state import FilterState, WindowRing, bits_shape

if TYPE_CHECKING:       # the model converters import the model when called
    from .models import gnn, recsys
    from .models import transformer as tfm


def config_from_dict(d: dict) -> DedupConfig:
    names = {f.name for f in dataclasses.fields(DedupConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown DedupConfig fields {sorted(unknown)}")
    return DedupConfig(**d).validate()


def state_from_numpy(leaves: dict, cfg: DedupConfig, device=None, *,
                     fleet: bool = False) -> FilterState:
    """The port's state from numpy leaves; ``fleet=True`` takes a fleet's
    stacked leaves, each with a leading axis of ``cfg.n_tenants``."""
    device = resolve_device(device)
    lead = (cfg.n_tenants,) if fleet else ()
    shape = lead + bits_shape(cfg)
    want = np.uint32 if cfg.is_planes else np.uint8
    bits = np.asarray(leaves["bits"])
    load = np.asarray(leaves["load"])
    rng = np.asarray(leaves["rng"])
    position = np.asarray(leaves["position"])
    if bits.shape != shape or bits.dtype != want:
        raise ValueError(f"bits must be {np.dtype(want)} {shape} for this "
                         f"config ({cfg.effective_layout}), got "
                         f"{bits.dtype} {bits.shape}")
    if (load.shape != lead + (cfg.n_rows,) or rng.shape != lead + (2,)
            or position.shape != lead):
        raise ValueError(f"load {lead + (cfg.n_rows,)}, rng {lead + (2,)} "
                         f"and position {lead} expected; got {load.shape}, "
                         f"{rng.shape}, {position.shape}")
    ring = None
    if cfg.variant == "swbf":
        events = np.asarray(leaves["ring_events"])
        slot = np.asarray(leaves["ring_slot"])
        if (events.ndim != len(lead) + 2
                or events.shape[:len(lead) + 1] != lead + (cfg.window,)
                or events.dtype != np.int32 or slot.shape != lead):
            raise ValueError(f"ring_events must be int32 "
                             f"{lead + (cfg.window,)} + (E,) and ring_slot "
                             f"{lead}; got {events.dtype} {events.shape} "
                             f"and {slot.shape}")
        ring = WindowRing(
            events=torch.from_numpy(events.copy()).to(device),
            slot=torch.from_numpy(slot.astype(np.int32)).to(device))
    return FilterState(
        bits=(u32.from_numpy_u32(bits, device) if cfg.is_planes
              else torch.from_numpy(bits.copy()).to(device)),
        position=torch.from_numpy(position.astype(np.int32)).to(device),
        load=torch.from_numpy(load.astype(np.int32)).to(device),
        rng=u32.from_numpy_u32(rng, device),
        ring=ring,
    )


def state_to_numpy(state: FilterState) -> dict:
    """numpy leaves of a state, one filter's, a fleet's stacked ones or a
    sharded service's gathered ones:
    uint8 cells from a dense8 state, uint32 words from a plane state (the
    layout read off the cells' dtype)."""
    def ints(x):
        return x.detach().cpu().numpy().astype(np.int32)

    dense8 = state.bits.dtype == torch.uint8
    leaves = {
        "bits": (state.bits.detach().cpu().numpy().copy() if dense8
                 else u32.to_numpy_u32(state.bits)),
        "position": ints(state.position),
        "load": ints(state.load),
        "rng": u32.to_numpy_u32(state.rng),
    }
    if state.ring is not None:
        leaves["ring_events"] = ints(state.ring.events)
        leaves["ring_slot"] = ints(state.ring.slot)
    if state.router is not None:
        leaves["router_assign"] = ints(state.router.assign)
        leaves["router_n_rebalances"] = ints(state.router.n_rebalances)
    return leaves


# ------------------------------------------------------------- LM weights //

def _flatten(tree, prefix=()) -> dict:
    """{path: leaf} of a tree of dicts and lists (a list's index an int,
    as in ``layers.module_leaves``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, prefix + (k,)))
    return out


def _host_leaf(x) -> np.ndarray:
    """numpy float32 (or int32) of a tensor; bf16 widened exactly."""
    x = x.detach().cpu()
    if x.is_floating_point():
        x = x.float()
    return x.numpy().copy()


def _path_name(path) -> str:
    return "/".join(map(str, path))


def _params_from_numpy(template, tree: dict, device) -> "torch.nn.Module":
    """The port's params shaped as ``template`` (a ``Params`` tree on the
    ``meta`` device) from the reference's tree of numpy leaves, each cast
    to the template's dtype for it. Every leaf must be there with its
    shape; any other leaf is refused."""
    from .models.layers import module_leaves, rebuild_params
    device = resolve_device(device)
    want = {lf.path: lf for lf in module_leaves(template)}
    got = _flatten(tree)
    if set(got) != set(want):
        raise ValueError(
            f"param tree leaves differ from the config's: missing "
            f"{sorted(map(_path_name, set(want) - set(got)))}, unknown "
            f"{sorted(map(_path_name, set(got) - set(want)))}")
    tensors = {}
    for path, lf in want.items():
        arr = np.asarray(got[path])
        if arr.shape != lf.ref_shape:
            raise ValueError(f"{_path_name(path)}: shape {lf.ref_shape} "
                             f"expected, got {arr.shape}")
        parts = arr if lf.stacked else [arr]
        for key, meta, part in zip(lf.keys, lf.tensors, parts):
            tensors[key] = torch.from_numpy(np.array(part, np.float32)).to(
                device=device, dtype=meta.dtype)
    return rebuild_params(template, tensors)


def _params_to_numpy(params) -> dict:
    """The reference's param tree (numpy leaves, what it stacks stacked,
    its lists lists) of the port's params; bf16 weights come back as
    float32."""
    from .models.layers import module_leaves, ref_tree
    return ref_tree(
        (lf.path, np.stack([_host_leaf(t) for t in lf.tensors])
         if lf.stacked else _host_leaf(lf.tensors[0]))
        for lf in module_leaves(params))


def transformer_params_from_numpy(cfg: tfm.TransformerConfig, tree: dict,
                                  device=None) -> tfm.Params:
    """The port's params (``models.transformer``) from the reference's
    param tree of numpy leaves, each cast to the port's dtype for it
    (``cfg.dtype``; fp32 norms and router). Every leaf must be there with
    the config's shape; any other leaf is refused."""
    from .models import transformer as tfm
    return _params_from_numpy(tfm._build(cfg, None, torch.device("meta")),
                              tree, device)


def transformer_params_to_numpy(cfg: tfm.TransformerConfig, params) -> dict:
    """The reference's param tree (numpy leaves, ``layers`` stacked,
    ``dense_layers`` a list) of the port's params; bf16 weights come back
    as float32."""
    return _params_to_numpy(params)


def gnn_params_from_numpy(cfg: gnn.GNNConfig, tree: dict, device=None):
    """The port's MeshGraphNet params (``models.gnn``) from the
    reference's tree of numpy leaves: ``blocks`` stacked on a leading
    n_layers axis, each MLP's ``ws`` / ``bs`` lists. Checked as
    ``transformer_params_from_numpy`` checks."""
    from .models import gnn
    return _params_from_numpy(gnn._build(cfg, None, torch.device("meta")),
                              tree, device)


def gnn_params_to_numpy(cfg: gnn.GNNConfig, params) -> dict:
    """The reference's MeshGraphNet tree (numpy, ``blocks`` stacked)."""
    return _params_to_numpy(params)


def recsys_params_from_numpy(cfg: recsys.RecSysConfig, tree: dict,
                             device=None):
    """The port's recsys params (``models.recsys``) from the reference's
    tree of numpy leaves: ``tables`` ({``table_<i>``}), the MLPs' lists of
    {``w``, ``b``}, xDeepFM's ``cin`` list, DCN-v2's ``cross`` list.
    Checked as ``transformer_params_from_numpy`` checks."""
    from .models import recsys
    return _params_from_numpy(recsys._build(cfg, None, torch.device("meta")),
                              tree, device)


def recsys_params_to_numpy(cfg: recsys.RecSysConfig, params) -> dict:
    """The reference's recsys tree of the port's params (numpy leaves)."""
    return _params_to_numpy(params)


def decode_cache_from_numpy(cfg: tfm.TransformerConfig, cache: dict,
                            device=None) -> dict:
    """The port's decode cache from the reference's (``k``, ``v`` or
    ``ckv``, ``kpe``, and ``kpos``, stacked on L), checked against
    ``cache_spec``."""
    from .models import transformer as tfm
    device = resolve_device(device)
    kpos = np.asarray(cache["kpos"])
    if kpos.ndim != 3:
        raise ValueError(f"kpos must be (L, B, S), got {kpos.shape}")
    spec = tfm.cache_spec(cfg, kpos.shape[1], kpos.shape[2])
    if set(cache) != set(spec):
        raise ValueError(f"cache leaves {sorted(spec)} expected, got "
                         f"{sorted(cache)}")
    out = {}
    for name, (shape, dtype) in spec.items():
        arr = np.asarray(cache[name])
        if arr.shape != shape:
            raise ValueError(f"cache {name}: shape {shape} expected, got "
                             f"{arr.shape}")
        host = np.array(arr, np.int32 if dtype == torch.int32
                        else np.float32)
        out[name] = torch.from_numpy(host).to(device=device, dtype=dtype)
    return out


def decode_cache_to_numpy(cache: dict) -> dict:
    """numpy leaves of a decode cache (bf16 as float32, kpos int32)."""
    return {name: _host_leaf(t) for name, t in cache.items()}


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(v, fn) for v in tree]
    return fn(tree)


def opt_state_from_numpy(state, device=None):
    """The port's ``optim.OptState`` from the reference's, of numpy leaves
    (``jax.tree.map(np.asarray, opt_state)``: anything with ``step``,
    ``m`` and ``v``): the moments keep the reference's tree, fp32 on
    ``device``; the step is a () int32 tensor on the host, where the port
    keeps it."""
    from .optim import OptState
    device = resolve_device(device)

    def moment(a):
        host = np.array(np.asarray(a), np.float32)
        return torch.from_numpy(host).to(device)

    return OptState(
        step=torch.tensor(int(np.asarray(state.step)), dtype=torch.int32),
        m=_map_tree(state.m, moment), v=_map_tree(state.v, moment))


def opt_state_to_numpy(state):
    """The reference's leaves of the port's optimizer state: an
    ``OptState`` of an int32 () step and numpy fp32 moment trees."""
    from .optim import OptState
    return OptState(step=np.asarray(int(state.step), np.int32),
                    m=_map_tree(state.m, _host_leaf),
                    v=_map_tree(state.v, _host_leaf))
