"""Architecture registry of the port — the counterpart of
``repro.configs.registry``: 10 assigned archs x their shape sets = 40
cells. ``LMArch``, ``GNNArch`` and ``RecsysArch`` each give their shape
cells, a reduced ``smoke()`` config for CPU tests, their optimizer and
their steps (LM ``train`` / ``prefill`` / ``decode``; GNN ``train``;
recsys ``train`` / ``infer`` / ``retrieval``); ``register`` /
``get_arch`` / ``all_arch_ids`` / ``all_cells`` resolve ``--arch`` ids.

Each also plans a cell on a mesh, from shapes alone:
  * ``params_shape`` — the param tree on the ``meta`` device;
  * ``param_specs`` / ``opt_specs`` — its partition specs and the
    optimizer state's (ZeRO-1 moments for the LMs), in the reference's
    tree structure (``distributed.sharding``);
  * ``input_specs`` — every step input of a cell as ``meta`` tensors of
    the reference's shapes and dtypes;
  * ``batch_specs`` — their partition specs on a mesh.
A mesh is a ``DeviceMesh`` or a ``MeshAxes`` record of names and sizes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..distributed import sharding as shr
from ..distributed.sharding import P
from ..models import gnn as gnn_mod
from ..models import recsys as rec_mod
from ..models import transformer as tfm
from ..optim import OptimizerConfig, OptState

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str             # train | prefill | decode | infer | retrieval
    dims: dict
    skip: Optional[str] = None


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _batch_axes_or_none(mesh, batch: int):
    """Batch partition axes, dropped when the batch is too small to
    split."""
    axes = shr.batch_axes(mesh)
    if axes and batch % shr.axis_size(mesh, axes) == 0 \
            and batch >= shr.axis_size(mesh, axes):
        return axes
    return None


def _opt_specs(pspecs) -> OptState:
    """The optimizer state's specs where the moments follow the params
    (the reference's dry run for GNN and recsys)."""
    return OptState(step=P(), m=pspecs, v=pspecs)


class LMArch:
    """An LM id's config and shape cells; ``accum`` is the reference's
    gradient-accumulation steps per train cell, which ``step`` reads."""
    family = "lm"

    def __init__(self, arch_id: str, cfg: tfm.TransformerConfig,
                 accum: Dict[str, int] | None = None):
        self.arch_id = arch_id
        self.cfg = cfg
        self.accum = accum or {}
        full_attn = cfg.attention == "full"
        skip = ("long_500k needs sub-quadratic attention; "
                f"{arch_id} is pure full-attention (DESIGN.md §5)"
                ) if full_attn else None
        self.shapes = {
            "train_4k": ShapeCell("train_4k", "train",
                                  {"seq": 4096, "batch": 256}),
            "prefill_32k": ShapeCell("prefill_32k", "prefill",
                                     {"seq": 32768, "batch": 32}),
            "decode_32k": ShapeCell("decode_32k", "decode",
                                    {"seq": 32768, "batch": 128}),
            "long_500k": ShapeCell("long_500k", "decode",
                                   {"seq": 524288, "batch": 1}, skip=skip),
        }

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(kind="adamw", lr=3e-4)

    # ------------------------------------------------------------------ //
    def params_shape(self):
        return tfm._build(self.cfg, None, META)

    def param_specs(self, mesh, fsdp: Optional[bool] = None):
        if fsdp is None:
            fsdp = self.cfg.param_count() > 3e10   # big models: FSDP over data
        return shr.transformer_param_specs(self.cfg, mesh,
                                           self.params_shape(), fsdp=fsdp)

    def opt_specs(self, mesh, fsdp: Optional[bool] = None) -> OptState:
        """ZeRO-1: each moment sharded by ``zero_shard_spec`` (of the
        params' specs, FSDP or not as ``param_specs``)."""
        pspecs = self.param_specs(mesh, fsdp)
        shapes = shr.shape_tree(self.params_shape())
        m_specs = shr.map_specs(
            lambda s, sh: shr.zero_shard_spec(s, sh, mesh), pspecs, shapes)
        return OptState(step=P(), m=m_specs, v=m_specs)

    def input_specs(self, shape: str) -> dict:
        cell = self.shapes[shape]
        d = cell.dims
        if cell.kind == "train":
            return {"tokens": _meta((d["batch"], d["seq"] + 1), torch.int32),
                    "weights": _meta((d["batch"],), torch.float32)}
        if cell.kind == "prefill":
            return {"tokens": _meta((d["batch"], d["seq"]), torch.int32)}
        # decode: one new token against a seq-long cache
        cache = {name: _meta(*sd) for name, sd in tfm.cache_spec(
            self.cfg, d["batch"], d["seq"]).items()}
        return {"cache": cache,
                "token": _meta((d["batch"],), torch.int32),
                "pos": _meta((d["batch"],), torch.int32)}

    def batch_specs(self, shape: str, mesh) -> dict:
        cell = self.shapes[shape]
        d = cell.dims
        b_ax = _batch_axes_or_none(mesh, d["batch"])
        if cell.kind == "train":
            return {"tokens": P(b_ax, None), "weights": P(b_ax)}
        if cell.kind == "prefill":
            return {"tokens": P(b_ax, None)}
        cache_specs = shr.transformer_cache_specs(
            self.cfg, mesh, tfm.cache_spec(self.cfg, d["batch"], d["seq"]))
        if b_ax is None:   # batch too small to split (long_500k b=1)
            bset = set(shr.batch_axes(mesh))

            def strip(e):
                if e is None:
                    return e
                if isinstance(e, str):
                    return None if e in bset else e
                kept = tuple(a for a in e if a not in bset)
                return kept or None

            cache_specs = {k: P(*(strip(e) for e in p))
                           for k, p in cache_specs.items()}
        return {"cache": cache_specs, "token": P(b_ax), "pos": P(b_ax)}

    # ------------------------------------------------------------------ //
    def step(self, shape: str, update_fn: Optional[Callable] = None
             ) -> Callable:
        """The cell's step: ``train_step(params, opt_state, tokens,
        weights)`` -> (params, opt_state, metrics) with the cell's
        gradient accumulation (its update ``update_fn``, by default
        ``train.steps.apply_updates``); ``prefill_step(params, tokens)``
        -> last-token logits (serving emits those); or
        ``serve_step(params, cache, token, pos)`` -> (logits, cache)."""
        cell = self.shapes[shape]
        cfg = self.cfg
        if cell.kind == "train":
            from ..train.steps import make_train_step

            def loss_fn(params, batch, weights):
                loss, _ = tfm.forward(cfg, params, batch, weights)
                return loss

            update = {} if update_fn is None else {"update_fn": update_fn}
            return make_train_step(loss_fn, self.opt_config(),
                                   accum_steps=self.accum.get(shape, 1),
                                   **update)
        if cell.kind == "prefill":
            def prefill_step(params, tokens):
                return tfm.prefill(cfg, params, tokens)[:, -1]
            return prefill_step

        def serve_step(params, cache, token, pos):
            return tfm.decode_step(cfg, params, cache, token, pos)
        return serve_step

    def smoke(self) -> tfm.TransformerConfig:
        """The reference's reduced CPU config: 2 layers, d 64, fp32."""
        return dataclasses.replace(
            self.cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=min(4, self.cfg.n_kv_heads),
            head_dim=16, d_ff=128, vocab=512,
            d_ff_expert=32 if self.cfg.is_moe else 0,
            n_experts=min(4, self.cfg.n_experts),
            moe_top_k=min(self.cfg.moe_top_k,
                          max(1, min(4, self.cfg.n_experts))),
            q_lora_rank=32 if self.cfg.q_lora_rank else 0,
            kv_lora_rank=32 if self.cfg.use_mla else 512,
            qk_nope_dim=16 if self.cfg.use_mla else 128,
            qk_rope_dim=8 if self.cfg.use_mla else 64,
            v_head_dim=16 if self.cfg.use_mla else 128,
            window=16 if self.cfg.attention == "swa" else 4096,
            dtype=torch.float32, remat="none",
            attn_q_block=32, attn_k_block=32)


# =================================================================== GNN == //

class GNNArch:
    """MeshGraphNet's config and its four train cells; ``cfg_for`` sets
    the node feature width of a cell."""
    family = "gnn"

    def __init__(self, arch_id: str, base_cfg: gnn_mod.GNNConfig):
        self.arch_id = arch_id
        self.base_cfg = base_cfg
        self.shapes = {
            "full_graph_sm": ShapeCell(
                "full_graph_sm", "train",
                {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
            "minibatch_lg": ShapeCell(
                "minibatch_lg", "train",
                # sampled-subgraph worst case: 1024 seeds, fanout (15, 10)
                {"n_nodes": 1024 * (1 + 15 + 150),
                 "n_edges": 1024 * (15 + 150), "d_feat": 602,
                 "graph_nodes": 232_965, "graph_edges": 114_615_892,
                 "batch_nodes": 1024, "fanout": (15, 10)}),
            "ogb_products": ShapeCell(
                "ogb_products", "train",
                {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100,
                 "shard_over_model": True}),
            "molecule": ShapeCell(
                "molecule", "train",
                {"n_nodes": 30 * 128, "n_edges": 64 * 128, "d_feat": 16}),
        }

    def cfg_for(self, shape: str) -> gnn_mod.GNNConfig:
        d = self.shapes[shape].dims
        return dataclasses.replace(self.base_cfg, d_node_in=d["d_feat"])

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.0)

    def params(self, shape: str, seed: int = 0, device=None):
        """The cell's seeded params (``gnn.init`` at ``cfg_for(shape)``)."""
        return gnn_mod.init(self.cfg_for(shape), seed, device)

    def params_shape(self, shape: str):
        return gnn_mod._build(self.cfg_for(shape), None, META)

    def param_specs(self, mesh, shape: str = "full_graph_sm"):
        return shr.gnn_param_specs(mesh, self.params_shape(shape))

    def opt_specs(self, mesh, shape: str = "full_graph_sm") -> OptState:
        return _opt_specs(self.param_specs(mesh, shape))

    def input_specs(self, shape: str) -> dict:
        n, e = self.padded(shape)
        f = self.shapes[shape].dims["d_feat"]
        d_out = self.cfg_for(shape).d_out
        return {"batch": {
            "nodes": _meta((n, f), torch.float32),
            "edges": _meta((e, 8), torch.float32),
            "src": _meta((e,), torch.int32), "dst": _meta((e,), torch.int32),
            "edge_mask": _meta((e,), torch.bool),
            "node_mask": _meta((n,), torch.bool),
            "targets": _meta((n, d_out), torch.float32),
        }}

    def batch_specs(self, shape: str, mesh) -> dict:
        over_model = self.shapes[shape].dims.get("shard_over_model", False)
        return {"batch": shr.gnn_batch_specs(mesh, over_model)}

    @staticmethod
    def _pad4k(n: int) -> int:
        """Graphs are padded (masked) to multiples of 4096 so node/edge
        dims divide every mesh extent (16/32/256/512)."""
        return ((n + 4095) // 4096) * 4096

    def padded(self, shape: str) -> tuple:
        """(N, E) of the cell's padded batch."""
        d = self.shapes[shape].dims
        return self._pad4k(d["n_nodes"]), self._pad4k(d["n_edges"])

    def step(self, shape: str) -> Callable:
        """``train_step(params, opt_state, batch, weights=None)`` ->
        (params, opt_state, metrics): value and grad of ``loss_fn``, then
        ``apply_updates``."""
        from ..train.steps import make_train_step
        cfg = self.cfg_for(shape)

        def loss(params, batch, weights):
            return gnn_mod.loss_fn(cfg, params, batch, weights)

        return make_train_step(loss, self.opt_config())

    def smoke(self) -> gnn_mod.GNNConfig:
        return dataclasses.replace(self.base_cfg, n_layers=3, d_hidden=32,
                                   d_node_in=16)


def pad_graph(batch: dict, n_nodes: int, n_edges: int) -> dict:
    """A numpy graph batch padded with masked-off nodes and edges (zeros,
    ``node_mask`` / ``edge_mask`` False) to ``n_nodes`` and ``n_edges``."""
    n, e = batch["nodes"].shape[0], batch["src"].shape[0]
    if n > n_nodes or e > n_edges:
        raise ValueError(f"a graph of {n} nodes and {e} edges does not pad "
                         f"to {n_nodes} and {n_edges}")
    out = {}
    for k, v in batch.items():
        extra = (n_nodes - n) if k in ("nodes", "node_mask", "targets") \
            else (n_edges - e)
        out[k] = np.concatenate(
            [v, np.zeros((extra,) + v.shape[1:], v.dtype)])
    return out


# ================================================================ RecSys == //

class RecsysArch:
    family = "recsys"

    def __init__(self, arch_id: str, cfg: rec_mod.RecSysConfig):
        self.arch_id = arch_id
        self.cfg = cfg
        self.shapes = {
            "train_batch": ShapeCell("train_batch", "train", {"batch": 65536}),
            "serve_p99": ShapeCell("serve_p99", "infer", {"batch": 512}),
            "serve_bulk": ShapeCell("serve_bulk", "infer", {"batch": 262144}),
            "retrieval_cand": ShapeCell("retrieval_cand", "retrieval",
                                        {"batch": 1, "n_cand": 1_000_000}),
        }

    def opt_config(self) -> OptimizerConfig:
        return OptimizerConfig(kind="adamw", lr=1e-3, weight_decay=0.0)

    def params_shape(self):
        return rec_mod._build(self.cfg, None, META)

    def param_specs(self, mesh):
        return shr.recsys_param_specs(mesh, self.params_shape())

    def opt_specs(self, mesh) -> OptState:
        return _opt_specs(self.param_specs(mesh))

    def input_specs(self, shape: str) -> dict:
        cell = self.shapes[shape]
        d = cell.dims
        B, F = d["batch"], self.cfg.n_sparse
        ids = (B, F) if self.cfg.multi_hot == 1 else (B, F,
                                                      self.cfg.multi_hot)
        base = {"dense": _meta((B, self.cfg.n_dense), torch.float32),
                "sparse_ids": _meta(ids, torch.int32)}
        if cell.kind == "train":
            return {"batch": {**base, "labels": _meta((B,), torch.float32)},
                    "weights": _meta((B,), torch.float32)}
        if cell.kind == "retrieval":
            return {"batch": {**base, "candidates": _meta(
                (d["n_cand"], self.cfg.embed_dim), torch.float32)}}
        return {"batch": base}

    def batch_specs(self, shape: str, mesh) -> dict:
        cell = self.shapes[shape]
        b_ax = _batch_axes_or_none(mesh, cell.dims["batch"])
        if cell.kind == "retrieval":
            return {"batch": shr.recsys_batch_specs(mesh, retrieval=True)}
        ids = [b_ax, None] if self.cfg.multi_hot == 1 else [b_ax, None, None]
        base = {"dense": P(b_ax, None), "sparse_ids": P(*ids)}
        if cell.kind == "train":
            return {"batch": {**base, "labels": P(b_ax)}, "weights": P(b_ax)}
        return {"batch": base}

    def step(self, shape: str) -> Callable:
        """``train_step(params, opt_state, batch, weights)`` -> (params,
        opt_state, metrics); ``infer_step(params, batch)`` -> logits (B,);
        ``retrieval_step(params, batch)`` -> (scores, top scores, top
        indices). Serving runs under ``torch.inference_mode()``."""
        cell = self.shapes[shape]
        cfg = self.cfg
        if cell.kind == "train":
            from ..train.steps import make_train_step

            def loss(params, batch, weights):
                return rec_mod.loss_fn(cfg, params, batch, weights)

            return make_train_step(loss, self.opt_config())
        if cell.kind == "retrieval":
            @torch.inference_mode()
            def retrieval_step(params, batch):
                return rec_mod.retrieval_scores(cfg, params, batch)
            return retrieval_step

        @torch.inference_mode()
        def infer_step(params, batch):
            return rec_mod.forward(cfg, params, batch)
        return infer_step

    def smoke(self) -> rec_mod.RecSysConfig:
        return dataclasses.replace(
            self.cfg, vocab_sizes=tuple(min(v, 1000)
                                        for v in self.cfg.vocab_sizes))


# ============================================================== registry == //

_REGISTRY: Dict[str, Callable[[], object]] = {}


def register(arch_id: str):
    def deco(fn):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def _load_all() -> None:
    from . import gnn_archs, lm_archs, recsys_archs  # noqa: F401


def get_arch(arch_id: str):
    _load_all()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def all_arch_ids() -> list:
    _load_all()
    return sorted(_REGISTRY)


def all_cells() -> list:
    """Every (arch_id, shape_name, skip_reason) — the 40 assigned cells."""
    out = []
    for aid in all_arch_ids():
        for sname, cell in get_arch(aid).shapes.items():
            out.append((aid, sname, cell.skip))
    return out
