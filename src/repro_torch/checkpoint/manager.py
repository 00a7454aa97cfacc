"""Checkpointing — the port of ``repro.checkpoint.manager``: atomic,
retained, resumable, and in the reference's on-disk format.

  * atomic commit — write to ``step_XXXX.tmp`` then ``os.replace`` so a
    crash mid-save never corrupts the latest checkpoint;
  * retention — keep the last N checkpoints plus every Kth "anchor";
  * resume — ``latest_step()`` + ``restore(step, template)`` rebuilds the
    exact tree (the dedup filter state including the stream position —
    RSBF's insert probability s/i must survive restart, DESIGN.md §4);
  * layout migration — ``save(extra_meta=layout_meta(cfg))`` stamps the
    filter's cell layout into meta.json (read back via ``load_meta``), so a
    dense8 checkpoint can be re-encoded into the plane layout with
    ``repro_torch.checkpoint.migrate_filter_state`` (DESIGN.md §3.6).

The format is the reference's, so a checkpoint written by either package
resumes in the other: ``arrays.npz`` of flattened leaves plus
``meta.json``. Leaves are named as the reference's JAX tree paths name
them, without JAX: a dict key as the key (dicts in sorted key order), a
list or tuple index as the index, a ``FilterState`` or ``WindowRing`` field
(or any NamedTuple's) as ``.name``, joined with ``/``; a ``None`` (a
filter without a ring) is no leaf. A model's ``Params`` module is the
reference's param tree: a ``ModuleList`` of layers is written as one
leaf per parameter name stacked on a leading L axis
(``params/layers/attn/wq`` is (L, d, H, hd)), a ``LayerList`` (the
reference's Python list ``dense_layers``) as one leaf per layer and name
(``params/dense_layers/0/attn/norm``), and a ``Params`` template
restores into a new module of the same structure — so a trainer's tree
``{"params", "opt_state", "dedup"}`` crosses either way. A pipeline's
``state_dict()`` gives ``filter_state/.bits``, ``filter_state/.position``,
...; an elastic sharded state adds ``.router/.assign`` and ``.router/.n_rebalances``. A
``FilterState``'s leaves are written in the reference's dtypes (``convert.state_to_numpy``):
words as uint32, never the port's int32 bit patterns, so both packages
write the same names, dtypes, shapes and bytes. bfloat16 leaves are stored
as their uint16 bits under ``name::bf16``, as in the reference; a
reference checkpoint's typed PRNG keys (``name::prngkey``) restore as their
raw key data.

``restore(step, template)`` is driven by the template: it reads the leaves
the template names, casts each to the template leaf's dtype (a uint32 file
leaf into an int32 template leaf keeps its bit pattern) and puts it on the
template leaf's device. Keys the template lacks are ignored.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import time
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..convert import state_to_numpy
from ..core.state import FilterState, RouterState, WindowRing
from ..models.layers import module_leaves, rebuild_params

# the reference's leaf name of each ``state_to_numpy`` leaf
_STATE_LEAVES = (("bits", ".bits"), ("position", ".position"),
                 ("load", ".load"), ("rng", ".rng"),
                 ("ring_events", ".ring/.events"),
                 ("ring_slot", ".ring/.slot"),
                 ("router_assign", ".router/.assign"),
                 ("router_n_rebalances", ".router/.n_rebalances"))


def _jsonable(x):
    """meta.json-safe view of an ``extra_meta`` value: tensors and numpy
    arrays become lists, numpy scalars become python scalars — so callers
    can stamp live state without hand-converting, and a stray array can
    never corrupt a save half-way through the atomic commit."""
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().tolist()
    if isinstance(x, np.ndarray):
        return x.tolist()
    return x


def _join(prefix: str, part: str) -> str:
    return f"{prefix}/{part}" if prefix else part


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(name, leaf) pairs in the reference's tree order; a FilterState
    yields its numpy leaves in the reference's dtypes."""
    if tree is None:
        return
    if isinstance(tree, FilterState):
        arrs = state_to_numpy(tree)
        for key, name in _STATE_LEAVES:
            if key in arrs:
                yield _join(prefix, name), arrs[key]
    elif isinstance(tree, nn.Module):
        for lf in module_leaves(tree):
            parts = [t.detach().cpu() for t in lf.tensors]
            yield (_join(prefix, "/".join(map(str, lf.path))),
                   torch.stack(parts) if lf.stacked else parts[0])
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], _join(prefix, str(k)))
    elif _is_namedtuple(tree):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), _join(prefix, "." + f))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from _leaves(x, _join(prefix, str(i)))
    else:
        yield prefix, tree


def _flatten(tree) -> dict:
    flat = {}
    for key, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu()
            if leaf.dtype == torch.bfloat16:
                # numpy can't represent bf16 — store a bit-preserving u16
                flat[key + "::bf16"] = leaf.view(torch.int16).numpy().view(
                    np.uint16)
                continue
            leaf = leaf.numpy()
        flat[key] = np.asarray(leaf)
    return flat


def _restore_leaf(like, flat: dict, key: str):
    """The file's leaf ``key`` in the dtype and on the device of the
    template leaf ``like``."""
    if not isinstance(like, torch.Tensor):
        return np.asarray(flat[key]).astype(np.asarray(like).dtype)
    device = like.device if like.device.type != "meta" else "cpu"
    if key + "::bf16" in flat:
        bits = np.array(flat[key + "::bf16"], order="C").view(np.int16)
        val = torch.from_numpy(bits).view(torch.bfloat16)
    else:
        name = key + "::prngkey" if key + "::prngkey" in flat else key
        arr = np.array(flat[name], order="C")        # a copy, 0-d kept
        if arr.dtype == np.uint32 and like.dtype == torch.int32:
            arr = arr.view(np.int32)                 # the same bits
        elif arr.dtype in (np.uint16, np.uint32):
            arr = arr.astype(np.int64)
        val = torch.from_numpy(arr)
    return val.to(device=device, dtype=like.dtype)


def _unflatten(template, flat: dict, prefix: str = ""):
    if template is None:
        return None
    if isinstance(template, FilterState):
        def sub(tree, kind, name):
            if tree is None:
                return None
            return kind(*(_restore_leaf(x, flat,
                                        _join(prefix, f".{name}/.{f}"))
                          for x, f in zip(tree, kind._fields)))

        return FilterState(*(_restore_leaf(getattr(template, f), flat,
                                           _join(prefix, "." + f))
                             for f in ("bits", "position", "load", "rng")),
                           ring=sub(template.ring, WindowRing, "ring"),
                           router=sub(template.router, RouterState,
                                      "router"))
    if isinstance(template, nn.Module):
        tensors = {}
        for lf in module_leaves(template):
            val = _restore_leaf(lf.tensors[0], flat,
                                _join(prefix, "/".join(map(str, lf.path))))
            parts = val.unbind(0) if lf.stacked else (val,)
            tensors.update(zip(lf.keys, parts))
        return rebuild_params(template, tensors)
    if isinstance(template, dict):
        return {k: _unflatten(v, flat, _join(prefix, str(k)))
                for k, v in template.items()}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(getattr(template, f), flat,
                                           _join(prefix, "." + f))
                                for f in template._fields))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, flat, _join(prefix, str(i)))
                              for i, x in enumerate(template))
    return _restore_leaf(template, flat, prefix)


class CheckpointManager:
    def __init__(self, directory: str, keep_n: int = 3, anchor_every: int = 0):
        self.dir = directory
        self.keep_n = keep_n
        self.anchor_every = anchor_every
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ //
    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, tree: Any, extra_meta: Optional[dict] = None
             ) -> str:
        final = self._path(step)
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        flat = _flatten(tree)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        meta = {"step": step, "time": time.time(),
                "keys": sorted(flat.keys()), **_jsonable(extra_meta or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)                      # atomic commit
        self._retain()
        return final

    def _retain(self) -> None:
        steps = self.all_steps()
        keep = set(steps[-self.keep_n:]) if self.keep_n else set(steps)
        if self.anchor_every:
            keep |= {s for s in steps if s % self.anchor_every == 0}
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._path(s), ignore_errors=True)

    # ------------------------------------------------------------------ //
    def all_steps(self) -> list:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load_meta(self, step: int) -> dict:
        """The checkpoint's meta.json — including any ``extra_meta`` stamped
        at save time (e.g. the filter layout facts from
        ``repro_torch.checkpoint.layout_meta``, which is how a dense8
        checkpoint announces itself to a plane-layout engine for
        migration)."""
        path = os.path.join(self._path(step), "meta.json")
        with open(path) as f:
            try:
                return json.load(f)
            except json.JSONDecodeError as e:
                # a meta.json inside a committed step_ dir can only be
                # short-written by the filesystem (the atomic-commit rename
                # never publishes a partial dir) — refuse loudly rather
                # than hand the caller a half-parsed layout
                raise ValueError(
                    f"checkpoint meta.json truncated or corrupt at {path}: "
                    f"{e}") from e

    def restore(self, step: int, template: Any) -> Any:
        path = self._path(step)
        with np.load(os.path.join(path, "arrays.npz")) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(template, flat)

    def restore_latest(self, template: Any):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template)
