"""Filter-state layout migration (DESIGN.md §3.6) and tenant hand-over
(§4.6) — the port of ``repro.checkpoint.migrate``.

A checkpoint written by a dense8 engine can be restored into a plane-layout
engine (and back): the cell VALUES are the portable contract, the layout is
an engine detail. ``layout_meta`` stamps the writing engine's layout into
the checkpoint's ``meta.json`` (via ``CheckpointManager.save(extra_meta=…)``)
so the restoring side knows what it is holding; ``migrate_filter_state``
re-encodes the cells. Because the dense8 and plane engines are bit-identical
(same probes, same rng threading, same cell values), a stream resumed after
migration continues exactly as if the layout had never changed — and the
port's migration equals the reference's leaf for leaf
(``tests/test_torch_checkpoint.py``). It decodes and packs one row, and
within it ``MIGRATE_CHUNK_WORDS`` words, at a time, so a 256 MB table's
migration on the card holds one chunk of cell values beside the two
layouts, never all (n_rows, s) of them as int32.

Every leaf of a migrated, exported or imported state is a fresh copy: the
port's ``run_stream`` and ``process_padded(donate=True)`` update a filter
in place, which must not reach the source.

The elastic sharded service's re-meshing (DESIGN §4.4): ``router_meta``
stamps the bucket -> shard table into meta.json and
``migrate_sharded_state`` re-stacks a gathered elastic state
(``ShardedDedup.gather_state``) for another shard count.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import packed
from ..core.config import DedupConfig
from ..core.sketch import get_spec
from ..core.state import (FilterState, WindowRing, bits_dtype, bits_shape,
                          init_router)

__all__ = ["layout_meta", "migrate_filter_state", "tenant_meta",
           "check_tenant_meta", "export_tenant", "import_tenant",
           "router_meta", "migrate_sharded_state"]

MIGRATE_CHUNK_WORDS = 1 << 20     # 2^25 cells decoded or packed at a time


def layout_meta(cfg: DedupConfig) -> dict:
    """The layout facts a checkpoint must carry to be migratable later."""
    return {
        "filter_variant": cfg.variant,
        # which SketchSpec family/ops wrote these cells (DESIGN §3.8) — a
        # restoring operator can see the sketch semantics (bitset membership
        # vs saturating counters) without resolving the variant name
        "filter_sketch": _sketch_tag(cfg),
        "filter_layout": cfg.effective_layout,
        "filter_planes": cfg.n_planes if cfg.is_planes else 0,
        "filter_cells": cfg.s,
        "filter_rows": cfg.n_rows,
        "filter_max": cfg.sbf_max if cfg.variant == "sbf" else 1,
        # swbf's ring-extended state (DESIGN §3.7): a restoring engine must
        # rebuild the same (window, d, W) ring slots and event capacity
        "filter_window": cfg.window if cfg.variant == "swbf" else 0,
        "filter_cbf_bits": cfg.cbf_bits if cfg.variant == "swbf" else 0,
        "filter_count_bits": (cfg.count_bits
                              if cfg.variant in ("cms", "hh") else 0),
        "filter_count_threshold": (cfg.count_threshold
                                   if cfg.variant in ("cms", "hh") else 0),
    }


def _sketch_tag(cfg: DedupConfig) -> str:
    """``family/probe`` of the variant's registered SketchSpec (§3.8)."""
    spec = get_spec(cfg.variant)
    return f"{spec.family}/{spec.probe}"


def router_meta(state: FilterState) -> dict:
    """The elastic router facts a sharded checkpoint carries (DESIGN
    §4.4): the bucket -> shard table and the rebalance counter, readable
    from meta.json without loading arrays. Empty for a state without a
    router."""
    if state.router is None:
        return {}
    assign = state.router.assign.cpu()
    return {
        "router_buckets": int(assign.shape[0]),
        "router_assign": assign.tolist(),
        "router_n_rebalances": int(state.router.n_rebalances),
    }


def tenant_meta(cfg: DedupConfig, params=None) -> dict:
    """The tenant-fleet facts a checkpoint must carry (DESIGN §4.6): the
    tenant count, the stacking tag, and — when the fleet runs heterogeneous
    per-tenant knobs — the ``TenantParams`` rows, host-readable from
    meta.json. Stamp via ``CheckpointManager.save(extra_meta={
    **layout_meta(cfg), **tenant_meta(cfg, fleet.params)})``."""
    meta = {
        "tenant_count": cfg.n_tenants,
        "tenant_layout": "stacked" if cfg.n_tenants > 1 else "single",
    }
    if params is not None:
        meta["tenant_params"] = {
            k: torch.as_tensor(v).cpu().tolist()
            for k, v in params._asdict().items()}
    return meta


def check_tenant_meta(meta: dict, cfg: DedupConfig) -> None:
    """Refuse to restore a checkpoint into the wrong fleet shape — the two
    corruption/mismatch classes a stacked state can hit (§4.6). Raises
    ``ValueError`` with the reference's messages; silently restoring would
    mis-slice every tenant's filter."""
    tag = meta.get("tenant_layout", "single")
    if tag not in ("single", "stacked"):
        raise ValueError(
            f"unrecognized tenant layout tag {tag!r} — checkpoint corrupt "
            f"or written by a newer format (expected 'single' or 'stacked'; "
            f"DESIGN §4.6)")
    n = int(meta.get("tenant_count", 1))
    if n != cfg.n_tenants:
        raise ValueError(
            f"tenant-count mismatch: checkpoint holds {n} tenant(s), the "
            f"restoring config expects {cfg.n_tenants} — a stacked state "
            f"cannot be re-sliced implicitly; export/import tenants "
            f"explicitly (export_tenant/import_tenant, DESIGN §4.6)")
    if tag == "stacked" and n <= 1:
        raise ValueError(
            f"tenant layout tag 'stacked' contradicts tenant_count {n} — "
            f"checkpoint meta corrupt (DESIGN §4.6)")


def _state_leaves(state: FilterState):
    """(bits, position, load, rng, ring events, ring slot); no ring, no
    ring leaves."""
    out = [state.bits, state.position, state.load, state.rng]
    return out + ([] if state.ring is None else list(state.ring))


def _from_leaves(leaves) -> FilterState:
    ring = WindowRing(*leaves[4:]) if len(leaves) > 4 else None
    return FilterState(*leaves[:4], ring=ring)


def export_tenant(state: FilterState, t: int) -> FilterState:
    """Slice ONE tenant's self-contained filter out of a stacked fleet
    state — its bits, position, load, tenant-folded rng and ring row — as a
    single-tenant ``FilterState`` a classic engine (or another fleet's
    ``import_tenant``) can run. Fresh copies."""
    n = _stacked_tenants(state)
    if not (0 <= t < n):
        raise ValueError(f"tenant {t} out of range for a fleet of {n}")
    return _from_leaves([x[t].clone() for x in _state_leaves(state)])


def import_tenant(state: FilterState, t: int, sub: FilterState
                  ) -> FilterState:
    """Write a single-tenant filter into row ``t`` of a stacked fleet state
    — the inverse of ``export_tenant`` (tenant migration between fleets,
    §4.6). Every leaf of ``sub`` must match the fleet's per-tenant shape.
    Returns a new state of fresh copies; the fleet's other tenants are
    untouched."""
    n = _stacked_tenants(state)
    if not (0 <= t < n):
        raise ValueError(f"tenant {t} out of range for a fleet of {n}")
    fleet, one = _state_leaves(state), _state_leaves(sub)
    if len(fleet) != len(one):
        raise ValueError("tenant state mismatch: the fleet and the import "
                         "differ in their ring — same config required "
                         "(§4.6)")
    out = []
    for x, s in zip(fleet, one):
        if s.shape != x.shape[1:]:
            raise ValueError(
                f"tenant state shape mismatch: fleet row is "
                f"{tuple(x.shape[1:])}, import is {tuple(s.shape)} — same "
                f"config required (§4.6)")
        x = x.clone()
        x[t] = s.to(device=x.device, dtype=x.dtype)
        out.append(x)
    return _from_leaves(out)


def _stacked_tenants(state: FilterState) -> int:
    """Tenant count of a stacked fleet state; refuses single-filter states
    (their position is a scalar — nothing to slice)."""
    if state.position.dim() != 1:
        raise ValueError(
            "not a stacked tenant-fleet state: expected a (T,) position "
            "axis (core.fleet.init_fleet_state); single-filter and sharded "
            "states have no tenant axis to slice (DESIGN §4.6)")
    return int(state.position.shape[0])


def migrate_sharded_state(state: FilterState, dst_shards: int
                          ) -> FilterState:
    """Re-stack a gathered ELASTIC sharded state for ``dst_shards`` shards.

    Leaves carry (src_shards, b_r, ...); the router table says which bucket
    occupies each (shard, slot). Buckets are taken into bucket-id order
    (undoing every rebalance's placement) and re-stacked as (dst_shards,
    n_buckets / dst_shards, ...) under the canonical block assignment — the
    layout ``ShardedDedup.init`` builds, so each rank's ``local_state`` of
    the result restores into its ``init()``. Bucket contents are untouched
    and ``n_rebalances`` carries over; every leaf is a fresh copy."""
    if state.router is None:
        raise ValueError("migrate_sharded_state needs an elastic state "
                         "(FilterState.router is None — static-hash sharded "
                         "and single-device states have no bucket unit)")
    assign = state.router.assign.cpu().numpy()
    nb = int(assign.shape[0])
    if nb % dst_shards:
        raise ValueError(f"cannot re-mesh {nb} buckets onto {dst_shards} "
                         f"shards: not divisible")
    # each bucket's slot within its source owner: its rank among the
    # owner's buckets in bucket-id order
    slot_of = np.zeros(nb, np.int64)
    counts: dict = {}
    for g in range(nb):
        slot_of[g] = counts.get(int(assign[g]), 0)
        counts[int(assign[g])] = slot_of[g] + 1
    src_b_r = state.position.shape[1]
    device = state.position.device
    flat_idx = torch.from_numpy(assign.astype(np.int64) * src_b_r
                                + slot_of).to(device)

    def leaf(x):
        flat = x.reshape(-1, *x.shape[2:])
        return flat.index_select(0, flat_idx).reshape(
            dst_shards, nb // dst_shards, *x.shape[2:])

    core = _from_leaves([leaf(x) for x in _state_leaves(state)])
    return core._replace(router=init_router(nb, dst_shards, device)._replace(
        n_rebalances=state.router.n_rebalances.clone()))


def _cells_from_state(state: FilterState, cfg: DedupConfig, row: int,
                      lo: int, hi: int) -> torch.Tensor:
    """Decode words [lo, hi) of row ``row`` — cells [32·lo, min(32·hi, s))
    — of any layout to int32 cell values."""
    n = min(32 * hi, cfg.s) - 32 * lo
    if not cfg.is_planes:                            # dense8: already cells
        return state.bits[row, 32 * lo:32 * lo + n].to(torch.int32)
    if cfg.is_counter:
        planes = state.bits if state.bits.dim() == 3 else state.bits[None]
        return packed.unpack_cells(planes[:, row, lo:hi], n)
    return packed.unpack_bits(state.bits[row, lo:hi], n).to(torch.int32)


def _encode_into(bits: torch.Tensor, cells: torch.Tensor, cfg: DedupConfig,
                 row: int, lo: int, hi: int) -> None:
    """Write the cells of words [lo, hi) of row ``row`` into ``bits`` in
    ``cfg``'s layout."""
    if not cfg.is_planes:
        bits[row, 32 * lo:32 * lo + cells.shape[0]] = cells.to(torch.uint8)
    elif cfg.is_counter:
        planes = packed.pack_cells(cells, cfg.n_planes)     # (d, W_chunk)
        if cfg.n_planes == 1:
            bits[row, lo:hi] = planes[0]
        else:
            bits[:, row, lo:hi] = planes
    else:
        bits[row, lo:hi] = packed.pack_bits(cells.to(torch.uint8))


def migrate_filter_state(state: FilterState, src_cfg: DedupConfig,
                         dst_cfg: Optional[DedupConfig] = None) -> FilterState:
    """Re-encode ``state`` from ``src_cfg``'s layout into ``dst_cfg``'s.

    Everything except the cell encoding (position, load, rng, the swbf
    ring) carries over untouched — they are layout-independent. The two
    configs must describe the same filter (variant/size/rows); only the
    layout/backend knobs may differ.
    """
    dst_cfg = src_cfg if dst_cfg is None else dst_cfg
    for field, a, b in (("variant", src_cfg.variant, dst_cfg.variant),
                        ("s", src_cfg.s, dst_cfg.s),
                        ("n_rows", src_cfg.n_rows, dst_cfg.n_rows),
                        ("sbf_max", src_cfg.sbf_max, dst_cfg.sbf_max),
                        ("window", src_cfg.window, dst_cfg.window),
                        ("bits_per_cell", src_cfg.bits_per_cell,
                         dst_cfg.bits_per_cell),
                        ("count_threshold", src_cfg.count_threshold,
                         dst_cfg.count_threshold)):
        if a != b:
            raise ValueError(
                f"cannot migrate between different filters: {field} "
                f"{a!r} != {b!r}")
    if src_cfg.effective_layout == dst_cfg.effective_layout:
        bits = state.bits.clone()
    else:
        bits = torch.empty(bits_shape(dst_cfg), dtype=bits_dtype(dst_cfg),
                           device=state.bits.device)
        w = dst_cfg.s_words
        for row in range(src_cfg.n_rows):
            for lo in range(0, w, MIGRATE_CHUNK_WORDS):
                hi = min(lo + MIGRATE_CHUNK_WORDS, w)
                _encode_into(bits, _cells_from_state(state, src_cfg, row,
                                                     lo, hi),
                             dst_cfg, row, lo, hi)
    ring = (None if state.ring is None
            else WindowRing(*(x.clone() for x in state.ring)))
    return FilterState(bits=bits, position=state.position.clone(),
                       load=state.load.clone(), rng=state.rng.clone(),
                       ring=ring)
