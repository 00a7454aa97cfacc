"""Distributed de-duplication — the port of ``repro.dedup.sharded`` (DESIGN
§4, §4.4 – §4.6) over ``torch.distributed``.

The key space is partitioned over the ranks of a process group: each rank
holds a filter of ``memory / n_shards`` bits per row (static routing) or
``b_r = n_buckets / n_shards`` bucket sub-filters (elastic routing) and is
authoritative for its keys. Sharding changes the layout, not the math.

* **The reference's SPMD contract.** Every rank passes the same GLOBAL
  stream; rank r takes rows ``[r·lb, (r+1)·lb)`` of each global batch of
  ``base.batch_size = n_shards · lb`` keys, routes each key to its owner
  with a fixed-capacity dispatch (``all_to_all_single``), steps what it
  owns with the single-device batched step, and sends the verdicts home.
  Every call returns the global (N,) verdicts (an ``all_gather``) and the
  (n_batches, n_shards) int32 overflow, which ``StreamMetrics.update(
  overflow=...)`` takes as it is. Lanes past a capacity are reported
  distinct and counted; invalid (padding) lanes are never routed.
* **State.** Each rank holds its own slab with the reference's leading
  axes: (1, ...) static, (1, b_r, ...) elastic. The elastic router table
  (``FilterState.router``) is replicated. ``gather_state`` returns the
  reference's global layout (n_shards, ...), which checkpoints and the
  parity tests read; ``local_state`` takes a rank's slab back out of it.
* **Static hash routing** (``base.rebalance_buckets == 0``): an independent
  router hash (``route_hash``) picks each key's shard; each rank is one
  filter whose rng is folded on its rank.
* **Elastic key-range routing** (``base.rebalance_buckets = nb``): the
  uint32 key space splits into nb contiguous ranges (``range_bucket``),
  each a self-contained sub-filter of ``memory / nb`` whose rng is folded
  on its bucket id, so its randomness travels with it. A rank's b_r bucket
  slots step as ONE call over a leading slot axis — the tenant axis of the
  fleet step (``core.batched``), so one kernel launch per step on the plane
  layout and on bitset dense8; dense8 sbf has no tenant axis, so there the
  slots step one by one, as the reference's ``lax.scan`` does. Every
  bucket steps at the width ``bucket_capacity``, a function of the global
  batch and nb only, so its verdicts do not depend on the rank count. A
  load monitor (threshold ``base.rebalance_threshold`` on the max / mean
  per-shard load) re-packs the table by greedy LPT and moves whole buckets
  between ranks around a ring (``distributed.sharding.rebalance_collect``):
  placement changes, verdicts do not.
* **Pipelined stream** (``pipeline=True``, DESIGN §4.5): batch t+1's
  dispatch exchange is issued with ``async_op=True`` before batch t is
  consumed and waited on just before it is consumed. Per-source counts
  replace the valid masks and tags on the wire, and variants that draw
  nothing per lane (``get_spec(v).draw is None``) step at the compacted
  width ``step_width``. Verdicts equal the serial stream's bit for bit.

On the wire keys travel as the port's int32 words, counts as int32 and
masks as uint8, so the payload is the same under gloo (CPU) and NCCL (the
card); the reference's ``psum`` is an ``all_reduce``. The service needs an
initialised process group and never falls back to a single process: a
single process is a group of world size 1, whose collectives still run.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core import prng, u32
from ..core.batched import (TenantStepParams, make_batched_step,
                            make_templated_step)
from ..core.config import DedupConfig
from ..core.device import resolve_device
from ..core.fleet import tenant_tagged_keys
from ..core.hashing import range_bucket, route_hash
from ..core.sketch import get_spec
from ..core.state import (FilterState, RouterState, WindowRing, init_router,
                          init_state)
from ..distributed.sharding import rebalance_collect, tree_map
from ..kernels.fused_template import int32_rows

_INT32_MAX = np.iinfo(np.int32).max


class InFlight(NamedTuple):
    """One dispatched batch not yet consumed (DESIGN §4.5): the receive
    buffers of its exchange — per-source key windows and valid-lane counts
    for what this rank owns, filled once ``works`` are waited on — and the
    home-side coordinates that route its verdicts back. ``sl`` is None on
    the static path (no bucket slots)."""
    keys: torch.Tensor            # (S, C) / (S, b_r, C) int32 words
    cnt: torch.Tensor             # (S,) / (S, b_r) int32
    o: torch.Tensor               # (lb,) int64 destination shard
    sl: Optional[torch.Tensor]    # (lb,) int64 bucket slot (elastic)
    p: torch.Tensor               # (lb,) int64 window position
    keep: torch.Tensor            # (lb,) bool routed (not overflowed)
    ovf: torch.Tensor             # () int32 dispatch-side overflow
    works: tuple                  # the exchange's pending work handles

    def wait(self) -> None:
        for w in self.works:
            w.wait()


@dataclasses.dataclass(frozen=True)
class ShardedDedupConfig:
    base: DedupConfig
    capacity_factor: float = 2.0
    pipeline: bool = True          # double-buffered dispatch (DESIGN §4.5)

    @property
    def elastic(self) -> bool:
        """Elastic key-range routing with a dynamic router table (§4.4),
        selected by ``base.rebalance_buckets > 0``."""
        return self.base.rebalance_buckets > 0

    @property
    def n_buckets(self) -> int:
        return self.base.rebalance_buckets

    def capacity(self, local_batch: int, n_shards: int) -> int:
        """Per (source, destination) window of the static dispatch."""
        return max(8, math.ceil(local_batch / n_shards * self.capacity_factor))

    def bucket_capacity(self, local_batch: int, n_shards: int) -> int:
        """Per-bucket step width T of the elastic path: a function of the
        GLOBAL batch and the bucket count only, so every bucket's
        computation — and every verdict — is the same at any rank count
        (§4.4)."""
        g = local_batch * n_shards
        return max(8, math.ceil(g / self.n_buckets * self.capacity_factor))

    def step_width(self, local_batch: int, n_shards: int) -> int:
        """Owner-side compacted step width T' of the pipelined static path
        (§4.5): ``local_batch`` expected keys plus an 8-sigma Poisson
        margin, never wider than the flat ``n_shards * capacity`` width.
        Used only by variants that draw nothing per lane — a width change
        re-indexes every rng draw of the others."""
        flat = n_shards * self.capacity(local_batch, n_shards)
        t = local_batch + max(64, math.ceil(8.0 * math.sqrt(local_batch)))
        return min(flat, max(8, -(-t // 8) * 8))


def _drop_scatter(shape, index, values, fill) -> torch.Tensor:
    """A buffer of ``shape`` filled with ``fill`` and ``values`` put at
    ``index``; lanes indexed at row ``shape[0]`` land in a spare row that is
    sliced off (the reference's ``mode="drop"``)."""
    buf = torch.full((shape[0] + 1, *shape[1:]), fill, dtype=values.dtype,
                     device=values.device)
    buf.index_put_(index, values)
    return buf[:shape[0]]


class ShardedDedup:
    """The dedup service over a process group (``group=None``: the default
    group). ``n_shards`` is the group's size and ``me`` this rank. It runs
    on ``cuda`` unless the caller passes ``device="cpu"`` (gloo on the CPU,
    NCCL on the card); ``partitionable`` picks JAX's threefry counter
    layout, as for ``Dedup``."""

    def __init__(self, scfg: ShardedDedupConfig, group=None, device=None, *,
                 partitionable: bool = True):
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ShardedDedup runs over torch.distributed: initialise a "
                "process group first (one process is a group of world "
                "size 1)")
        self.scfg = scfg
        self.group = group
        self.device = resolve_device(device)
        self.n_shards = dist.get_world_size(group)
        self.me = dist.get_rank(group)
        if scfg.elastic:
            if scfg.n_buckets % self.n_shards:
                raise ValueError(
                    f"rebalance_buckets {scfg.n_buckets} must divide by the "
                    f"group's shard count {self.n_shards} (DESIGN §4.4)")
            self.b_r = scfg.n_buckets // self.n_shards
            # per-BUCKET sub-filter: the aggregate memory over all buckets
            self.local_cfg = dataclasses.replace(
                scfg.base, shards=scfg.n_buckets).validate()
        else:
            self.b_r = 0
            # per-shard filter: the aggregate memory divided across shards
            self.local_cfg = dataclasses.replace(
                scfg.base, shards=self.n_shards).validate()
        # the slots of a rank step as the fleet step's tenant rows; a fleet
        # config's tenant count is a routing fact here (run_tenant_stream),
        # which the step factories do not read
        step_cfg = self.local_cfg
        rows = max(1, self.b_r)
        if step_cfg.variant == "sbf" and not step_cfg.is_planes:
            # dense8 sbf has no tenant axis: its slots step one by one
            self._fleet_step = None
            self._row_step = make_batched_step(step_cfg, self.device,
                                               partitionable)
        else:
            self._fleet_step = make_templated_step(
                step_cfg, device=self.device, partitionable=partitionable,
                params_aware=True)
            self._tp = TenantStepParams(
                *(int32_rows(v, rows, self.device)
                  for v in (step_cfg.sbf_max, step_cfg.count_threshold,
                            max(step_cfg.window, 1))))
        # owner-side compaction (§4.5) is exact only when the decision
        # consumes no per-lane randomness: the draws are indexed by lane
        self._compactable = get_spec(scfg.base.variant).draw is None
        self._threshold = float(scfg.base.rebalance_threshold)
        self._stream_shapes: set = set()

    # ------------------------------------------------------------------ //
    def init(self, seed: int | None = None,
             event_capacity: int | None = None) -> FilterState:
        """This rank's slab: leaves with a leading shard axis of 1 (elastic:
        (1, b_r, ...) bucket slots plus the replicated router table). For
        swbf each ring slot absorbs one step's whole dispatch — the flat
        (n_shards · capacity) or the compacted width statically, the
        bucket width elastically — sized for ``run_stream`` /
        ``make_step(base.batch_size // n_shards)``; a wider ``make_step``
        needs a matching ``event_capacity``."""
        local_batch = max(1, self.scfg.base.batch_size // self.n_shards)
        n = self.n_shards
        if self.local_cfg.variant == "swbf" and event_capacity is None:
            if self.scfg.elastic:
                event_capacity = self.scfg.bucket_capacity(local_batch, n)
            elif self.scfg.pipeline and self._compactable:
                event_capacity = self.scfg.step_width(local_batch, n)
            else:
                event_capacity = n * self.scfg.capacity(local_batch, n)
        base = init_state(self.local_cfg, seed, device=self.device,
                          event_capacity=event_capacity)
        if self.scfg.elastic:
            # bucket g in slot (g // b_r, g % b_r); its rng folded on g
            ids = torch.arange(self.me * self.b_r, (self.me + 1) * self.b_r,
                               device=self.device)
            lead, rng = (1, self.b_r), prng.fold_in(base.rng, ids)[None]
        else:
            ids = torch.tensor([self.me], device=self.device)
            lead, rng = (1,), prng.fold_in(base.rng, ids)

        def stack(x):
            return x.expand(*lead, *x.shape).clone()

        ring = base.ring
        if ring is not None:
            ring = WindowRing(stack(ring.events), stack(ring.slot))
        return FilterState(
            bits=stack(base.bits),
            position=torch.ones(lead, dtype=torch.int32, device=self.device),
            load=stack(base.load), rng=rng, ring=ring,
            router=(init_router(self.scfg.n_buckets, n, self.device)
                    if self.scfg.elastic else None))

    def gather_state(self, state: FilterState) -> FilterState:
        """Every rank's slab stacked in rank order — the reference's global
        (n_shards, ...) layout — with the replicated router. A collective:
        every rank calls it."""
        core = tree_map(self._gather, state._replace(router=None))
        router = (None if state.router is None
                  else RouterState(*(x.clone() for x in state.router)))
        return core._replace(router=router)

    def local_state(self, global_state: FilterState) -> FilterState:
        """This rank's slab of a global (n_shards, ...) state (from
        ``gather_state``, a checkpoint or ``migrate_sharded_state``), as
        fresh tensors on this rank's device."""
        me = self.me
        core = tree_map(lambda x: x[me:me + 1].to(self.device).clone(),
                         global_state._replace(router=None))
        router = (None if global_state.router is None else RouterState(
            *(x.to(self.device).clone() for x in global_state.router)))
        return core._replace(router=router)

    # ------------------------------------------------------ collectives //
    def _a2a(self, x: torch.Tensor, async_op: bool = False):
        """``all_to_all_single`` over the leading (destination) axis ->
        (received tensor, work handle or None)."""
        x = x.contiguous()
        out = torch.empty_like(x)
        work = dist.all_to_all_single(out, x, group=self.group,
                                      async_op=async_op)
        return out, work

    def _gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated in rank order along axis 0 (a
        0-d ``x`` gives (n_shards,)); bool travels as uint8."""
        flag = x.dtype == torch.bool
        if flag:
            x = x.to(torch.uint8)
        if x.dim() == 0:
            x = x.reshape(1)
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        dist.all_gather(parts, x.contiguous(), group=self.group)
        out = torch.cat(parts)
        return out.bool() if flag else out

    # ------------------------------------------------------- the steps //
    def _step_rows(self, st: FilterState, keys: torch.Tensor,
                   valid: torch.Tensor) -> Tuple[FilterState, torch.Tensor]:
        """The batched step over stacked rows: ``st`` leaves (n, ...), keys
        and valid (n, W) -> (state, dup (n, W)). One fleet-step call over
        the tenant axis; dense8 sbf row by row."""
        keys, valid = keys.contiguous(), valid.contiguous()
        if self._fleet_step is not None:
            new, res = self._fleet_step(st, keys, valid, self._tp)
            return new, res.dup
        outs = [self._row_step(FilterState(st.bits[i], st.position[i],
                                           st.load[i], st.rng[i]),
                               keys[i], valid[i])
                for i in range(keys.shape[0])]
        return (FilterState(st.bits, *(torch.stack([getattr(s, f)
                                                    for s, _ in outs])
                                       for f in ("position", "load", "rng"))),
                torch.stack([r.dup for _, r in outs]))

    def _route_static(self, keys, valid, cap):
        """Each lane's owner and window position; lanes past ``cap`` (and
        invalid lanes) are dropped to row n_shards."""
        n = self.n_shards
        owner = route_hash(keys, n, self.local_cfg.seed).to(torch.int64)
        onehot = valid[:, None] & (owner[:, None] == torch.arange(
            n, device=keys.device))
        pos_in = torch.cumsum(onehot, dim=0) - 1                # (lb, S)
        my_pos = pos_in.gather(1, owner[:, None])[:, 0]
        keep = valid & (my_pos < cap)
        overflow = (valid & ~keep).sum(dtype=torch.int32)
        o = torch.where(keep, owner, n)
        p = torch.where(keep, my_pos, 0)
        return onehot, o, p, keep, overflow

    def _home(self, back, fl_o, fl_p, keep, fl_sl=None):
        """The verdicts returned to their home lanes; dropped lanes are
        reported distinct."""
        o = fl_o.clamp(max=self.n_shards - 1)
        idx = (o, fl_p) if fl_sl is None else (o, fl_sl, fl_p)
        return back.bool()[idx] & keep

    def _static_serial(self, state, keys, valid, local_batch):
        """The serial static body: route -> exchange keys and valid masks
        -> the local step -> verdicts home."""
        n = self.n_shards
        cap = self.scfg.capacity(local_batch, n)
        _, o, p, keep, overflow = self._route_static(keys, valid, cap)
        send_keys = _drop_scatter((n, cap), (o, p), keys, 0)
        send_valid = _drop_scatter((n, cap), (o, p),
                                   torch.ones_like(keys, dtype=torch.uint8),
                                   0)
        rk, _ = self._a2a(send_keys)
        rv, _ = self._a2a(send_valid)
        state, dup_c = self._step_rows(state, rk.reshape(1, -1),
                                       rv.bool().reshape(1, -1))
        back, _ = self._a2a(dup_c.reshape(n, cap).to(torch.uint8))
        return state, self._home(back, o, p, keep), overflow

    def _static_dispatch(self, state, keys, valid, local_batch) -> InFlight:
        """Pipelined static dispatch: route, then start the exchange of the
        key windows and the per-destination counts. Windows are valid
        prefixes by construction, so counts stand in for the masks."""
        del state                        # static routing reads no state
        n = self.n_shards
        cap = self.scfg.capacity(local_batch, n)
        onehot, o, p, keep, overflow = self._route_static(keys, valid, cap)
        send_keys = _drop_scatter((n, cap), (o, p), keys, 0)
        send_cnt = (onehot & keep[:, None]).sum(dim=0, dtype=torch.int32)
        rk, w1 = self._a2a(send_keys, async_op=True)
        rc, w2 = self._a2a(send_cnt, async_op=True)
        return InFlight(rk, rc, o, None, p, keep, overflow, (w1, w2))

    def _static_consume(self, state, fl: InFlight, local_batch):
        """The owner's (possibly compacted) step on a dispatched batch, then
        the verdicts home."""
        n = self.n_shards
        cap = self.scfg.capacity(local_batch, n)
        flat = n * cap
        t_width = (self.scfg.step_width(local_batch, n)
                   if self._compactable else flat)
        fl.wait()
        rk, cnt = fl.keys, fl.cnt
        lanes = torch.arange(cap, device=rk.device)[None, :]
        vmask = lanes < cnt[:, None]                            # (S, C)
        rank_overflow = torch.zeros((), dtype=torch.int32, device=rk.device)
        if t_width < flat:
            # owner-side compaction: a lane's rank = the lanes before it
            rankm = (torch.cumsum(cnt, 0) - cnt)[:, None] + lanes
            ok = vmask & (rankm < t_width)
            rank_overflow = (vmask & ~ok).sum(dtype=torch.int32)
            tgt = torch.where(ok, rankm, t_width).to(torch.int64)
            ck = _drop_scatter((t_width,), (tgt.reshape(-1),),
                               rk.reshape(-1), 0)
            cvalid = (torch.arange(t_width, device=rk.device)
                      < cnt.sum().clamp(max=t_width))
            state, dup_c = self._step_rows(state, ck[None], cvalid[None])
            dup_buf = dup_c[0][rankm.clamp(max=t_width - 1)] & ok
        else:
            state, dup_c = self._step_rows(state, rk.reshape(1, -1),
                                           vmask.reshape(1, -1))
            dup_buf = dup_c.reshape(n, cap)
        back, _ = self._a2a(dup_buf.to(torch.uint8))
        return (state, self._home(back, fl.o, fl.p, fl.keep),
                fl.ovf + rank_overflow, False)

    # ------------------------------------------------ elastic path (§4.4) //
    @staticmethod
    def _slot_tables(assign: torch.Tensor, n_shards: int, b_r: int):
        """The two routing views of a bucket -> shard table: ``slot_of[g]``
        — bucket g's slot within its owner (its rank among the owner's
        buckets in bucket-id order) — and ``slots[j, i]`` — the bucket
        shard j holds in slot i."""
        nb = assign.shape[0]
        order = torch.arange(nb, dtype=torch.int32, device=assign.device)
        before = ((assign[None, :] == assign[:, None])
                  & (order[None, :] < order[:, None]))
        slot_of = before.sum(dim=1, dtype=torch.int32)
        slots = torch.zeros((n_shards, b_r), dtype=torch.int32,
                            device=assign.device)
        slots.index_put_((assign.to(torch.int64), slot_of.to(torch.int64)),
                         order)
        return slot_of, slots

    @staticmethod
    def _lpt_assign(bucket_load: torch.Tensor, n_shards: int, b_r: int
                    ) -> torch.Tensor:
        """Greedy longest-processing-time re-pack: buckets in descending
        load order (a stable sort), each to the least-loaded shard with a
        free slot (lowest index on a tie), so every shard keeps exactly b_r
        buckets. A pure function of the replicated load vector: every rank
        computes the same table. -> (nb,) int32 owners."""
        load = bucket_load.cpu().numpy().astype(np.int32)
        order = torch.argsort(-bucket_load.cpu(), stable=True).numpy()
        sload = np.zeros((n_shards,), np.int32)
        scount = np.zeros((n_shards,), np.int32)
        owners = np.zeros(load.shape, np.int32)
        for g in order:
            j = int(np.argmin(np.where(scount >= b_r, _INT32_MAX, sload)))
            sload[j] += load[g]
            scount[j] += 1
            owners[g] = j
        return torch.from_numpy(owners)

    def _monitor(self, slab: FilterState, router: RouterState):
        """The per-batch load monitor and bucket re-partition (§4.4):
        (slot state, router) -> (maybe permuted state, router, fired). A
        no-op when ``rebalance_threshold`` is 0.

        The reference decides the trigger on the device and gates the ring
        under ``lax.cond``. Here the all-reduced bucket loads (nb int32)
        and the table are read on the host once per batch — only when the
        threshold is set — and the trigger, its three conditions and the
        LPT re-pack are decided there, bit for bit as in jnp (float32
        ratio, stable order, lowest-index ties). That read is a host sync
        per batch, which a captured step (ROADMAP item 4b) has to move."""
        if self._threshold <= 0.0:
            return slab, router, False
        n, b_r, nb = self.n_shards, self.b_r, self.scfg.n_buckets
        _, slots = self._slot_tables(router.assign, n, b_r)
        my_ids = slots[self.me]
        contrib = torch.zeros((nb,), dtype=torch.int32, device=self.device)
        contrib.index_put_((my_ids.to(torch.int64),),
                           slab.load.sum(dim=-1, dtype=torch.int32))
        dist.all_reduce(contrib, group=self.group)
        host = torch.cat([contrib, router.assign]).cpu().numpy()
        bucket_load, assign = host[:nb], host[nb:]
        shard_load = np.zeros((n,), np.int32)
        np.add.at(shard_load, assign, bucket_load)
        total = shard_load.sum(dtype=np.int32)
        ratio = (np.float32(shard_load.max()) * np.float32(n)
                 / np.float32(max(int(total), 1)))
        repacked = self._lpt_assign(torch.from_numpy(bucket_load), n, b_r)
        repacked_load = np.zeros((n,), np.int32)
        np.add.at(repacked_load, repacked.numpy(), bucket_load)
        # fire only when the re-pack STRICTLY lowers the max shard load: a
        # skew the packing cannot improve must not permute every batch
        trigger = (ratio > np.float32(self._threshold) and total > 0
                   and repacked_load.max() < shard_load.max())
        if not trigger:
            return slab, router, False
        new_assign = repacked.to(self.device)
        _, new_slots = self._slot_tables(new_assign, n, b_r)
        slab = rebalance_collect(slab, my_ids, new_slots[self.me], self.group,
                                 n)
        return slab, RouterState(new_assign, router.n_rebalances + 1), True

    def _route_elastic(self, state, keys, valid, cap):
        """Each lane's bucket, owner, slot and window position under the
        current table; lanes past ``cap`` per (bucket, source) drop."""
        n, nb = self.n_shards, self.scfg.n_buckets
        assign = state.router.assign
        slot_of, _ = self._slot_tables(assign, n, self.b_r)
        bucket = range_bucket(keys, nb).to(torch.int64)
        onehot = valid[:, None] & (bucket[:, None] == torch.arange(
            nb, device=keys.device))
        pos_in = torch.cumsum(onehot, dim=0) - 1                # (lb, nb)
        my_pos = pos_in.gather(1, bucket[:, None])[:, 0]
        keep = valid & (my_pos < cap)
        overflow = (valid & ~keep).sum(dtype=torch.int32)
        o = torch.where(keep, assign[bucket].to(torch.int64), n)
        sl = torch.where(keep, slot_of[bucket].to(torch.int64), 0)
        p = torch.where(keep, my_pos, 0)
        return onehot, o, sl, p, keep, overflow, assign, slot_of

    def _elastic_widths(self, local_batch):
        t_width = self.scfg.bucket_capacity(local_batch, self.n_shards)
        return t_width, -(-t_width // self.n_shards)   # T, (bucket, source)

    def _elastic_finish(self, state, slab, dup_c, rank, ok, fl_o, fl_sl,
                        fl_p, keep):
        """Shared tail of both elastic bodies: each received lane's verdict
        — ``rank`` and ``ok`` (S, b_r, C) — picked from its slot row at its
        rank, sent home, then the monitor."""
        t_width = dup_c.shape[-1]
        rows = torch.arange(self.b_r, device=dup_c.device)[None, :, None]
        dup_sel = dup_c[rows, rank.clamp(max=t_width - 1)] & ok
        back, _ = self._a2a(dup_sel.to(torch.uint8))
        dup = self._home(back, fl_o, fl_p, keep, fl_sl)
        slab, router, fired = self._monitor(slab, state.router)
        out = tree_map(lambda x: x[None], slab)
        return out._replace(router=router), dup, fired

    def _slab(self, state):
        return tree_map(lambda x: x[0], state._replace(router=None))

    def _elastic_serial(self, state, keys, valid, local_batch):
        """The serial elastic body: range-route -> per-(bucket, source)
        windows with stream-order tags -> exchange -> tag-ordered
        compaction to the bucket width -> one step over the slot rows ->
        verdicts home -> monitor."""
        n, b_r = self.n_shards, self.b_r
        t_width, cap = self._elastic_widths(local_batch)
        _, o, sl, p, keep, src_overflow, _, _ = self._route_elastic(
            state, keys, valid, cap)
        b = keys.shape[0]
        tag = self.me * b + torch.arange(b, dtype=torch.int32,
                                         device=keys.device)
        shape = (n, b_r, cap)
        idx = (o, sl, p)
        recv_keys, recv_tags, recv_valid = (
            self._a2a(_drop_scatter(shape, idx, v, fill))[0]
            for v, fill in ((keys, 0), (tag, _INT32_MAX),
                            (torch.ones_like(keys, dtype=torch.uint8), 0)))
        rv3 = recv_valid.bool()
        rk = recv_keys.transpose(0, 1).reshape(b_r, -1)
        rt = torch.where(rv3, recv_tags, _INT32_MAX).transpose(0, 1).reshape(
            b_r, -1)
        rv = rv3.transpose(0, 1).reshape(b_r, -1)
        rank = torch.searchsorted(torch.sort(rt, dim=-1).values, rt)
        ok = rv & (rank < t_width)
        rank_overflow = (rv & ~ok).sum(dtype=torch.int32)
        tgt = torch.where(ok, rank, t_width)
        ck = torch.zeros((b_r, t_width + 1), dtype=torch.int32,
                         device=keys.device).scatter_(1, tgt, rk)
        n_val = ok.sum(dim=-1).clamp(max=t_width)
        cvalid = (torch.arange(t_width, device=keys.device)[None, :]
                  < n_val[:, None])
        slab, dup_c = self._step_rows(self._slab(state), ck[:, :t_width],
                                      cvalid)

        def by_source(x):                        # (b_r, S·C) -> (S, b_r, C)
            return x.reshape(b_r, n, cap).transpose(0, 1)

        state, dup, _ = self._elastic_finish(
            state, slab, dup_c, by_source(rank), by_source(ok), o, sl, p,
            keep)
        return state, dup, src_overflow + rank_overflow

    def _elastic_dispatch(self, state, keys, valid, local_batch) -> InFlight:
        """Pipelined elastic dispatch: the key windows and per-(dest, slot)
        counts, exchanged asynchronously. Tags are source-major with
        in-source arrival order by construction, so counts replace the
        tags, the masks and the per-slot sort."""
        n, b_r = self.n_shards, self.b_r
        _, cap = self._elastic_widths(local_batch)
        onehot, o, sl, p, keep, overflow, assign, slot_of = \
            self._route_elastic(state, keys, valid, cap)
        send_keys = _drop_scatter((n, b_r, cap), (o, sl, p), keys, 0)
        send_cnt = torch.zeros((n, b_r), dtype=torch.int32,
                               device=keys.device)
        send_cnt.index_put_(
            (assign.to(torch.int64), slot_of.to(torch.int64)),
            (onehot & keep[:, None]).sum(dim=0, dtype=torch.int32))
        rk, w1 = self._a2a(send_keys, async_op=True)
        rc, w2 = self._a2a(send_cnt, async_op=True)
        return InFlight(rk, rc, o, sl, p, keep, overflow, (w1, w2))

    def _elastic_consume(self, state, fl: InFlight, local_batch):
        """Compaction by the exclusive cumsum of the shipped counts (a
        lane's rank = valid lanes of earlier sources + its own position),
        the slot-row step, verdicts home, monitor. -> (state, dup, ovf,
        fired)."""
        b_r = self.b_r
        t_width, cap = self._elastic_widths(local_batch)
        fl.wait()
        rk, cnt = fl.keys, fl.cnt                     # (S, b_r, C) / (S, b_r)
        lanes = torch.arange(cap, device=rk.device)
        vmask = lanes < cnt[..., None]
        rankm = (torch.cumsum(cnt, 0) - cnt)[..., None] + lanes
        ok = vmask & (rankm < t_width)
        rank_overflow = (vmask & ~ok).sum(dtype=torch.int32)
        tgt = torch.where(ok, rankm, t_width).to(torch.int64)
        rows3 = torch.arange(b_r, device=rk.device)[None, :, None].expand(
            tgt.shape)
        ck = torch.zeros((b_r, t_width + 1), dtype=torch.int32,
                         device=rk.device)
        ck.index_put_((rows3, tgt), rk)
        n_val = cnt.sum(dim=0).clamp(max=t_width)
        cvalid = (torch.arange(t_width, device=rk.device)[None, :]
                  < n_val[:, None])
        slab, dup_c = self._step_rows(self._slab(state), ck[:, :t_width],
                                      cvalid)
        state, dup, fired = self._elastic_finish(
            state, slab, dup_c, rankm, ok, fl.o, fl.sl, fl.p, fl.keep)
        return state, dup, fl.ovf + rank_overflow, fired

    # ------------------------------------------------------ entry points //
    def _bodies(self):
        """(serial, dispatch, consume) of this service's routing mode."""
        if self.scfg.elastic:
            return (self._elastic_serial, self._elastic_dispatch,
                    self._elastic_consume)
        return (self._static_serial, self._static_dispatch,
                self._static_consume)

    def _mine(self, kb: torch.Tensor) -> torch.Tensor:
        """This rank's columns of (n_batches, global batch) rows."""
        lb = kb.shape[-1] // self.n_shards
        return kb[..., self.me * lb:(self.me + 1) * lb]

    def local_step(self, local_batch: int):
        """This rank's part of one global batch: (state, this rank's
        ``local_batch`` keys as int32 words, all valid) -> (state, the
        verdicts of those keys, this rank's () overflow) — the fused
        dispatch + consume of the pipelined protocol when
        ``pipeline=True``, else the serial body; the reference's
        shard-mapped body. The caller's state is left as it was."""
        serial, dispatch, consume = self._bodies()

        def step(state: FilterState, mine: torch.Tensor):
            valid = torch.ones(mine.shape, dtype=torch.bool,
                               device=mine.device)
            state = state._replace(bits=state.bits.clone())
            if self.scfg.pipeline:
                state, dup, ovf, _ = consume(
                    state, dispatch(state, mine, valid, local_batch),
                    local_batch)
            else:
                state, dup, ovf = serial(state, mine, valid, local_batch)
            return state, dup, ovf

        return step

    def make_step(self, local_batch: int):
        """A (state, keys) -> (state, dup, overflow) step for one global
        batch of ``local_batch * n_shards`` keys, all valid:
        ``local_step`` on this rank's columns, its verdicts and overflow
        gathered (so it equals ``run_stream`` on a shared ``init()``).
        Every rank passes the same global batch; it returns the global
        (B,) verdicts and the (n_shards,) overflow."""
        body = self.local_step(local_batch)

        def step(state: FilterState, keys):
            keys = u32.as_words(keys, self.device)
            if keys.shape[0] != local_batch * self.n_shards:
                raise ValueError(
                    f"step built for {local_batch} keys per rank takes a "
                    f"global batch of {local_batch * self.n_shards}, got "
                    f"{keys.shape[0]}")
            state, dup, ovf = body(state, self._mine(keys))
            return state, self._gather(dup), self._gather(ovf)

        return step

    def run_stream(self, state: FilterState, keys
                   ) -> Tuple[FilterState, torch.Tensor, torch.Tensor]:
        """A whole (N,) global stream, every rank passing the same keys:
        the tail padded with invalid lanes, (n_batches, batch_size) global
        batches. Returns (state, dup (N,) bool, overflow (n_batches,
        n_shards) int32), all on the device. This rank's slab is updated in
        place: thread the returned state, not the argument."""
        b = self.scfg.base.batch_size
        if b % self.n_shards:
            raise ValueError(
                f"batch_size {b} must divide by n_shards {self.n_shards}")
        lb = b // self.n_shards
        keys = u32.as_words(keys, self.device)
        n = int(keys.shape[0])
        n_pad = (-n) % b
        kb = self._mine(torch.nn.functional.pad(keys, (0, n_pad)).view(-1, b))
        vb = self._mine((torch.arange(n + n_pad, device=self.device) < n)
                        .view(-1, b))
        nbat = kb.shape[0]
        dups = torch.zeros((nbat, lb), dtype=torch.bool, device=self.device)
        ovfs = torch.zeros((nbat,), dtype=torch.int32, device=self.device)
        self._stream_shapes.add((lb, self.scfg.pipeline, nbat))
        serial, dispatch, consume = self._bodies()
        if self.scfg.pipeline and nbat:
            fl = dispatch(state, kb[0], vb[0], lb)
            for t in range(nbat):
                # batch t+1's exchange runs while batch t steps; a
                # rebalance during batch t re-routes it (all ranks agree)
                nxt = (dispatch(state, kb[t + 1], vb[t + 1], lb)
                       if t + 1 < nbat else None)
                state, dups[t], ovfs[t], fired = consume(state, fl, lb)
                if fired and nxt is not None:
                    nxt.wait()
                    nxt = dispatch(state, kb[t + 1], vb[t + 1], lb)
                fl = nxt
        else:
            for t in range(nbat):
                state, dups[t], ovfs[t] = serial(state, kb[t], vb[t], lb)
        dup = self._gather(dups[None]).transpose(0, 1).reshape(-1)[:n]
        return state, dup, self._gather(ovfs[None]).transpose(0, 1)

    def run_tenant_stream(self, state: FilterState, keys, tenant
                          ) -> Tuple[FilterState, torch.Tensor, torch.Tensor]:
        """A sharded TENANT FLEET (DESIGN §4.6): the elastic path with one
        router bucket per tenant. The tenant id rides the top log2(T) bits
        of the tagged key (``core.fleet.tenant_tagged_keys``), so
        ``range_bucket(tagged, T)`` is the tenant: every bucket is one
        tenant's self-contained sub-filter, and the monitor moves tenants
        between ranks whole. Requires ``rebalance_buckets == n_tenants``
        (> 1)."""
        t = self.scfg.base.n_tenants
        if t <= 1 or not self.scfg.elastic or self.scfg.n_buckets != t:
            raise ValueError(
                f"run_tenant_stream needs the elastic path with one bucket "
                f"per tenant: set rebalance_buckets == n_tenants (> 1); got "
                f"n_tenants={t}, rebalance_buckets={self.scfg.n_buckets} "
                f"(DESIGN §4.6)")
        tagged = tenant_tagged_keys(
            u32.as_words(keys, self.device),
            torch.as_tensor(tenant, device=self.device).to(torch.int32), t)
        return self.run_stream(state, tagged)

    def stream_cache_size(self) -> int:
        """Distinct stream shapes (rank batch, pipelining, batches) seen by
        ``run_stream`` — the reference counts its compiled stream scans;
        nothing is compiled here."""
        return len(self._stream_shapes)
