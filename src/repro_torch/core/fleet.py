"""Multi-tenant filter fleets — the port of ``repro.core.fleet`` (DESIGN
§4.6): T logical filters, one launch of each kernel per step.

* **Stacked state** — ``init_fleet_state`` broadcasts one ``init_state``
  template to a leading (T, ...) axis and folds each tenant's rng on its
  tenant id (``prng.fold_in``), so tenant t's randomness is independent of
  every other tenant's traffic.
* **One launch** — a mixed batch of (key, tenant) lanes is routed to
  per-tenant slot rows of a fixed width C (a sort-based arrival rank,
  ``tenant_rank``) and the whole (T, C) grid steps at once: the threefry
  draws over the (T, 2) keys in one broadcast evaluation, and the bitset
  kernel (hashing the T·C slot keys itself) or hashmix and the counter
  kernel, with the tenant as a grid axis
  (``core.batched.make_templated_step(params_aware=True)``). A bitset
  fleet on the dense8 layout (the reference's default) is the dense8 step
  with the tenant axis written out: one hashmix launch over the T·C slot
  keys, then gathers and scatters over the (T, k, s) cells; counter-family
  fleets run on the plane layout only, as in the reference.
* **Per-tenant knobs** — ``TenantParams`` stacks the value-like config
  (sbf Max, cms/hh threshold, swbf window, admission capacity) as (T,)
  int32 rows on the device; everything that shapes the state stays
  fleet-wide.

Isolation: tenant t's verdicts depend only on its own lanes. A step hands
tenant t the valid prefix of its slot row at width C, which is what
``Dedup.process_padded(width=C)`` sees from the same lanes with the same
tenant-folded rng. Lanes beyond a tenant's per-step capacity are reported
distinct and counted in ``FleetResult.overflow``.

Routing never waits on the host: the slot scatter is an ``index_put_``
into a (T + 1, C) buffer whose spare row takes the overflow lanes and is
then sliced off, and ``overflow`` stays a device tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import prng, u32
from .batched import TenantStepParams, make_templated_step
from .config import DedupConfig
from .device import resolve_device
from .state import FilterState, WindowRing, init_state


class TenantParams(NamedTuple):
    """Fleet-level per-tenant knobs, (T,) int32 rows (DESIGN §4.6).
    ``max_value`` / ``threshold`` / ``window`` reach the step as
    ``TenantStepParams``; ``capacity`` is the routing layer's per-step
    admission cap (at most the slot width C). ``validate_params`` checks
    them against the fleet config."""
    max_value: torch.Tensor      # (T,) — sbf set-to-Max ceiling
    threshold: torch.Tensor      # (T,) — cms/hh verdict threshold
    window: torch.Tensor         # (T,) — swbf effective window (batches)
    capacity: torch.Tensor       # (T,) — per-step admission cap


class FleetResult(NamedTuple):
    """One mixed batch's verdicts, in arrival order. ``routed`` is False
    for invalid lanes and for lanes beyond their tenant's capacity; those
    are reported distinct (dup False) and counted in ``overflow``."""
    dup: torch.Tensor            # (B,) bool
    routed: torch.Tensor         # (B,) bool
    overflow: torch.Tensor       # () int32


def default_tenant_params(cfg: DedupConfig, capacity: int,
                          device=None) -> TenantParams:
    """Every tenant at the fleet config's values — the homogeneous fleet."""
    device = resolve_device(device)
    t = cfg.n_tenants

    def full(v):
        return torch.full((t,), v, dtype=torch.int32, device=device)

    return TenantParams(max_value=full(cfg.sbf_max),
                        threshold=full(cfg.count_threshold),
                        window=full(max(cfg.window, 1)),
                        capacity=full(capacity))


def validate_params(cfg: DedupConfig, params: TenantParams, capacity: int,
                    device=None) -> TenantParams:
    """Host-side checks of the per-tenant rows against the fleet's fixed
    shapes (DESIGN §4.6), with the reference's messages: a tenant's Max
    must keep the plane count d (the bit_length of ``cfg.sbf_max``), its
    window must fit the fleet ring, its threshold must be reachable below
    cell saturation, and no admission cap may exceed the slot width C.
    Returns the rows as int32 tensors on ``device``."""
    device = resolve_device(device)
    t = cfg.n_tenants
    rows = {name: np.asarray(torch.as_tensor(v).cpu()) for name, v in
            params._asdict().items()}
    for name, arr in rows.items():
        if tuple(np.shape(arr)) != (t,):
            raise ValueError(
                f"TenantParams.{name} must have shape ({t},) for "
                f"n_tenants={t}; got {tuple(np.shape(arr))}")
    mv = rows["max_value"]
    if cfg.variant == "sbf":
        want_d = cfg.sbf_max.bit_length()
        if any(int(v) < 1 or int(v).bit_length() != want_d for v in mv):
            raise ValueError(
                f"per-tenant max_value must keep the fleet's plane count: "
                f"every value needs bit_length {want_d} (like "
                f"sbf_max={cfg.sbf_max}); got {mv.tolist()}")
    wv = rows["window"]
    if cfg.variant == "swbf" and ((wv < 1) | (wv > cfg.window)).any():
        raise ValueError(
            f"per-tenant window must lie in [1, {cfg.window}] — the fleet "
            f"ring has cfg.window={cfg.window} slots; got {wv.tolist()}")
    tv = rows["threshold"]
    cap_cell = (1 << cfg.bits_per_cell) - 1
    if ((tv < 1) | (tv > cap_cell)).any():
        raise ValueError(
            f"per-tenant threshold must lie in [1, {cap_cell}] (cells "
            f"saturate at 2^d - 1); got {tv.tolist()}")
    cv = rows["capacity"]
    if ((cv < 1) | (cv > capacity)).any():
        raise ValueError(
            f"per-tenant capacity must lie in [1, {capacity}] — the fleet "
            f"slot width C is {capacity}; got {cv.tolist()}")
    return TenantParams(*(torch.from_numpy(rows[name].astype(np.int32))
                          .to(device) for name in TenantParams._fields))


def init_fleet_state(cfg: DedupConfig, seed: int | None = None,
                     event_capacity: int | None = None, device=None
                     ) -> FilterState:
    """Stacked (T, ...) fleet state on ``device`` (``cuda`` unless the
    caller passes ``"cpu"``): one ``init_state`` template repeated over the
    tenant axis, tenant t's rng ``fold_in(key, t)`` — the elastic path's
    bucket-id fold (DESIGN §4.4), so randomness travels with the tenant."""
    device = resolve_device(device)
    t = cfg.n_tenants
    base = init_state(cfg, seed, device=device,
                      event_capacity=(event_capacity if cfg.variant == "swbf"
                                      else None))

    def stack(x):
        return x[None].repeat(t, *([1] * x.dim()))

    ring = base.ring
    if ring is not None:
        ring = WindowRing(stack(ring.events), stack(ring.slot))
    return FilterState(
        bits=stack(base.bits),
        position=torch.ones((t,), dtype=torch.int32, device=device),
        load=stack(base.load),
        rng=prng.fold_in(base.rng, torch.arange(t, device=device)),
        ring=ring,
    )


def tenant_rank(tenant: torch.Tensor, valid: torch.Tensor, n_tenants: int
                ) -> torch.Tensor:
    """Arrival rank of each lane within its tenant: the number of earlier
    valid lanes with the same tenant id. One sort of the (tenant-major,
    lane-minor) composite key and two binary searches, O(B log B) in the
    batch and independent of T. The composite is the reference's uint32
    ``(tenant << lb) | lane`` held in int64 (torch has no uint32 ``<<``
    or ``<``), with the reference's overflow guard. Invalid lanes park at
    the sentinel and get an unused rank. -> (B,) int32."""
    b = tenant.shape[0]
    lb = max(1, (b - 1).bit_length())
    if n_tenants >= (1 << (32 - lb)):
        raise ValueError(
            f"tenant_rank composite key overflow: n_tenants {n_tenants} "
            f"needs more than {32 - lb} bits next to a batch of {b}")
    lane = torch.arange(b, dtype=torch.int64, device=tenant.device)
    ten = (tenant.to(torch.int64) & u32.MASK) << lb
    comp = torch.where(valid, (ten | lane) & u32.MASK, u32.MASK)
    sc = torch.sort(comp).values
    base = torch.searchsorted(sc, ten & u32.MASK)
    mine = torch.searchsorted(sc, comp)
    return (mine - base).to(torch.int32)


def tenant_tagged_keys(keys: torch.Tensor, tenant: torch.Tensor,
                       n_tenants: int) -> torch.Tensor:
    """The tenant id in the top log2(T) bits of the 32-bit key, as int32
    words — the sharded fleet's routing encoding (DESIGN §4.6): a range
    bucket over T recovers the tenant. Injective while keys use fewer than
    32 - log2(T) bits."""
    if n_tenants <= 1:
        return u32.to_i32(u32.to_u64(keys))
    tb = (n_tenants - 1).bit_length()
    mask = (1 << (32 - tb)) - 1
    return u32.to_i32((u32.to_u64(tenant) << (32 - tb))
                      | (u32.to_u64(keys) & mask))


class FleetDedup:
    """The multi-tenant engine (DESIGN §4.6): ``Dedup``'s contract with a
    tenant lane per element. It runs on ``cuda`` unless the caller passes
    ``device="cpu"``, and raises without a card; ``partitionable`` picks
    JAX's threefry counter layout, as for ``Dedup``. ``process`` leaves
    the caller's state as it was; ``run_stream`` updates it in place.
    ``process_cache_size`` / ``stream_cache_size`` count the distinct
    batch widths and stream shapes seen (nothing is compiled per width)."""

    def __init__(self, cfg: DedupConfig, capacity: int | None = None,
                 params: Optional[TenantParams] = None, device=None, *,
                 partitionable: bool = True):
        cfg = cfg.validate()
        self.cfg = cfg
        self.device = resolve_device(device)
        self.n_tenants = cfg.n_tenants
        if capacity is None:
            # Poisson traffic concentrates: the sharded capacity_factor = 2
            # sizing per tenant, floor 8 (DESIGN §4.2)
            capacity = max(8, -(-2 * cfg.batch_size // self.n_tenants))
        self.capacity = int(capacity)
        if params is None:
            params = default_tenant_params(cfg, self.capacity, self.device)
        self.params = validate_params(cfg, params, self.capacity,
                                      self.device)
        if cfg.is_counter and not cfg.is_planes:
            raise ValueError(
                "tenant fleets run the counter family on the plane layout "
                "only — the dense8 sbf branch is the single-filter "
                "reference, not a template instance (DESIGN §4.6); use "
                "layout='planes'")
        self._step = make_templated_step(cfg, device=self.device,
                                         partitionable=partitionable,
                                         params_aware=True)
        self._step_params = TenantStepParams(
            max_value=self.params.max_value,
            threshold=self.params.threshold, window=self.params.window)
        self._widths: set = set()
        self._stream_shapes: set = set()

    # ------------------------------------------------------------------ //
    def init(self, seed: int | None = None) -> FilterState:
        """Stacked (T, ...) state; swbf's ring takes one step's whole slot
        row (C elements) per slot."""
        return init_fleet_state(self.cfg, seed, event_capacity=self.capacity,
                                device=self.device)

    def route(self, keys: torch.Tensor, tenant: torch.Tensor,
              valid: torch.Tensor):
        """A mixed batch's lanes -> their slots: (slot_keys (T, C), slot_valid
        (T, C), keep (B,), tenant row (B,), slot (B,), overflow ()). A lane
        is kept when valid and its arrival rank is below its tenant's
        capacity; the others go to a spare row T that is sliced off (the
        reference's ``mode="drop"``), with no host sync."""
        t, cap = self.n_tenants, self.capacity
        rank = tenant_rank(tenant, valid, t).to(torch.int64)
        ten = tenant.to(torch.int64)
        cap_lane = self.params.capacity[ten.clamp(0, t - 1)]
        keep = valid & (rank < cap_lane)
        overflow = (valid & ~keep).sum(dtype=torch.int32)
        tt = torch.where(keep, ten, t)
        rr = torch.where(keep, rank, 0)
        slot_keys = torch.zeros((t + 1, cap), dtype=torch.int32,
                                device=keys.device)
        slot_keys.index_put_((tt, rr), keys)
        slot_valid = torch.zeros((t + 1, cap), dtype=torch.bool,
                                 device=keys.device)
        slot_valid.index_put_((tt, rr), keep)
        return slot_keys[:t], slot_valid[:t], keep, tt, rr, overflow

    def _fleet_step(self, state: FilterState, keys: torch.Tensor,
                    tenant: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[FilterState, FleetResult]:
        slot_keys, slot_valid, keep, tt, rr, overflow = self.route(
            keys, tenant, valid)
        state, res = self._step(state, slot_keys, slot_valid,
                                self._step_params)
        dup = res.dup[tt.clamp(max=self.n_tenants - 1), rr] & keep
        return state, FleetResult(dup=dup, routed=keep, overflow=overflow)

    def _lanes(self, keys, tenant, valid=None):
        keys = u32.as_words(keys, self.device)
        tenant = torch.as_tensor(tenant, device=self.device).to(torch.int32)
        if valid is None:
            valid = torch.ones(keys.shape, dtype=torch.bool,
                               device=self.device)
        else:
            valid = torch.as_tensor(valid, device=self.device).to(torch.bool)
        return keys, tenant, valid

    def process(self, state: FilterState, keys, tenant, valid=None, *,
                donate: bool = False) -> Tuple[FilterState, FleetResult]:
        """One mixed batch through the whole fleet: T logical filters, one
        launch of each kernel. ``tenant`` (B,) ints in [0, T); keys,
        tenants and valid may be host arrays. The caller's state is left as
        it was, unless ``donate=True``: then the filters are updated in
        place (the serving front-end threads its state, DESIGN §5.2)."""
        keys, tenant, valid = self._lanes(keys, tenant, valid)
        self._widths.add(int(keys.shape[0]))
        if not donate:
            state = state._replace(bits=state.bits.clone())
        return self._fleet_step(state, keys, tenant, valid)

    def run_stream(self, state: FilterState, keys, tenant
                   ) -> Tuple[FilterState, torch.Tensor, torch.Tensor]:
        """A whole (N,) mixed stream, tail padded with invalid lanes. The
        input state's filters are updated in place. Returns (state, dup
        (N,) bool, per-batch overflow (n_batches,) int32), all on the
        device; the loop never waits on the host."""
        b = self.cfg.batch_size
        keys, tenant, _ = self._lanes(keys, tenant)
        n = int(keys.shape[0])
        n_pad = (-n) % b
        kb = torch.nn.functional.pad(keys, (0, n_pad)).view(-1, b)
        tb = torch.nn.functional.pad(tenant, (0, n_pad)).view(-1, b)
        vb = (torch.arange(n + n_pad, device=self.device) < n).view(-1, b)
        dups = torch.empty(kb.shape, dtype=torch.bool, device=self.device)
        ovfs = torch.empty((kb.shape[0],), dtype=torch.int32,
                           device=self.device)
        self._stream_shapes.add((b, kb.shape[0]))
        for i in range(kb.shape[0]):
            state, res = self._fleet_step(state, kb[i], tb[i], vb[i])
            dups[i] = res.dup
            ovfs[i] = res.overflow
        return state, dups.reshape(-1)[:n], ovfs

    # ------------------------------------------------------------------ //
    def process_cache_size(self) -> int:
        """Distinct mixed-batch widths seen by ``process``."""
        return len(self._widths)

    def stream_cache_size(self) -> int:
        """Distinct (batch, batches) stream shapes seen by ``run_stream``."""
        return len(self._stream_shapes)
