"""The kernel package's budget model — the port of ``repro/kernels/common.py``.

Two models, side by side:

* **The reference's, as it is.** ``DEFAULT_TILE_W``, ``DEFAULT_CHUNK_B``,
  ``VMEM_FILTER_BYTES_LIMIT``, ``check_vmem_budget``,
  ``counter_vmem_words``, ``fused_resident_bytes``,
  ``fleet_resident_bytes`` and ``largest_tile`` are pure arithmetic over a
  config: the TPU kernels' VMEM-resident working set and tile width. They
  are copied unchanged, so a config's planning figures carry across the
  two packages (the tests hold them equal to the reference's). No Hopper
  kernel reads them: none keeps the filter resident; every one gathers
  from device memory or L2.
* **What the card holds** (DESIGN §3.4): ``step_device_bytes`` — the
  state and the kernels' operands of one step, in device memory;
  ``block_shared_bytes`` — the static shared memory per block of each
  kernel in ``csrc/``, which the hot-path linter's
  ``kernel-resource-budget`` rule holds to what ``ptxas -v`` reports;
  ``fits_l2`` — whether the filter table fits the card's 50 MB L2; and
  ``SHARED_BYTES_PER_BLOCK_LIMIT``, the 227 KB a block may opt in to.

The reference's in-kernel helpers need no port, their work lives inside
the CUDA kernels: ``popcount_sum`` (the exact load comes from the atomics'
returns and ``__popc``), ``chunk_or`` (accumulate mode launches the
per-event counter kernel, which ORs no tile) and ``probe_all_nonzero``
(the probe in ``counter_probe_partition``).
"""

from __future__ import annotations

import math

from ..launch.hw import VMEM_BYTES
from .hashmix import MAX_ROWS

DEFAULT_TILE_W = 512
DEFAULT_CHUNK_B = 1024
VMEM_FILTER_BYTES_LIMIT = 8 * 1024 * 1024

SHARED_BYTES_PER_BLOCK_LIMIT = VMEM_BYTES  # 227 KB, opt-in, per block
COUNTER_TILE = 128                      # csrc/counter_step.cu::kTile
L2_BYTES = 50 * 1024 * 1024             # the H100's L2

# every kernel in csrc/, by source
KERNELS = {
    "hashmix": ("hashmix_kernel",),
    "bitset_step": ("probe_decide", "apply_deletes", "apply_inserts"),
    "counter_step": ("counter_probe_partition", "counter_merge_apply"),
    "bloom_probe": ("bloom_probe_kernel", "fused_probe_kernel"),
    "scatter_delta": ("scatter_delta_kernel",),
}
# static shared memory per block where a kernel declares any: hashmix
# stages the probe and block seeds from the argument block (not when k >
# 32 reads them from device memory), counter_merge_apply a tile of cells
# and one sum per warp (csrc/counter_step.cu::TileShared)
_SHARED = {
    "hashmix_kernel<false>": 2 * MAX_ROWS * 4,
    "hashmix_kernel<true>": 0,
    "counter_merge_apply": (COUNTER_TILE + COUNTER_TILE // 32) * 4,
}


# ---------------- the reference's VMEM model ----------------------------- //

def check_vmem_budget(nbytes: int, what: str) -> None:
    """Shared guard for every fused kernel: the filter-resident working set
    must fit the VMEM budget — larger filters shard across devices first
    (repro.dedup.sharded)."""
    if nbytes > VMEM_FILTER_BYTES_LIMIT:
        raise ValueError(
            f"{what} {nbytes} B exceeds the {VMEM_FILTER_BYTES_LIMIT} B VMEM "
            f"budget for the fused step — shard the filter "
            f"(repro.dedup.sharded) first")


def counter_vmem_words(d: int, *, has_sub: bool, set_mode: bool,
                       accumulate: bool) -> int:
    """W-sized VMEM-resident word rows of the fused counter step: the d
    planes, the d subtract planes when the sketch decays, and the insert
    operand — one OR row for set-to-Max, d count planes for saturating add
    (sbf: 2d+1, swbf: 3d, cms/hh: 2d). Accumulate mode swaps every delta
    plane for per-event operands and keeps only the d filter planes."""
    return d + (0 if accumulate else
                (d if has_sub else 0) + (1 if set_mode else d))


def _event_operand_words(n_events: int, rows: int, chunk_b: int) -> int:
    """Words of one accumulate-mode event operand pair: the (E,) int32 word
    index plus the (rows, E) uint32 masks, E padded up to the power-of-two
    chunk the TPU kernel sweeps."""
    if n_events <= 0:
        return 0
    tbc = 1 << max(3, min(chunk_b, n_events) - 1).bit_length()
    padded = n_events + ((-n_events) % tbc)
    return (1 + rows) * padded


def fused_resident_bytes(cfg, batch_size: int | None = None,
                         event_capacity: int | None = None) -> int:
    """The TPU fused step's VMEM working set for ``cfg``, in bytes, from
    the config alone. ``batch_size`` defaults to ``cfg.batch_size``;
    ``event_capacity`` is the swbf ring's per-slot element count (default:
    the batch size)."""
    from ..core.sketch import get_spec   # deferred: core.sketch -> batched
    cfg = cfg.validate()
    w = cfg.s_words
    spec = get_spec(cfg.variant)
    if spec.family == "bitset":
        return cfg.k * w * 4
    d = cfg.n_planes
    set_mode = spec.combine == "set"
    words = counter_vmem_words(d, has_sub=spec.has_sub, set_mode=set_mode,
                               accumulate=cfg.kernel_accumulate)
    ev_words = 0
    if cfg.kernel_accumulate:
        b = cfg.batch_size if batch_size is None else batch_size
        cap = b if event_capacity is None else event_capacity
        chunk = DEFAULT_CHUNK_B
        if spec.has_sub:
            # sbf decays B*P random cells; swbf expires one ring slot
            sub_e = (cap * cfg.k if spec.windowed
                     else b * cfg.sbf_p_effective)
            sub_rows = 1 if (set_mode and cfg.sbf_max == 0) else d
            ev_words += _event_operand_words(sub_e, sub_rows, chunk)
        ins_rows = 1 if set_mode else d
        ev_words += _event_operand_words(b * cfg.k, ins_rows, chunk)
    return (words * w + ev_words) * 4


def fleet_resident_bytes(cfg, capacity: int,
                         event_capacity: int | None = None) -> int:
    """The TPU fleet launch's VMEM working set: the per-tenant figure at
    the slot width C times ``cfg.n_tenants``."""
    return cfg.n_tenants * fused_resident_bytes(
        cfg, batch_size=capacity, event_capacity=event_capacity)


def largest_tile(w: int, limit: int) -> int:
    """Largest tile width <= limit that divides w (the TPU kernels sweep
    the W words in equal tiles; the CUDA kernels do not tile W)."""
    tw = min(limit, w)
    while w % tw:
        tw -= 1
    return tw


# ---------------- the Hopper model --------------------------------------- //

def _bits_bytes(cfg) -> int:
    """One filter's ``bits`` leaf, as ``core.state.bits_shape`` lays it."""
    if not cfg.is_planes:
        return cfg.n_rows * cfg.s
    return cfg.n_planes * cfg.n_rows * cfg.s_words * 4


def state_bytes(cfg, event_capacity: int | None = None) -> int:
    """Device bytes of the state: bits, position, load, rng and, for swbf,
    the ring of ``event_capacity`` (default ``cfg.batch_size``) elements
    per slot; ``cfg.n_tenants`` times over for a fleet."""
    cfg = cfg.validate()
    one = _bits_bytes(cfg) + 4 + 4 * cfg.n_rows + 8
    if cfg.variant == "swbf":
        cap = cfg.batch_size if event_capacity is None else event_capacity
        one += cfg.window * cap * cfg.k * 4 + 4
    return cfg.n_tenants * one


def step_device_breakdown(cfg, batch_size: int | None = None,
                          event_capacity: int | None = None) -> dict:
    """One step's device bytes on the card, by kind. ``batch_size`` is the
    lanes of one filter's row (default ``cfg.batch_size``; a fleet's slot
    width C), ``event_capacity`` the swbf ring's elements per slot (default
    the row width, as ``FleetDedup`` sizes it).

    * ``state``: ``state_bytes``;
    * ``operands``: what the step's kernels read and write besides the
      state — the bitset step's keys, randomness, masks, stream positions
      and outputs; hashmix's keys and positions, and the counter step's
      masks, (T,) knobs, sorted int64 event lists and outputs; on dense8
      hashmix's keys and positions (no step kernel);
    * ``scratch``: what a launch allocates for itself — the bitset step's
      deletion-row masks, the counter step's merge-path splits, and the 2k
      seed words past ``MAX_ROWS`` rows."""
    from ..core.sketch import get_spec
    cfg = cfg.validate()
    spec = get_spec(cfg.variant)
    t, k = cfg.n_tenants, cfg.k
    b = cfg.batch_size if batch_size is None else batch_size
    cap = b if event_capacity is None else event_capacity
    lanes = t * b
    seeds = 2 * k * 4 if k > MAX_ROWS else 0
    hashing = lanes * (4 + 4 * k)                      # keys in, pos out
    if not cfg.is_planes:
        operands, scratch = hashing, seeds
    elif spec.family == "bitset":
        # keys, del_pos, u_bern, u_aux, which, valid, seen, i_t; dup, ins
        operands = lanes * (4 + 4 * k + 4 + 4 * k + 4 + 1 + 1 + 4 + 1 + 1)
        operands += t * k * 4                          # load out
        scratch = lanes * 4 * math.ceil(k / 32) + seeds
    else:
        n_ins = cap * k if spec.windowed else b * k
        n_sub = 0
        if spec.has_sub:
            n_sub = cap * k if spec.windowed else b * cfg.sbf_p_effective
        operands = hashing + lanes * (1 + (1 if spec.uses_seen else 0))
        operands += t * (4 + 4) + t * 8 * (n_ins + n_sub)   # knobs, events
        operands += lanes + t * 4                      # dup, load out
        scratch = t * math.ceil((n_ins + n_sub) / COUNTER_TILE) * 4 + seeds
    return {"state": state_bytes(cfg, cap), "operands": operands,
            "scratch": scratch}


def step_device_bytes(cfg, batch_size: int | None = None,
                      event_capacity: int | None = None) -> int:
    """Device bytes one step holds: state plus operands plus scratch
    (``step_device_breakdown``)."""
    return sum(step_device_breakdown(cfg, batch_size,
                                     event_capacity).values())


def block_shared_bytes(kernel: str) -> int:
    """Static shared memory per block of a kernel in ``csrc/``, by its name
    as ``ptxas`` reports it demangled (``counter_merge_apply<8>``,
    ``hashmix_kernel<false>``; the template arguments matter only where
    they change the figure). No kernel uses dynamic shared memory."""
    if kernel in _SHARED:
        return _SHARED[kernel]
    base = kernel.split("<", 1)[0]
    if base in _SHARED:
        return _SHARED[base]
    if any(base in names for names in KERNELS.values()):
        return 0
    raise KeyError(f"no kernel named {kernel!r} in csrc/")


def fits_l2(cfg) -> bool:
    """Whether the filter table (every tenant's ``bits``) fits the 50 MB
    L2, so a step's scattered probes can hit there."""
    cfg = cfg.validate()
    return cfg.n_tenants * _bits_bytes(cfg) <= L2_BYTES
