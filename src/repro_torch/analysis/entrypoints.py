"""Every hot path of the port, enumerated — the counterpart of
``repro/analysis/entrypoints.py`` (DESIGN §6).

``iter_entry_points(device)`` builds the reference's matrix at its
canonical sizes — the step of each registered ``SketchSpec`` on the plane
layout, the five dense8 steps, the ``debug_exact_load`` step, the
representative streams (``STREAM_MATRIX``), the sharded serial, pipelined
and rebalance streams, the serving executor's padded donated step, and the
fleet steps and streams — each at a config whose filter sits well above
every batch-event buffer, so the thresholds separate. On the card it adds
one entry per CUDA source, whose artifact is the ``ptxas -v`` report.

The reference's backend axis (``jnp`` / ``pallas``) collapses to the
device: in the port the device decides which form runs
(``core/config.py``: ``backend`` is kept for parity only). Names keep the
reference's form with the device in the backend's place
(``step/rlbsbf/planes/cpu``, ``fleet-step/rlbsbf/cuda/t8``), or after the
name where the reference's has no backend
(``sharded-stream/static/serial/rlbsbf/cpu``).

Entries are LAZY: building the list creates no engine and runs nothing.
An entry's ``build()`` makes its engine, state and inputs (untraced) and
returns a ``Prepared``: ``run()`` makes the one call the rules read,
threading the state of a donated entry, and ``leaves()`` lists that
state's leaves. The sharded entries run in process at one rank — gloo over
a ``FileStore`` on the CPU, NCCL on the card — in a group of their own
unless one is already up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import inspect
import tempfile
from typing import Callable, Dict, FrozenSet, List, Optional, Tuple

import numpy as np
import torch

from ..core import u32
from ..core.config import DedupConfig
from ..core.sketch import SKETCHES
from ..kernels.common import KERNELS

# the reference's canonical sweep sizes: small enough to run fast, large
# enough that the filter (W words / s cells) sits well above every
# batch-event buffer
CANON_MEMORY_BITS = 1 << 20
CANON_BATCH = 256
STREAM_BATCHES = 4
DEVICES = ("cpu", "cuda")


@dataclasses.dataclass
class Prepared:
    """One entry, set up: ``run()`` makes the traced call; ``leaves()``
    (donated entries) the state's leaves as (label, tensor), read before
    and after the call; ``close()`` releases what ``build`` took (a
    process group)."""
    run: Callable[[], object]
    leaves: Optional[Callable[[], List[Tuple[str, torch.Tensor]]]] = None
    close: Optional[Callable[[], None]] = None


@dataclasses.dataclass
class EntryPoint:
    """One hot path on one device. ``build`` lazily returns a ``Prepared``
    (for a kernel entry: the ``ptxas -v`` report); ``retrace_probe`` (when
    set) runs the path twice and returns a list of problem strings for the
    no-retrace rule. ``extra`` carries rule thresholds (``filter_elems``,
    ``separable``)."""
    name: str
    tags: FrozenSet[str]
    cfg: Optional[DedupConfig]
    device: str
    build: Callable[[], object]
    retrace_probe: Optional[Callable[[], List[str]]] = None
    extra: Dict = dataclasses.field(default_factory=dict)


def leaf_list(state) -> List[Tuple[str, torch.Tensor]]:
    """A ``FilterState``'s leaves as (label, tensor), the ring's and the
    router's fields by name."""
    out = [(".bits", state.bits), (".position", state.position),
           (".load", state.load), (".rng", state.rng)]
    if state.ring is not None:
        out += [(".ring.events", state.ring.events),
                (".ring.slot", state.ring.slot)]
    if state.router is not None:
        out += [(".router.assign", state.router.assign),
                (".router.n_rebalances", state.router.n_rebalances)]
    return out


def thresholds(cfg: DedupConfig) -> Dict:
    """filter_elems: the smallest per-row buffer that counts as "filter
    sized" (plane words / dense8 cells). separable: every batch-event
    buffer (B·k insert events, B·P sbf decrements) sits strictly below
    it, so the reduce rule cannot fire on an event-sized reduce."""
    t = cfg.s_words if cfg.is_planes else cfg.s
    p = cfg.sbf_p_effective if cfg.variant == "sbf" else cfg.k
    events = cfg.batch_size * max(cfg.k, p)
    return {"filter_elems": t, "separable": events < t}


def canon_cfg(variant: str, layout: str, **kw) -> DedupConfig:
    return DedupConfig.for_variant(
        variant, memory_bits=CANON_MEMORY_BITS, batch_size=CANON_BATCH,
        layout=layout, **kw)


def demo_keys(n: int, device, seed: int = 0) -> torch.Tensor:
    return u32.from_numpy_u32(np.random.default_rng(seed)
                              .integers(0, 1 << 20, n).astype(np.uint32),
                              device)


def _libs_loaded() -> int:
    from ..kernels import build
    return len(build._libs)


def _no_new_library(run) -> List[str]:
    before = _libs_loaded()
    run()
    after = _libs_loaded()
    return ([] if after == before else
            [f"repeating the call loaded {after - before} new kernel "
             f"librar{'y' if after - before == 1 else 'ies'}"])


# ---------------------------------------------------------------- factories


def adopt_entry(name: str, cfg: DedupConfig, device: str, run,
                leaves=None, tags=("step",)) -> EntryPoint:
    """An entry over a call that already exists — an engine and a state the
    caller holds (the card's full-width paths): ``run()`` makes one call,
    ``leaves()`` (donated calls) the state's leaves."""
    tags = frozenset(tags) | {device} | ({"donated"} if leaves else set())
    return EntryPoint(name=name, tags=tags, cfg=cfg, device=device,
                      build=lambda: Prepared(run, leaves),
                      extra=thresholds(cfg))


def step_entry(cfg: DedupConfig, device: str, *,
               name: Optional[str] = None) -> EntryPoint:
    """The batched step through ``Dedup.process`` — NOT donated:
    interactive callers keep their argument state (DESIGN §3.5)."""
    cfg = cfg.validate()
    if name is None:
        dbg = "/debug-exact-load" if cfg.debug_exact_load else ""
        name = f"step/{cfg.variant}/{cfg.effective_layout}/{device}{dbg}"

    def build():
        from ..core.engine import Dedup
        eng = Dedup(cfg, device)
        st = eng.init()
        keys = demo_keys(cfg.batch_size, device)
        valid = torch.ones(keys.shape, dtype=torch.bool, device=device)
        return Prepared(lambda: eng.process(st, keys, valid))

    return EntryPoint(name=name, tags=frozenset({"step", device}), cfg=cfg,
                      device=device, build=build, extra=thresholds(cfg))


def stream_entry(cfg: DedupConfig, device: str, *, probe: bool = False,
                 name: Optional[str] = None) -> EntryPoint:
    """The donated stream (``Dedup.run_stream``) over STREAM_BATCHES
    batches, its state threaded through the calls."""
    cfg = cfg.validate()
    if name is None:
        name = f"stream/{cfg.variant}/{cfg.effective_layout}/{device}"
    n = STREAM_BATCHES * cfg.batch_size

    def build():
        from ..core.engine import Dedup
        eng = Dedup(cfg, device)
        box = [eng.init()]
        keys = demo_keys(n, device)

        def run():
            box[0], _ = eng.run_stream(box[0], keys)
        return Prepared(run, lambda: leaf_list(box[0]))

    def retrace():
        from ..core.engine import Dedup
        eng = Dedup(cfg, device)
        keys = demo_keys(n, device)
        eng.run_stream(eng.init(), keys)
        first = eng.stream_cache_size()
        problems = []
        if first != 1:
            problems.append(f"first run_stream counted {first} stream "
                            f"shapes (expected 1)")
        problems += _no_new_library(lambda: eng.run_stream(eng.init(), keys))
        if eng.stream_cache_size() != first:
            problems.append("re-running the same-shape stream counted a "
                            "new stream shape")
        return problems

    return EntryPoint(
        name=name, tags=frozenset({"stream", "donated", device}), cfg=cfg,
        device=device, build=build, retrace_probe=retrace if probe else None,
        extra=thresholds(cfg))


@contextlib.contextmanager
def one_rank(device: str):
    """A process group of one rank for the sharded entries — gloo on the
    CPU, NCCL on the card — over a ``FileStore`` in a temporary directory,
    destroyed at the end. A group already up is used as it is."""
    import torch.distributed as dist
    if dist.is_initialized():
        yield
        return
    kw = {}
    backend = "gloo"
    if device == "cuda":
        backend = "nccl"
        torch.cuda.set_device(0)
        if "device_id" in inspect.signature(
                dist.init_process_group).parameters:
            kw["device_id"] = torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="repro_torch_lint_") as tmp:
        dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                                rank=0, world_size=1, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def sharded_stream_entry(device: str, *, pipeline: bool,
                         rebalance_buckets: int = 0,
                         variant: str = "rlbsbf", probe: bool = False,
                         name: Optional[str] = None) -> EntryPoint:
    """The sharded donated stream (``ShardedDedup.run_stream``) at one
    rank — serial, pipelined (DESIGN §4.5) and elastic (§4.4). The elastic
    entry runs its load monitor (threshold 1.5), so its per-batch read is
    in the trace; the reference's entry leaves the threshold at 0."""
    mode = "elastic" if rebalance_buckets else "static"
    if name is None:
        name = (f"sharded-stream/{mode}/"
                f"{'pipelined' if pipeline else 'serial'}/{variant}/{device}")
    kw = ({"rebalance_buckets": rebalance_buckets,
           "rebalance_threshold": 1.5} if rebalance_buckets else {})
    base = canon_cfg(variant, "planes", **kw)
    n = STREAM_BATCHES * base.batch_size

    def make_sd():
        from ..dedup.sharded import ShardedDedup, ShardedDedupConfig
        return ShardedDedup(ShardedDedupConfig(base=base, pipeline=pipeline),
                            device=device)

    def build():
        stack = contextlib.ExitStack()
        stack.enter_context(one_rank(device))
        try:
            sd = make_sd()
            box = [sd.init()]
            keys = demo_keys(n, device)
        except BaseException:
            stack.close()
            raise

        def run():
            box[0], _, _ = sd.run_stream(box[0], keys)
        return Prepared(run, lambda: leaf_list(box[0]), stack.close)

    def retrace():
        with one_rank(device):
            sd = make_sd()
            keys = demo_keys(n, device)
            sd.run_stream(sd.init(), keys)
            first = sd.stream_cache_size()
            problems = []
            if first != 1:
                problems.append(f"first sharded run_stream counted {first} "
                                f"stream shapes (expected 1)")
            problems += _no_new_library(
                lambda: sd.run_stream(sd.init(), keys))
            if sd.stream_cache_size() != first:
                problems.append("re-running the same-shape sharded stream "
                                "counted a new stream shape")
            return problems

    # threshold config: one rank holds the whole filter (static) or every
    # bucket (elastic, each nb times smaller)
    return EntryPoint(
        name=name,
        tags=frozenset({"stream", "sharded", "donated", mode, device,
                        "pipelined" if pipeline else "serial"}),
        cfg=base, device=device, build=build,
        retrace_probe=retrace if probe else None, extra=thresholds(base))


def serving_entry(device: str, *, variant: str = "rlbsbf", width: int = 256,
                  probe: bool = True,
                  name: Optional[str] = None) -> EntryPoint:
    """The serving executor's device path: the padded DONATED step at one
    bucket (``Dedup.process_padded(donate=True)``, DESIGN §5.2), here on a
    ragged request of width - 56 keys; the probe drives ragged request
    batches through ``MicroBatchExecutor`` twice and checks it counts one
    width per bucket."""
    if name is None:
        name = f"serving/process-padded/{variant}/w{width}/{device}"
    cfg = canon_cfg(variant, "planes")

    def build():
        from ..core.engine import Dedup
        eng = Dedup(cfg, device)
        box = [eng.init()]
        keys = demo_keys(width - 56, device)

        def run():
            box[0], _ = eng.process_padded(box[0], keys, width=width,
                                           donate=True)
        return Prepared(run, lambda: leaf_list(box[0]))

    def retrace():
        from ..serve.frontend import MicroBatchExecutor
        ex = MicroBatchExecutor(
            cfg, lambda batch: np.zeros(len(batch["key"])),
            buckets=(64, width), device=device)
        rng = np.random.default_rng(1)

        def drive():
            for n in (10, 64, 100, width):
                ex.run({"key": rng.integers(0, 1 << 20, n,
                                            dtype=np.uint32)})
            return ex.process_cache_size()
        first = drive()
        problems = _no_new_library(drive)
        second = ex.process_cache_size()
        if second != first:
            problems.append(f"replaying the same bucket widths grew the "
                            f"width count {first} -> {second} (one per "
                            f"bucket expected)")
        return problems

    return EntryPoint(
        name=name, tags=frozenset({"step", "serving", "donated", device}),
        cfg=cfg, device=device, build=build,
        retrace_probe=retrace if probe else None, extra=thresholds(cfg))


def _fleet_lanes(cfg: DedupConfig, device: str, n: int, seed: int = 2):
    rng = np.random.default_rng(seed)
    keys = u32.from_numpy_u32(rng.integers(0, 1 << 20, n, dtype=np.uint32),
                              device)
    tens = torch.from_numpy(rng.integers(0, cfg.n_tenants, n)
                            .astype(np.int32)).to(device)
    return keys, tens


def fleet_step_entry(device: str, *, variant: str = "rlbsbf",
                     n_tenants: int = 8, probe: bool = False,
                     name: Optional[str] = None) -> EntryPoint:
    """The tenant fleet's mixed-batch step (``FleetDedup.process``, DESIGN
    §4.6): route by tenant, then one step over the stacked (T, ...) state.
    Not donated; the probe checks the fleet counts one width."""
    if name is None:
        name = f"fleet-step/{variant}/{device}/t{n_tenants}"
    cfg = canon_cfg(variant, "planes", n_tenants=n_tenants)

    def build():
        from ..core.fleet import FleetDedup
        fleet = FleetDedup(cfg, device=device)
        st = fleet.init()
        keys, tens = _fleet_lanes(cfg, device, cfg.batch_size)
        return Prepared(lambda: fleet.process(st, keys, tens))

    def retrace():
        from ..core.fleet import FleetDedup
        fleet = FleetDedup(cfg, device=device)
        st = fleet.init()
        keys, tens = _fleet_lanes(cfg, device, cfg.batch_size)
        fleet.process(st, keys, tens)
        problems = _no_new_library(lambda: fleet.process(st, keys, tens))
        if fleet.process_cache_size() != 1:
            problems.append(f"replaying the same-width mixed batch counted "
                            f"{fleet.process_cache_size()} widths (one "
                            f"expected)")
        return problems

    return EntryPoint(
        name=name, tags=frozenset({"step", "fleet", device}), cfg=cfg,
        device=device, build=build, retrace_probe=retrace if probe else None,
        extra=thresholds(cfg))


def fleet_stream_entry(device: str, *, variant: str = "rlbsbf",
                       n_tenants: int = 8,
                       name: Optional[str] = None) -> EntryPoint:
    """The fleet's donated stream (``FleetDedup.run_stream``, §4.6) over
    STREAM_BATCHES mixed batches, the stacked state threaded through."""
    if name is None:
        name = f"fleet-stream/{variant}/{device}/t{n_tenants}"
    cfg = canon_cfg(variant, "planes", n_tenants=n_tenants)

    def build():
        from ..core.fleet import FleetDedup
        fleet = FleetDedup(cfg, device=device)
        box = [fleet.init()]
        keys, tens = _fleet_lanes(cfg, device,
                                  STREAM_BATCHES * cfg.batch_size)

        def run():
            box[0], _, _ = fleet.run_stream(box[0], keys, tens)
        return Prepared(run, lambda: leaf_list(box[0]))

    return EntryPoint(
        name=name, tags=frozenset({"stream", "fleet", "donated", device}),
        cfg=cfg, device=device, build=build, extra=thresholds(cfg))


def kernel_entry(source: str) -> EntryPoint:
    """The ``ptxas -v`` report of ``kernels/csrc/<source>.cu`` (card only:
    ``build()`` compiles it unless its library is current)."""
    def build():
        from ..kernels import build as kbuild
        return kbuild.build_log(source)

    return EntryPoint(name=f"kernel/{source}/cuda",
                      tags=frozenset({"kernel", "cuda"}), cfg=None,
                      device="cuda", build=build)


# ------------------------------------------------------------------ matrix


DENSE8_VARIANTS = ("rsbf", "bsbf", "bsbfsd", "rlbsbf", "sbf")
# one representative per distinct stream state (1-bit planes, the dense8
# reference, counter planes, the window ring, a pure-add sketch); the
# reference's jnp/pallas pairs are one entry here
STREAM_MATRIX = (
    ("rlbsbf", "planes"), ("rlbsbf", "dense8"), ("sbf", "planes"),
    ("swbf", "planes"), ("cms", "planes"),
)


def iter_entry_points(device: str = "cuda") -> List[EntryPoint]:
    """The full sweep matrix on ``device``: every registered SketchSpec's
    step on the plane layout, the five dense8 steps, the
    ``debug_exact_load`` escape hatch (its O(s) reduce is the baseline's
    worked example), the representative donated streams, the sharded
    serial / pipelined / rebalance streams, the serving step, the fleet
    steps and streams, and on the card one entry per CUDA source. Building
    the list is free — nothing runs until a rule reads an entry."""
    if device not in DEVICES:
        raise ValueError(f"device {device!r}; one of {DEVICES}")
    eps: List[EntryPoint] = []
    for variant in SKETCHES:
        eps.append(step_entry(canon_cfg(variant, "planes"), device))
    for variant in DENSE8_VARIANTS:
        eps.append(step_entry(canon_cfg(variant, "dense8"), device))
    eps.append(step_entry(canon_cfg("rlbsbf", "planes",
                                    debug_exact_load=True), device))
    for i, (variant, layout) in enumerate(STREAM_MATRIX):
        eps.append(stream_entry(canon_cfg(variant, layout), device,
                                probe=(i == 0)))
    eps.append(sharded_stream_entry(device, pipeline=False))
    eps.append(sharded_stream_entry(device, pipeline=True, probe=True))
    eps.append(sharded_stream_entry(device, pipeline=True,
                                    rebalance_buckets=4))
    eps.append(serving_entry(device))
    eps.append(fleet_step_entry(device, probe=True))
    eps.append(fleet_step_entry(device, variant="swbf"))
    eps.append(fleet_stream_entry(device))
    eps.append(fleet_stream_entry(device, variant="sbf"))
    if device == "cuda":
        eps.extend(kernel_entry(source) for source in KERNELS)
    return eps


def get_entry(name: str) -> EntryPoint:
    device = "cuda" if name.endswith("/cuda") or "/cuda/" in name else "cpu"
    for ep in iter_entry_points(device):
        if ep.name == name:
            return ep
    raise KeyError(f"no entry point named {name!r}")
