"""Dynamic-batching serving front-end — the port of ``repro.serve.frontend``:
padded micro-batch coalescing with admission control (DESIGN.md §5.2).

The paper's motivating applications (CDR streams, URL probes, online
transactions — Section 1) are MANY CONCURRENT SMALL REQUESTS, while the
engine underneath is fastest when fed wide fixed-shape batches. This module
is the adapter between the two:

  * ``MicroBatchExecutor`` — the synchronous batch-execution core shared by
    ``ServeSession`` (one caller, one batch per call) and ``ServeFrontend``
    (many callers, coalesced): pad the request keys to one of a small set
    of fixed BATCH BUCKETS, run one in-place engine step for the dedup
    verdicts, probe the response cache in one vectorized pass, score only
    the misses, admit, fan the responses back out.
  * ``ServeFrontend`` — the asyncio ingest front-end: concurrent
    ``submit()`` calls land in a bounded queue; a drain loop coalesces them
    into micro-batches (a flush timer bounds how long a partial batch waits
    for more traffic), dispatches the device step to a worker thread, and
    overlaps each batch's post-processing (cache/score/fan-out) with the
    NEXT batch's ingest+dedup. Admission control: at most
    ``max_live_batches`` batches in flight, and when the ingest queue is
    full a request is immediately SHED with an explicit ``"retry"`` verdict.

Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``, and raises without a card (``core.device``);
``partitionable`` picks JAX's threefry counter layout, as for ``Dedup``.
The device step runs in a pool thread: it enters ``torch.cuda.device`` of
the engine's device, so every step runs on that device's default stream
whichever thread picks it up. Its one wait is the copy of the verdicts to
the host — the client needs them.

The engine's state is updated in place (``process_padded(donate=True)``,
``FleetDedup.process(donate=True)``); without donation each step would
clone the whole filter (2 GiB for dense8 rlbsbf at 256 MB). The verdicts
are the same either way.

Determinism contract (DESIGN.md §5.2): dedup verdicts are a function of the
ADMITTED SCHEDULE — the sequence of (bucket width, request batch) the
front-end formed. The executor can record that schedule, and
``replay_schedule`` re-runs it through a fresh synchronous engine;
``verdict_digest`` equality is the parity proof that the async machinery
never alters a verdict — in either package, since the port's digests equal
the reference's for the same schedule (``tests/test_torch_serving.py``).
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import hashlib
from collections import deque
from typing import Callable, Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import u32
from ..core.config import DedupConfig
from ..core.device import resolve_device
from ..core.engine import Dedup
from ..core.fleet import FleetDedup
from .cache import ResponseCache

DEFAULT_BUCKETS = (64, 256, 1024)

VERDICT_OK = "ok"          # request served (value attached)
VERDICT_RETRY = "retry"    # shed by admission control — client should retry


@dataclasses.dataclass
class ServeResult:
    """Per-request outcome of the front-end."""
    verdict: str                          # VERDICT_OK | VERDICT_RETRY
    value: Optional[np.ndarray] = None    # response (None when shed)
    dup: bool = False                     # Bloom verdict for this request
    cached: bool = False                  # answered from the response cache


def verdict_digest(dups) -> str:
    """sha256 over a sequence of per-batch dup-verdict bit vectors — the
    parity fingerprint of an admitted schedule's verdicts."""
    h = hashlib.sha256()
    for d in dups:
        d = np.asarray(d, bool)
        h.update(np.int64(d.size).tobytes())
        h.update(np.packbits(d).tobytes())
    return h.hexdigest()


def _fleet_lanes(keys: np.ndarray, tenants: np.ndarray, width: int,
                 device: torch.device):
    """(keys, tenants, valid) padded to ``width`` lanes on ``device``."""
    n = keys.shape[0]
    kp = torch.nn.functional.pad(u32.as_words(keys, device), (0, width - n))
    tp = torch.nn.functional.pad(
        torch.from_numpy(np.asarray(tenants, np.int32)).to(device),
        (0, width - n))
    vp = torch.arange(width, device=device) < n
    return kp, tp, vp


def replay_schedule(cfg: DedupConfig,
                    schedule: Sequence[tuple],
                    event_capacity: Optional[int] = None, *,
                    device=None, partitionable: bool = True) -> str:
    """Synchronous replay of a recorded admitted schedule: a fresh engine,
    one ``process_padded`` per recorded batch at its recorded width.
    Returns the verdict digest — bit-identical to the front-end's by the
    determinism contract (DESIGN.md §5.2). The replay owns its engine's
    state, so it steps it in place (the verdicts are those of a copying
    step).

    Tenant-fleet configs (``cfg.n_tenants > 1``, DESIGN §4.6) record
    ``(width, keys, tenants)`` triples and replay through a fresh
    ``FleetDedup`` at the same slot capacity the executor used (the widest
    bucket = the max recorded width), so the per-tenant randomness and slot
    routing reproduce exactly."""
    dev = resolve_device(device)
    dups = []
    if cfg.validate().n_tenants > 1:
        cap = max((w for w, *_ in schedule), default=cfg.batch_size)
        fleet = FleetDedup(cfg, capacity=cap, device=dev,
                           partitionable=partitionable)
        st = fleet.init()
        for width, keys, tenants in schedule:
            st, res = fleet.process(st, *_fleet_lanes(keys, tenants, width,
                                                      dev), donate=True)
            dups.append(res.dup[:len(keys)].cpu().numpy())
        return verdict_digest(dups)
    eng = Dedup(cfg, dev, partitionable=partitionable)
    cap = event_capacity
    if cap is None and cfg.variant == "swbf" and schedule:
        cap = max(w for w, _ in schedule)
    st = eng.init(event_capacity=cap)
    for width, keys in schedule:
        st, res = eng.process_padded(st, np.asarray(keys, np.uint32),
                                     width=width, donate=True)
        dups.append(res.dup.cpu().numpy())
    return verdict_digest(dups)


class MicroBatchExecutor:
    """Synchronous micro-batch core: pad -> verdict -> cache -> score ->
    admit. Owns the engine state (stepped in place across the session) and
    the vectorized response cache. Not thread-safe; callers serialize."""

    def __init__(self, dedup_cfg: DedupConfig,
                 score_fn: Callable[[dict], np.ndarray], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 cache_size: int = 65536, cache_policy: str = "fifo",
                 record_schedule: bool = False, device=None,
                 partitionable: bool = True):
        self.cfg = dedup_cfg.validate()
        self.buckets = tuple(sorted(int(b) for b in buckets))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"buckets must be positive: {buckets!r}")
        self.device = resolve_device(device)
        self.n_tenants = self.cfg.n_tenants
        if self.n_tenants > 1:
            # tenant fleet (DESIGN §4.6): T isolated logical filters, one
            # launch per micro-batch. Slot capacity = the widest bucket, so
            # no admitted request ever overflows its tenant row.
            self.engine = None
            self.fleet = FleetDedup(dedup_cfg, capacity=self.buckets[-1],
                                    device=self.device,
                                    partitionable=partitionable)
            self.state = self.fleet.init()
        else:
            self.fleet = None
            self.engine = Dedup(dedup_cfg, self.device,
                                partitionable=partitionable)
            cap = self.buckets[-1] if self.cfg.variant == "swbf" else None
            self.state = self.engine.init(event_capacity=cap)
        self.score_fn = score_fn
        self.cache = ResponseCache(cache_size, cache_policy)
        self.schedule: Optional[List[Tuple[int, np.ndarray]]] = \
            [] if record_schedule else None
        self._digest = hashlib.sha256()
        # counters (cumulative over the session)
        self.n_requests = 0
        self.n_dup = 0
        self.n_cached = 0
        self.n_scored = 0
        self.n_batches = 0
        self.fill_sum = 0          # sum of per-batch request counts

    def bucket_for(self, n: int) -> int:
        """Smallest bucket >= n (n must fit the largest bucket)."""
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"batch of {n} exceeds largest bucket "
                         f"{self.buckets[-1]}")

    def cache_keys(self, keys: np.ndarray,
                   tenants: Optional[np.ndarray]) -> np.ndarray:
        """Response-cache identity of each request: the raw key for the
        classic engine, the TENANT-TAGGED key for a fleet (DESIGN §4.6), so
        tenants never share cached responses: ``tenant << 32 | key`` as
        uint64. The reference tags the tenant into the top log2(T) bits of
        the 32-bit key, which drops the key's top bits, so two keys of one
        tenant that differ only there share a response; the port's tag
        keeps every bit."""
        if self.n_tenants <= 1 or tenants is None:
            return keys
        return ((tenants.astype(np.uint64) << np.uint64(32))
                | keys.astype(np.uint64))

    # ------------------------------------------------------ device path //
    def dedup_chunk(self, keys: np.ndarray,
                    tenants: Optional[np.ndarray] = None) -> np.ndarray:
        """One padded, in-place engine step for one micro-batch (<= largest
        bucket). Returns the (n,) host dup verdicts — the step's one wait.
        A fleet executor (``cfg.n_tenants > 1``) routes the batch by the
        (n,) ``tenants`` lane instead — T logical filters, still one launch
        of each kernel (§4.6)."""
        n = keys.shape[0]
        width = self.bucket_for(n)
        on_card = (torch.cuda.device(self.device)
                   if self.device.type == "cuda" else contextlib.nullcontext())
        with on_card:
            if self.fleet is not None:
                if tenants is None:
                    tenants = np.zeros((n,), np.int32)
                self.state, res = self.fleet.process(
                    self.state, *_fleet_lanes(keys, tenants, width,
                                              self.device), donate=True)
                dup = res.dup[:n].cpu().numpy()
                if self.schedule is not None:
                    self.schedule.append((width, keys.copy(), tenants.copy()))
            else:
                self.state, res = self.engine.process_padded(
                    self.state, keys, width=width, donate=True)
                dup = res.dup.cpu().numpy()
                if self.schedule is not None:
                    self.schedule.append((width, keys.copy()))
        self._digest.update(np.int64(dup.size).tobytes())
        self._digest.update(np.packbits(dup).tobytes())
        self.n_batches += 1
        self.fill_sum += n
        self.n_requests += n
        self.n_dup += int(dup.sum())
        return dup

    # -------------------------------------------------------- host path //
    def respond_chunk(self, keys: np.ndarray, payload: Optional[dict]
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized cache probe, score the misses, admit. Returns the
        (n,) object array of responses and the (n,) hit mask. The cache is
        authoritative and probed for EVERY request — the Bloom verdict is
        probabilistic in both directions, so it never gates the probe
        (cache-first contract, DESIGN.md §5)."""
        hit, vals = self.cache.lookup(keys)
        need = np.flatnonzero(~hit)
        if need.size:
            batch = {"key": keys} if payload is None else payload
            sub = {f: np.asarray(v)[need] for f, v in batch.items()}
            scores = np.asarray(self.score_fn(sub))
            for j, i in enumerate(need):           # fan-out (host-side)
                vals[i] = scores[j]
            self.cache.admit(keys[need], list(scores))
        self.n_cached += int(hit.sum())
        self.n_scored += int(need.size)
        return vals, hit

    # -------------------------------------------------------- sync path //
    def run(self, batch: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Full synchronous path over an arbitrary-length request batch:
        chunk to the largest bucket, then verdict+respond per chunk.
        Returns (responses (B,) object, dup (B,) bool, hit (B,) bool).
        A fleet executor reads the per-request tenant ids from the
        ``"tenant"`` field (default: every request on tenant 0)."""
        keys = np.asarray(batch["key"], np.uint32)
        tenants = (np.asarray(batch["tenant"], np.int32)
                   if "tenant" in batch else None)
        bmax = self.buckets[-1]
        vals, dups, hits = [], [], []
        for i in range(0, keys.shape[0], bmax):
            k = keys[i:i + bmax]
            t = None if tenants is None else tenants[i:i + bmax]
            payload = {f: np.asarray(v)[i:i + bmax] for f, v in batch.items()}
            dup = self.dedup_chunk(k, t)
            v, hit = self.respond_chunk(self.cache_keys(k, t), payload)
            vals.append(v)
            dups.append(dup)
            hits.append(hit)
        return (np.concatenate(vals), np.concatenate(dups),
                np.concatenate(hits))

    # ------------------------------------------------------------ stats //
    def digest(self) -> str:
        """Verdict digest of every batch executed so far (parity probe)."""
        return self._digest.hexdigest()

    def process_cache_size(self) -> int:
        """Distinct step widths seen — at most one per bucket, whichever
        engine (classic or fleet) sits underneath."""
        return (self.fleet.process_cache_size() if self.fleet is not None
                else self.engine.process_cache_size())

    @property
    def mean_fill(self) -> float:
        return self.fill_sum / max(1, self.n_batches)


class ServeFrontend:
    """Async ingest front-end: coalesce concurrent requests into padded
    micro-batches over one shared engine + response cache.

    Lifecycle::

        async with ServeFrontend(cfg, score_fn) as fe:
            res = await fe.submit(key)            # ServeResult
            if res.verdict == "retry": ...        # shed — back off, retry

    Knobs (DESIGN.md §5.2): ``buckets`` — the fixed padded widths;
    ``flush_timeout`` — how long a partial batch waits for more traffic
    before dispatching (bounds tail latency); ``max_live_batches`` —
    batches in flight at once (one being dedup'd + post-processing
    overlapping the next); ``queue_limit`` — ingest-queue bound in requests
    (default ``max_live_batches * largest bucket``), beyond which
    ``submit`` sheds immediately with ``verdict="retry"``. ``device`` and
    ``partitionable`` as for ``Dedup``.
    """

    def __init__(self, dedup_cfg: DedupConfig,
                 score_fn: Callable[[dict], np.ndarray], *,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 max_live_batches: int = 4,
                 queue_limit: Optional[int] = None,
                 flush_timeout: float = 2e-3,
                 cache_size: int = 65536, cache_policy: str = "fifo",
                 record_schedule: bool = False, device=None,
                 partitionable: bool = True):
        self._exec = MicroBatchExecutor(
            dedup_cfg, score_fn, buckets=buckets, cache_size=cache_size,
            cache_policy=cache_policy, record_schedule=record_schedule,
            device=device, partitionable=partitionable)
        if max_live_batches < 1:
            raise ValueError("max_live_batches must be >= 1")
        self.max_live_batches = max_live_batches
        self.queue_limit = (max_live_batches * self._exec.buckets[-1]
                            if queue_limit is None else queue_limit)
        self.flush_timeout = flush_timeout
        self._queue: Deque[Tuple[int, int, Optional[dict],
                                 asyncio.Future]] = deque()
        self._running = False
        self._in_flight = 0
        self.n_submitted = 0
        self.n_shed = 0
        self.n_completed = 0

    # --------------------------------------------------------- lifecycle //
    async def start(self) -> "ServeFrontend":
        self._loop = asyncio.get_running_loop()
        self._arrived = asyncio.Event()
        self._live = asyncio.Semaphore(self.max_live_batches)
        self._post_tasks: set = set()
        self._running = True
        self._drain_task = self._loop.create_task(self._drain())
        return self

    async def stop(self) -> None:
        """Drain outstanding requests, then stop the batcher."""
        self._running = False
        self._arrived.set()
        await self._drain_task
        while self._post_tasks:
            await asyncio.gather(*list(self._post_tasks))

    async def __aenter__(self) -> "ServeFrontend":
        return await self.start()

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    # ------------------------------------------------------------ ingest //
    async def submit(self, key: int, payload: Optional[dict] = None,
                     *, tenant: int = 0) -> ServeResult:
        """Enqueue one request; resolves when its micro-batch completes.
        Sheds IMMEDIATELY (``verdict="retry"``, no waiting) when the ingest
        queue is at ``queue_limit`` — bounded latency, explicit overload.
        ``tenant`` selects the request's logical filter on a fleet
        front-end (``cfg.n_tenants > 1``, DESIGN §4.6); requests from
        different tenants coalesce into the SAME micro-batch and are routed
        on the device."""
        self.n_submitted += 1
        if not self._running or len(self._queue) >= self.queue_limit:
            self.n_shed += 1
            return ServeResult(VERDICT_RETRY)
        fut = self._loop.create_future()
        self._queue.append((int(key), int(tenant), payload, fut))
        self._arrived.set()
        return await fut

    # ------------------------------------------------------------- drain //
    async def _drain(self) -> None:
        bmax = self._exec.buckets[-1]
        while True:
            while not self._queue:
                if not self._running:
                    return
                self._arrived.clear()
                await self._arrived.wait()
            # flush window: while the device is BUSY, let the batch fill
            # toward the largest bucket (never holding a partial batch
            # longer than flush_timeout — the tail-latency bound). When
            # nothing is in flight the wait would be pure added latency,
            # so dispatch greedily with whatever has queued.
            if self._in_flight > 0:
                deadline = self._loop.time() + self.flush_timeout
                while self._running and len(self._queue) < bmax:
                    remaining = deadline - self._loop.time()
                    if remaining <= 0:
                        break
                    self._arrived.clear()
                    try:
                        await asyncio.wait_for(self._arrived.wait(),
                                               remaining)
                    except asyncio.TimeoutError:
                        break
            await self._live.acquire()      # admission: max_live_batches
            self._in_flight += 1
            take = min(len(self._queue), bmax)
            items = [self._queue.popleft() for _ in range(take)]
            keys = np.fromiter((it[0] for it in items), np.uint32, take)
            tenants = np.fromiter((it[1] for it in items), np.int32, take)
            try:
                # device path in a worker thread: the event loop keeps
                # ingesting (and shedding) while the engine step runs
                dup = await self._loop.run_in_executor(
                    None, self._exec.dedup_chunk, keys, tenants)
            except Exception as e:          # fail the batch, keep serving
                for *_kt, fut in items:
                    if not fut.done():
                        fut.set_exception(e)
                self._in_flight -= 1
                self._live.release()
                continue
            # post-processing overlaps the NEXT batch's ingest + dedup
            t = self._loop.create_task(self._post(items, keys, tenants, dup))
            self._post_tasks.add(t)
            t.add_done_callback(self._post_tasks.discard)

    async def _post(self, items, keys: np.ndarray, tenants: np.ndarray,
                    dup: np.ndarray) -> None:
        try:
            # cache identity is tenant-scoped on a fleet (§4.6): tenants
            # never see each other's cached responses
            ckeys = self._exec.cache_keys(keys, tenants)
            payload = None
            if any(it[2] is not None for it in items):
                fields = items[0][2].keys()
                payload = {f: np.asarray([it[2][f] for it in items])
                           for f in fields}
                payload["key"] = keys
            hit, vals = self._exec.cache.lookup(ckeys)
            need = np.flatnonzero(~hit)
            if need.size:
                batch = {"key": keys} if payload is None else payload
                sub = {f: np.asarray(v)[need] for f, v in batch.items()}
                scores = np.asarray(await self._loop.run_in_executor(
                    None, self._exec.score_fn, sub))
                for j, i in enumerate(need):
                    vals[i] = scores[j]
                self._exec.cache.admit(ckeys[need], list(scores))
            self._exec.n_cached += int(hit.sum())
            self._exec.n_scored += int(need.size)
            for i, (*_kt, fut) in enumerate(items):
                if not fut.done():
                    fut.set_result(ServeResult(
                        VERDICT_OK, value=vals[i], dup=bool(dup[i]),
                        cached=bool(hit[i])))
            self.n_completed += len(items)
        except Exception as e:              # fail the batch, keep serving
            for *_kt, fut in items:
                if not fut.done():
                    fut.set_exception(e)
        finally:
            self._in_flight -= 1
            self._live.release()

    # ------------------------------------------------------------- stats //
    @property
    def executor(self) -> MicroBatchExecutor:
        return self._exec

    def stats(self) -> dict:
        ex = self._exec
        return {
            "submitted": self.n_submitted, "completed": self.n_completed,
            "shed": self.n_shed,
            "shed_rate": self.n_shed / max(1, self.n_submitted),
            "batches": ex.n_batches, "mean_fill": ex.mean_fill,
            "dup": ex.n_dup, "cached": ex.n_cached, "scored": ex.n_scored,
            "cache_hit_rate": ex.n_cached / max(1, ex.n_requests),
            "dup_rate": ex.n_dup / max(1, ex.n_requests),
            "process_cache": ex.process_cache_size(),
        }
