"""Public de-duplication engine — the port of ``repro.core.engine``.

    cfg   = DedupConfig.for_variant("rlbsbf", memory_bits=1 << 31)
    dedup = Dedup(cfg)                               # on the CUDA device
    state = dedup.init()
    state, res = dedup.process(state, keys)          # one batched step
    state, dup = dedup.run_stream(state, long_keys)  # the whole stream
    state, dup = dedup.run_stream_oracle(state, keys)  # sequential oracle

An engine is fully determined by its frozen ``DedupConfig`` and its device.
It runs on ``cuda`` unless the caller passes ``device="cpu"``; without a
CUDA device and without that request it raises, and it never falls back.
On CUDA the step goes through the hand-written kernels (on the plane
layout the bitset step, which hashes its keys itself, or hashmix and the
counter step; on the dense8 layout, the reference's default, hashmix and
plain PyTorch gathers and scatters), on the CPU through their plain
PyTorch versions;
at fixed seed both reproduce the JAX package's reports and state bit for
bit. The counter family (sbf, swbf, cms, hh) adds two read-outs:
``estimate`` (count-min per key) and ``top_cells`` (the highest cells).
``partitionable`` picks JAX's threefry counter layout for the randomized
deletions (``core.prng``): True matches JAX's default since 0.5, False the
original layout, under which the reference's pinned digests were captured.

In place of jit caching and donation (DESIGN §3.5): PyTorch runs eagerly,
so nothing is compiled per width, and ``process_cache_size`` /
``stream_cache_size`` count the distinct widths and stream lengths seen.
``process`` does not change the caller's state: it clones the filter
first. ``run_stream`` and ``process_padded(donate=True)`` update the filter
tensor in place — do not reuse the state passed to them; thread the
returned one. ``run_stream`` is a loop over batches that never waits on
the host: keys, reports and state stay on the device until the caller
reads them. ``run_stream_oracle`` (dense8 only, as in the reference) is a
loop over the keys calling the paper-order scan step
(``core.variants``); it leaves the caller's state as it was.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch

from . import u32
from .batched import (BatchResult, make_batched_step, make_estimate_fn,
                      sbf_planes_3d)
from .config import DedupConfig
from .device import resolve_device
from .state import FilterState, init_state
from .variants import make_scan_step

TOP_CELLS_CHUNK_WORDS = 1 << 20     # top_cells unpacks 2^25 cells at a time


def next_pow2(n: int) -> int:
    """Smallest power of two >= max(n, 1)."""
    return 1 << max(0, (int(n) - 1).bit_length())


def _as_valid(valid, n: int, device) -> torch.Tensor:
    if valid is None:
        return torch.ones((n,), dtype=torch.bool, device=device)
    return torch.as_tensor(valid, device=device).to(torch.bool).contiguous()


class Dedup:
    def __init__(self, cfg: DedupConfig, device=None, *,
                 partitionable: bool = True):
        self.cfg = cfg.validate()
        self.device = resolve_device(device)
        self._step = make_batched_step(self.cfg, self.device, partitionable)
        self._scan_step = (make_scan_step(self.cfg, partitionable)
                           if self.cfg.effective_layout == "dense8" else None)
        self._estimate = (make_estimate_fn(self.cfg, self.device)
                          if self.cfg.is_counter and self.cfg.is_planes
                          else None)
        self._widths: set = set()
        self._stream_lengths: set = set()

    # ------------------------------------------------------------------ //
    def init(self, seed: int | None = None,
             event_capacity: int | None = None) -> FilterState:
        """``event_capacity`` (swbf only) widens the ring's per-slot event
        list beyond the default ``cfg.batch_size`` elements — needed when
        ``process`` will be driven with wider batches (DESIGN §3.7)."""
        return init_state(self.cfg, seed, device=self.device,
                          event_capacity=event_capacity)

    def _ring_capacity(self, state: FilterState) -> int | None:
        if state.ring is None:
            return None
        return state.ring.events.shape[-1] // self.cfg.k

    def process(self, state: FilterState, keys, valid=None
                ) -> Tuple[FilterState, BatchResult]:
        """One batched step over keys (B,) (taken as uint32). The caller's
        ``state`` is left as it was. For swbf the batch must fit the ring's
        event capacity — one ring slot absorbs one step's events."""
        keys = u32.as_words(keys, self.device)
        cap = self._ring_capacity(state)
        if cap is not None and keys.shape[0] > cap:
            raise ValueError(
                f"swbf batch of {keys.shape[0]} exceeds the state ring's "
                f"event capacity {cap} — init the state with "
                f"event_capacity >= the batch width, or batch at "
                f"cfg.batch_size={self.cfg.batch_size}")
        valid = _as_valid(valid, keys.shape[0], self.device)
        self._widths.add(int(keys.shape[0]))
        return self._step(state._replace(bits=state.bits.clone()), keys,
                          valid)

    def process_padded(self, state: FilterState, keys, valid=None, *,
                       width: int | None = None, donate: bool = False
                       ) -> Tuple[FilterState, BatchResult]:
        """``process`` with ``(keys, valid)`` padded by invalid lanes up to
        ``width`` (default ``max(cfg.batch_size, next_pow2(n))``), the
        serving front-end's bucket contract (DESIGN §5.2); the result is
        sliced back to the request length. The step's randomness is drawn
        at the padded width. ``donate=True`` updates the filter in place."""
        keys = u32.as_words(keys, self.device)
        n = int(keys.shape[0])
        if width is None:
            width = max(self.cfg.batch_size, next_pow2(n))
        if n > width:
            raise ValueError(f"batch of {n} exceeds pad width {width}")
        cap = self._ring_capacity(state)
        if cap is not None and width > cap:
            raise ValueError(
                f"pad width {width} exceeds the state ring's event "
                f"capacity {cap} — init the state with "
                f"event_capacity >= the widest bucket (DESIGN §3.7)")
        valid = _as_valid(valid, n, self.device)
        keys_p = torch.nn.functional.pad(keys, (0, width - n))
        valid_p = torch.nn.functional.pad(valid, (0, width - n))
        self._widths.add(width)
        if not donate:
            state = state._replace(bits=state.bits.clone())
        state, res = self._step(state, keys_p, valid_p)
        if width != n:
            res = BatchResult(*(x[:n] for x in res))
        return state, res

    def process_cache_size(self) -> int:
        """Distinct step widths seen (the serving bucket probe, §5.2)."""
        return len(self._widths)

    # ------------------------------------------------------------------ //
    def _require_counter(self, what: str) -> None:
        if self._estimate is None:
            raise ValueError(
                f"{what} needs a counter-family variant on the plane "
                f"layout (sbf/swbf/cms/hh); got {self.cfg.variant!r} on "
                f"{self.cfg.effective_layout!r}")

    def estimate(self, state: FilterState, keys) -> torch.Tensor:
        """Frequency read-out (counter family): (B,) int32 count-min
        estimates, the MIN over each key's k probed d-bit cells (DESIGN
        §3.8). Read-only: no state change, no rng consumption. For cms it
        never under-counts while the cells are below the 2^d - 1 cap; for
        sbf/swbf it reads the decayed / windowed counters."""
        self._require_counter("estimate()")
        return self._estimate(state, u32.as_words(keys, self.device))

    def top_cells(self, state: FilterState, m: int = 16
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Monitoring read-out (counter family): the ``m`` highest-valued
        cells as (cells (m,) int32, counts (m,) int32), in descending count
        and, among equal counts, ascending cell — the order of
        ``jax.lax.top_k``. An O(s) read, taken in chunks of
        ``TOP_CELLS_CHUNK_WORDS`` words so that no (s,) int64 unpacking is
        ever held."""
        self._require_counter("top_cells()")
        s = self.cfg.s
        if not 1 <= m <= s:
            raise ValueError(f"top_cells takes 1 <= m <= s = {s}, got {m}")
        planes = sbf_planes_3d(state.bits)[:, 0, :]
        w = planes.shape[1]
        shifts = torch.arange(32, device=planes.device)
        best = None
        for lo in range(0, w, TOP_CELLS_CHUNK_WORDS):
            chunk = planes[:, lo:lo + TOP_CELLS_CHUNK_WORDS]
            vals = torch.zeros((chunk.shape[1], 32), dtype=torch.int64,
                               device=planes.device)
            for q in range(chunk.shape[0]):
                vals |= ((u32.to_u64(chunk[q])[:, None] >> shifts) & 1) << q
            cells = 32 * lo + torch.arange(vals.numel(),
                                           device=planes.device)
            # one key per cell: the count above, the complement of the
            # cell below, so ties go to the lower cell; past-s cells drop
            key = torch.where(cells < s,
                              (vals.reshape(-1) << 32) | ((1 << 32) - 1
                                                          - cells), -1)
            top = torch.topk(key, min(m, key.numel())).values
            best = top if best is None else torch.cat([best, top])
        best = torch.topk(best, m).values
        cells = ((1 << 32) - 1 - (best & 0xFFFFFFFF)).to(torch.int32)
        return cells, (best >> 32).to(torch.int32)

    # ------------------------------------------------------------------ //
    def run_stream(self, state: FilterState, keys
                   ) -> Tuple[FilterState, torch.Tensor]:
        """The batched engine over a whole (N,) stream, tail padded with
        invalid lanes; returns per-element duplicate reports (N,) bool on
        the device. The input state's filter is updated in place."""
        b = self.cfg.batch_size
        keys = u32.as_words(keys, self.device)
        n = int(keys.shape[0])
        n_pad = (-n) % b
        kb = torch.nn.functional.pad(keys, (0, n_pad)).view(-1, b)
        vb = (torch.arange(n + n_pad, device=self.device) < n).view(-1, b)
        dups = torch.empty(kb.shape, dtype=torch.bool, device=self.device)
        self._stream_lengths.add(n)
        for i in range(kb.shape[0]):
            state, res = self._step(state, kb[i], vb[i])
            dups[i] = res.dup
        return state, dups.reshape(-1)[:n]

    def stream_cache_size(self) -> int:
        """Distinct stream lengths seen by ``run_stream``."""
        return len(self._stream_lengths)

    def run_stream_oracle(self, state: FilterState, keys
                          ) -> Tuple[FilterState, torch.Tensor]:
        """Sequential per-element oracle (paper pseudocode order) over a
        whole (N,) stream: one scan step per key, on a copy of the
        caller's filter. Returns the state and (N,) bool reports on the
        device; the loop never waits on the host."""
        if self._scan_step is None:
            raise ValueError("oracle runs on the dense8 layout")
        keys = u32.as_words(keys, self.device)
        state = state._replace(bits=state.bits.clone())
        dups = torch.empty(keys.shape, dtype=torch.bool, device=self.device)
        for i in range(keys.shape[0]):
            state, dups[i] = self._scan_step(state, keys[i])
        return state, dups


@functools.lru_cache(maxsize=64)
def _cached_engine(cfg: DedupConfig, device: str, partitionable: bool
                   ) -> Dedup:
    return Dedup(cfg, device, partitionable=partitionable)


def get_engine(cfg: DedupConfig, device=None, *,
               partitionable: bool = True) -> Dedup:
    """Engines hold no stream state, so equal (config, device, threefry
    layout) triples share one engine."""
    return _cached_engine(cfg, str(resolve_device(device)), partitionable)
