"""Stream-quality metrics: FPR / FNR / load / convergence / throughput —
the port of ``repro.dedup.metrics``.

Mirrors the paper's evaluation (Section 6): FPR and FNR against ground
truth, and *stability* — "load [...] the number of 1's in the Bloom
Filters normalized by the total memory space in bits" (Section 6.2, Fig.
11), with convergence declared when the load's moving range flattens.

Reports may be torch tensors on any device or numpy arrays. ``fpr_fnr``
takes the counts on the reports' device and reads them back once, at the
end of a stream; ``StreamMetrics`` accumulates per batch on the device
and reads back at read-out (DESIGN §7).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch


def _tensor(x, device=None) -> torch.Tensor:
    """A report, truth or load as a tensor on ``device`` (its own when
    None). numpy goes through pinned memory to the card, so the copy does
    not wait for it."""
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
    if device is None or t.device == torch.device(device):
        return t
    if t.device.type == "cpu" and torch.device(device).type == "cuda":
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


@dataclasses.dataclass
class StreamMetrics:
    """Streaming accumulator; feed per-batch reports.

    ``update`` only accumulates: it issues one reduction per batch on the
    reports' device (the four truth counts in one tensor) and keeps the
    result there, so the ingest loop never waits on the host. The counts
    fold into Python ints — which never wrap — every ``_FOLD_EVERY``
    batches (one transfer each time) and at read-out: a property,
    ``summary()`` or a convergence query."""

    n: int = 0
    true_distinct: int = 0
    true_duplicate: int = 0
    false_pos: int = 0
    false_neg: int = 0
    _overflow: int = 0
    # stamped at the first update, not at construction: set-up and kernel
    # builds are not ingest time
    _t0: Optional[float] = None
    load_history: list = dataclasses.field(default_factory=list)
    # per-batch device counts, folded into the int counters at read-out
    _pending: list = dataclasses.field(default_factory=list)
    _pending_ovf: list = dataclasses.field(default_factory=list)
    # (cell, count) pairs from ``Dedup.top_cells`` (counting sketches,
    # DESIGN §3.8), recorded whenever the caller chooses to probe
    heavy_hitters: Optional[list] = None
    _FOLD_EVERY = 512

    def update(self, reported_dup, truth_dup=None, load=None,
               s_bits: Optional[int] = None, overflow=0) -> None:
        if self._t0 is None:                      # first batch starts the clock
            self._t0 = time.perf_counter()
        rep = _tensor(reported_dup).to(torch.bool)
        self.n += rep.numel()                     # static shape — no sync
        if isinstance(overflow, (torch.Tensor, np.ndarray)):
            self._pending_ovf.append(_tensor(overflow).sum())
            if len(self._pending_ovf) >= self._FOLD_EVERY:
                self._fold()
        else:
            self._overflow += int(overflow)
        if truth_dup is not None:
            tru = _tensor(truth_dup, rep.device).to(torch.bool)
            self._pending.append(torch.stack(
                [~tru, tru, rep & ~tru, ~rep & tru]).sum(dim=1))
            if len(self._pending) >= self._FOLD_EVERY:
                self._fold()
        if load is not None and s_bits:
            self.load_history.append(_tensor(load).sum() / s_bits)
            if len(self.load_history) % self._FOLD_EVERY == 0:
                self._loads()

    def _fold(self) -> None:
        """Drain the deferred per-batch counts into the int counters: one
        transfer per device."""
        if self._pending:
            td, tdup, fp, fn = (int(x) for x in
                                torch.stack(self._pending).sum(dim=0)
                                .tolist())
            self.true_distinct += td
            self.true_duplicate += tdup
            self.false_pos += fp
            self.false_neg += fn
            self._pending.clear()
        if self._pending_ovf:
            self._overflow += int(torch.stack(
                [x.to(torch.int64) for x in self._pending_ovf]).sum())
            self._pending_ovf.clear()

    # -- the paper's headline numbers (the sync happens here) ----------- //
    @property
    def overflow(self) -> int:
        self._fold()
        return self._overflow

    @property
    def fpr(self) -> float:
        self._fold()
        return self.false_pos / max(1, self.true_distinct)

    @property
    def fnr(self) -> float:
        self._fold()
        return self.false_neg / max(1, self.true_duplicate)

    @property
    def throughput(self) -> float:
        if self._t0 is None:
            return 0.0
        return self.n / max(1e-9, time.perf_counter() - self._t0)

    def _loads(self) -> list:
        """The load curve as floats (one transfer for the tensors not yet
        read); reads can interleave with updates, so only the tail may
        still hold tensors."""
        h = self.load_history
        first = next((i for i, x in enumerate(h)
                      if isinstance(x, torch.Tensor)), len(h))
        if first < len(h):
            tail = torch.stack([x.to(torch.float32) for x in h[first:]])
            self.load_history = h = h[:first] + [float(x) for x in
                                                 tail.tolist()]
        return h

    def converged(self, window: int = 16, tol: float = 5e-3) -> bool:
        """Stability per Fig. 11: the normalized load's recent range < tol."""
        h = self._loads()
        if len(h) < window:
            return False
        recent = h[-window:]
        return (max(recent) - min(recent)) < tol

    def convergence_point(self, window: int = 16, tol: float = 5e-3
                          ) -> Optional[int]:
        """Index (in batches) where the load first stabilizes."""
        h = self._loads()
        for i in range(window, len(h) + 1):
            r = h[i - window:i]
            if max(r) - min(r) < tol:
                return i - window
        return None

    def record_heavy_hitters(self, cells, counts) -> None:
        """Snapshot the top-load cells from ``Dedup.top_cells`` (counting
        sketches, DESIGN §3.8). Reads back to the host: call at
        monitoring cadence, not per ingest batch."""
        self.heavy_hitters = [(int(c), int(v)) for c, v in
                              zip(_tensor(cells).tolist(),
                                  _tensor(counts).tolist())]

    def summary(self) -> dict:
        self._fold()
        loads = self._loads()
        return {
            "n": self.n, "fpr": self.fpr, "fnr": self.fnr,
            "overflow": self.overflow,
            "throughput_eps": self.throughput,
            "final_load": loads[-1] if loads else None,
            "convergence_batch": self.convergence_point(),
            "heavy_hitters": self.heavy_hitters,
        }


def truth_from_stream(keys: np.ndarray) -> np.ndarray:
    """Exact ground truth: True where the key occurred earlier in the stream."""
    keys = np.asarray(keys)
    _, first_idx = np.unique(keys, return_index=True)
    truth = np.ones(keys.shape[0], dtype=bool)
    truth[first_idx] = False
    return truth


def windowed_truth_from_stream(keys: np.ndarray, window: int,
                               batch_size: int) -> np.ndarray:
    """Batch-windowed ground truth matching the swbf semantics (DESIGN
    §3.7): True where the key occurred within the previous ``window``
    batches or earlier in the element's own batch. If the key's most recent
    prior occurrence fell out of the window, so did every older one — so
    only the immediate predecessor is checked (one stable sort)."""
    keys = np.asarray(keys)
    n = keys.shape[0]
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    prev = np.full(n, -1, dtype=np.int64)
    same = sk[1:] == sk[:-1]
    prev[order[1:][same]] = order[:-1][same]
    batch = np.arange(n, dtype=np.int64) // batch_size
    prev_batch = np.where(prev >= 0, prev // batch_size, np.int64(-1))
    return (prev >= 0) & (prev_batch >= batch - window)


def fpr_fnr(reported, truth) -> tuple:
    """(FPR, FNR): distinct elements reported duplicate over all distinct
    elements, and duplicates reported distinct over all duplicates."""
    rep = torch.as_tensor(reported).to(torch.bool)
    tru = torch.as_tensor(np.asarray(truth, dtype=bool)).to(rep.device)
    counts = torch.stack([(~tru).sum(), tru.sum(), (rep & ~tru).sum(),
                          (~rep & tru).sum()]).tolist()
    n_distinct, n_dup, false_pos, false_neg = counts
    return false_pos / max(1, n_distinct), false_neg / max(1, n_dup)
