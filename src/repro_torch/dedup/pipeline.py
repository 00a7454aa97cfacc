"""DedupPipeline — the paper's technique as a data-pipeline stage, the port
of ``repro.dedup.pipeline``.

Wraps any record stream and yields (batch, duplicate mask, weights):

    pipe = DedupPipeline(paper_config("rlbsbf", 256), mode="drop")
    for batch in pipe(stream_of_batches):
        loss = train_step(params, batch.data, weights=batch.weights)

Three deployment patterns, after the paper's motivating applications
(Section 1):

  * training-corpus dedup (CDR / web-crawl): ``mode="drop"`` zeroes
    duplicate records' loss weights so the optimizer never sees them
    twice (``"downweight"`` scales them by ``duplicate_weight``);
  * click-fraud filtering: ``mode="flag"`` passes everything through with
    the duplicate mask attached for the downstream billing logic;
  * embedding-gather dedup (recsys): ``unique_gather`` collapses repeated
    ids ahead of a gather.

Keys come from a record batch's ``"key"`` field, or from ``key_fn``. The
pipeline runs the port's ``Dedup`` on ``cuda`` unless it is given
``device="cpu"``, threads its own state through the engine's in-place
step (so no batch copies the filter), and accumulates ``StreamMetrics`` on
the device. ``state_dict`` / ``load_state_dict`` hand over a copy of the
state, which carries the stream position that RSBF's decisions need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Iterator, NamedTuple, Optional

import numpy as np
import torch

from ..core import u32
from ..core.config import DedupConfig
from ..core.engine import Dedup
from ..core.state import FilterState, RouterState, WindowRing
from .metrics import StreamMetrics


class DedupBatch(NamedTuple):
    data: dict                 # the original record batch (arbitrary arrays)
    keys: torch.Tensor         # (B,) int32 words — the record keys
    dup: torch.Tensor          # (B,) bool — reported duplicate
    weights: torch.Tensor      # (B,) float32 — loss / serve weights


@dataclasses.dataclass
class DedupPipeline:
    cfg: DedupConfig
    mode: str = "drop"                         # drop | downweight | flag
    duplicate_weight: float = 0.0              # used by "downweight"
    key_fn: Optional[Callable[[dict], object]] = None
    track_metrics: bool = True
    device: Optional[str] = None               # cuda unless "cpu"
    partitionable: bool = True                 # threefry layout (``Dedup``)

    def __post_init__(self):
        if self.mode not in ("drop", "downweight", "flag"):
            raise ValueError(self.mode)
        self.engine = Dedup(self.cfg, self.device,
                            partitionable=self.partitionable)
        self.device = self.engine.device
        self.state: FilterState = self.engine.init()
        self.metrics = StreamMetrics()

    # ------------------------------------------------------------------ //
    def _keys(self, batch: dict) -> torch.Tensor:
        if self.key_fn is not None:
            return u32.as_words(self.key_fn(batch), self.device)
        if "key" in batch:
            return u32.as_words(batch["key"], self.device)
        raise KeyError("batch has no 'key' field and no key_fn was given")

    def process(self, batch: dict, truth_dup: Optional[np.ndarray] = None
                ) -> DedupBatch:
        keys = self._keys(batch)
        # the pipeline owns its state: the step updates it in place, at the
        # batch's own width (the draws of ``Dedup.process``)
        self.state, res = self.engine.process_padded(
            self.state, keys, width=int(keys.shape[0]), donate=True)
        dup = res.dup
        if self.mode == "flag":
            w = torch.ones(keys.shape, dtype=torch.float32,
                           device=self.device)
        else:
            dup_w = 0.0 if self.mode == "drop" else self.duplicate_weight
            w = torch.where(dup, float(dup_w), 1.0)      # float32
        if self.track_metrics:
            # device-side accumulation: no read-back here (DESIGN §7)
            self.metrics.update(dup, truth_dup, load=self.state.load,
                                s_bits=self.cfg.s * self.cfg.k)
        return DedupBatch(data=batch, keys=keys, dup=dup, weights=w)

    def __call__(self, stream: Iterable[dict]) -> Iterator[DedupBatch]:
        for batch in stream:
            yield self.process(batch)

    # -- checkpointable state (stream position matters for RSBF) -------- //
    def state_dict(self) -> dict:
        """A copy of the filter state: later batches do not change it."""
        return {"filter_state": self.state._replace(
            bits=self.state.bits.clone())}

    def load_state_dict(self, d: dict) -> None:
        """Resume from a copy of ``d``'s state on the pipeline's device (the
        step replaces every leaf but the filter, which it updates in
        place)."""
        st = d["filter_state"]
        ring = (None if st.ring is None else
                WindowRing(*(x.to(self.device) for x in st.ring)))
        router = (None if st.router is None else
                  RouterState(*(x.to(self.device) for x in st.router)))
        self.state = FilterState(st.bits.to(self.device).clone(),
                                 st.position.to(self.device),
                                 st.load.to(self.device),
                                 st.rng.to(self.device), ring, router)


def unique_gather(ids):
    """Collapse duplicate ids ahead of an expensive gather (DESIGN §5):
    (unique_padded_ids, inverse) such that ``table[unique][inverse] ==
    table[ids]`` while the gather touches each row once. Fixed shapes: the
    unique list is padded with id 0. ``ids`` is an integer tensor or
    array; numpy uint32 sorts as unsigned. Returns the unique ids in the
    ids' dtype (int64 for numpy input) and an int32 inverse, on the ids'
    device."""
    if not isinstance(ids, torch.Tensor):
        ids = torch.from_numpy(np.asarray(ids).astype(np.int64))
    flat = ids.reshape(-1)
    n = flat.shape[0]
    order = torch.argsort(flat, stable=True)
    sorted_ids = flat[order]
    is_first = torch.ones((n,), dtype=torch.bool, device=flat.device)
    is_first[1:] = sorted_ids[1:] != sorted_ids[:-1]
    uniq_rank = torch.cumsum(is_first, dim=0) - 1               # (n,)
    # every element of a run writes its run's id: the same value
    uniq_ids = torch.zeros_like(flat).scatter_(0, uniq_rank, sorted_ids)
    inverse = torch.zeros((n,), dtype=torch.int32, device=flat.device)
    inverse.scatter_(0, order, uniq_rank.to(torch.int32))
    return uniq_ids, inverse.reshape(ids.shape)
