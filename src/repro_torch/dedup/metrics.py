"""Stream-quality read-out: ground truth and the paper's FPR / FNR
(Section 6) for reports from the port's engine.

Reports may be torch tensors on any device or numpy arrays; the counts are
taken on the reports' device and read back once, at the end of a stream.
"""

from __future__ import annotations

import numpy as np
import torch


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
