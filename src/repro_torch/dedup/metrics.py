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


def fpr_fnr(reported, truth) -> tuple:
    """(FPR, FNR): distinct elements reported duplicate over all distinct
    elements, and duplicates reported distinct over all duplicates."""
    rep = torch.as_tensor(reported).to(torch.bool)
    tru = torch.as_tensor(np.asarray(truth, dtype=bool)).to(rep.device)
    counts = torch.stack([(~tru).sum(), tru.sum(), (rep & ~tru).sum(),
                          (~rep & tru).sum()]).tolist()
    n_distinct, n_dup, false_pos, false_neg = counts
    return false_pos / max(1, n_distinct), false_neg / max(1, n_dup)
