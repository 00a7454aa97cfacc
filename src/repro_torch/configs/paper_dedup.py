"""The paper's own configurations (Section 6 experimental settings) — the
port of ``repro.configs.paper_dedup``, over the port's ``DedupConfig``.

Table memories 8MB..512MB, k per Section 6.1 (k=2 for BSBF/BSBFSD/RLBSBF,
RSBF's k from Eq. 6.1 averaged with 1, p*=0.03, FPR_t=0.1), plus the
variants scaled down for small machines (ratios held fixed at 1/256 scale
— DESIGN §8). With the config's defaults every variant runs on the dense8
layout, as in the reference.
"""

from __future__ import annotations

from ..core.config import DedupConfig

MB = 8 * 1024 * 1024  # bits per MB

PAPER_MEMORIES_MB = (8, 64, 128, 256, 512)
PAPER_DISTINCT_FRACS = (0.15, 0.60, 0.90)
PAPER_STREAM_SIZES = (695_000_000, 1_000_000_000)
SCALE = 256  # small-machine scale divisor


def paper_config(variant: str, memory_mb: int, **kw) -> DedupConfig:
    return DedupConfig.for_variant(variant, memory_bits=memory_mb * MB,
                                   fpr_t=0.1, p_star=0.03, **kw)


def scaled_config(variant: str, memory_mb: int, **kw) -> DedupConfig:
    """Same records-per-bit ratio at 1/SCALE size."""
    bits = memory_mb * MB // SCALE
    return DedupConfig.for_variant(variant, memory_bits=bits,
                                   fpr_t=0.1, p_star=0.03, **kw)


def scaled_stream(n_records: int) -> int:
    return n_records // SCALE
