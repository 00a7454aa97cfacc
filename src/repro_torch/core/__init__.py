"""Core de-duplication library of the PyTorch port: the paper's four
algorithms (RSBF, BSBF, BSBFSD, RLBSBF), the SBF baseline and the swbf,
cms and hh sketches on the packed bit-plane layout, held bit for bit
against the JAX package ``repro.core``."""

from .config import (ALL_VARIANTS, COUNTING_VARIANTS,
                     DedupConfig, VARIANTS, WINDOWED_VARIANTS, k_from_fpr_t,
                     rsbf_k, sbf_optimal_p)
from .state import (FilterState, RouterState, WindowRing, init_ring,
                    init_router, init_state, state_memory_bytes)
from .batched import (BatchResult, intra_batch_seen, make_batched_step,
                      make_templated_step)
from .sketch import SKETCHES, SketchSpec, get_spec
from .engine import Dedup, get_engine, next_pow2
from .variants import make_scan_step
from . import hashing, packed, prng, theory, u32

__all__ = [
    "DedupConfig", "FilterState", "WindowRing", "RouterState", "Dedup",
    "get_engine", "next_pow2", "BatchResult", "init_state", "init_ring",
    "init_router",
    "state_memory_bytes", "make_batched_step", "make_templated_step",
    "intra_batch_seen", "SketchSpec", "SKETCHES", "get_spec",
    "make_scan_step", "k_from_fpr_t", "rsbf_k",
    "sbf_optimal_p", "VARIANTS", "WINDOWED_VARIANTS", "COUNTING_VARIANTS",
    "ALL_VARIANTS", "hashing", "packed", "prng", "theory", "u32",
]
