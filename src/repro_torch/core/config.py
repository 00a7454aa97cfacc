"""Configuration for the de-duplication structures — the PyTorch port's copy
of ``repro.core.config`` (the port imports nothing of the JAX package, so
it keeps its own; ``tests/test_torch_config.py`` holds the two equal field
for field and property for property).

Mirrors the paper's parameterization: total memory M (bits), number of
filters/hashes k, the RSBF threshold p* (=0.03 in all paper experiments,
Section 6), and the SBF baseline's (Max, P) from Deng & Rafiei SIGMOD'06.

``k_from_fpr_t`` implements Eq. (6.1):  k = ln(FPR_t) / ln(1 - 1/e).
``rsbf_k``      implements the paper's trade-off: the arithmetic mean of 1 and
                Eq. (6.1)'s k (Section 6.1).
``sbf_optimal_p`` solves Deng & Rafiei's stable-point equation for P.

``backend`` stays a field so that a config carries across from the JAX
package unchanged (``repro_torch.convert.config_from_dict``), but in the
port it selects nothing: the DEVICE selects the implementation — the
hand-written CUDA kernels for tensors on a CUDA device, their plain PyTorch
versions for tensors on the CPU (DESIGN §3.4).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

VARIANTS = ("sbf", "rsbf", "bsbf", "bsbfsd", "rlbsbf")
# the sliding-window counting Bloom filter (DESIGN §3.7)
WINDOWED_VARIANTS = ("swbf",)
# counting sketches riding the sketch template (DESIGN §3.8)
COUNTING_VARIANTS = ("cms", "hh")
ALL_VARIANTS = VARIANTS + WINDOWED_VARIANTS + COUNTING_VARIANTS


def k_from_fpr_t(fpr_t: float) -> int:
    """Eq. (6.1): number of Bloom filters from the target FPR."""
    k = math.log(fpr_t) / math.log(1.0 - 1.0 / math.e)
    return max(1, int(round(k)))


def rsbf_k(fpr_t: float) -> int:
    """RSBF trade-off (Section 6.1): mean of 1 and Eq. (6.1)."""
    return max(1, int(round((1 + k_from_fpr_t(fpr_t)) / 2)))


def sbf_stable_zero_fraction(p: float, k: int, m_cells: int, cmax: int) -> float:
    """Deng & Rafiei Thm 2: stable expected fraction of zero cells."""
    denom = 1.0 + 1.0 / (p * (1.0 / k - 1.0 / m_cells))
    return (1.0 / denom) ** cmax


def sbf_optimal_p(fpr_t: float, k: int, m_cells: int, cmax: int) -> int:
    """Binary-search P so the stable FPR hits fpr_t (larger P => more evict
    => fewer ones => lower FPR but higher FNR)."""
    lo, hi = 1, max(4, m_cells // max(k, 1))
    for _ in range(64):
        mid = (lo + hi) // 2
        zeros = sbf_stable_zero_fraction(float(mid), k, m_cells, cmax)
        fpr = (1.0 - zeros) ** k
        if fpr > fpr_t:
            lo = mid + 1
        else:
            hi = mid
        if lo >= hi:
            break
    return max(1, lo)


@dataclasses.dataclass(frozen=True)
class DedupConfig:
    """Static configuration — everything an engine closes over. Field for
    field the JAX package's ``DedupConfig``; see that class for the meaning
    of the fields the port does not run yet (counter family, sharding,
    fleets)."""

    variant: str = "rlbsbf"
    memory_bits: int = 1 << 23          # M (bits). Paper sweeps 64MB..512MB.
    k: int = 2                           # number of filters == hashes
    fpr_t: float = 0.1                   # target FPR used to derive k
    p_star: float = 0.03                 # RSBF threshold (paper Section 6)
    seed: int = 0x5EED
    # --- SBF baseline (Deng & Rafiei) ---
    sbf_max: int = 3
    sbf_p: Optional[int] = None
    # --- SWBF sliding window (DESIGN §3.7) ---
    window: int = 0
    cbf_bits: int = 4
    # --- counting sketches (cms/hh, DESIGN §3.8) ---
    count_bits: int = 8
    count_threshold: int = 1
    # --- engine knobs ---
    batch_size: int = 8192
    layout: str = "auto"                 # "auto" | "dense8" | "planes"
    packed: bool = False                 # packed=True + layout="auto" = planes
    backend: str = "jnp"                 # kept for parity; the device decides
    kernel_accumulate: bool = False
    block_bits: int = 0                  # >0: blocked layout (DESIGN §3.3)
    delete_set_bits_only: bool = False
    debug_exact_load: bool = False       # recompute load by full popcount
    # --- distribution ---
    shards: int = 1
    # --- elastic shard rebalance (DESIGN §4.4) ---
    rebalance_buckets: int = 0
    rebalance_threshold: float = 0.0
    # --- multi-tenant fleets (DESIGN §4.6) ---
    n_tenants: int = 1

    # ------------------------------------------------------------------ //
    @property
    def is_counter(self) -> bool:
        """Counter-cell structures: SBF, SWBF and the counting sketches."""
        return self.variant in ("sbf", "swbf") + COUNTING_VARIANTS

    @property
    def bits_per_cell(self) -> int:
        if self.variant == "sbf":
            return max(1, (self.sbf_max).bit_length())
        if self.variant == "swbf":
            return self.cbf_bits
        if self.variant in COUNTING_VARIANTS:
            return self.count_bits
        return 1

    @property
    def effective_layout(self) -> str:
        """Resolved cell layout: ``layout`` wins; "auto" maps ``packed`` to
        the plane layout and everything else to dense8 — except swbf and the
        counting sketches, which resolve to planes."""
        if self.layout == "auto":
            if self.variant == "swbf" or self.variant in COUNTING_VARIANTS:
                return "planes"
            return "planes" if self.packed else "dense8"
        return self.layout

    @property
    def is_planes(self) -> bool:
        return self.effective_layout == "planes"

    @property
    def n_planes(self) -> int:
        """Bit-planes of the plane layout: d = bits_per_cell."""
        return self.bits_per_cell

    @property
    def s(self) -> int:
        """Bits per filter (paper: s = M/k), or cells for the counter
        structures' single array — per shard, for memory parity."""
        per_shard = self.memory_bits // max(1, self.shards)
        if self.is_counter:
            return max(8, per_shard // self.bits_per_cell)
        return max(8, per_shard // self.k)

    @property
    def n_rows(self) -> int:
        """Rows of the bits array: 1 for the counter structures, k for the
        paper's variants."""
        return 1 if self.is_counter else self.k

    @property
    def s_words(self) -> int:
        return (self.s + 31) // 32

    @property
    def sbf_p_effective(self) -> int:
        if self.variant != "sbf":
            return 0
        if self.sbf_p is not None:
            return self.sbf_p
        return sbf_optimal_p(self.fpr_t, self.k, self.s, self.sbf_max)

    @property
    def rsbf_phase3_start(self) -> int:
        """First stream position where s/i <= p*  (the paper's point ``p``)."""
        return int(math.ceil(self.s / self.p_star))

    def validate(self) -> "DedupConfig":
        if self.variant not in ALL_VARIANTS:
            raise ValueError(
                f"unknown variant {self.variant!r}; one of {ALL_VARIANTS}")
        if self.k < 1:
            raise ValueError("k must be >= 1")
        if self.variant == "swbf":
            if self.window < 1:
                raise ValueError("swbf needs window >= 1 (batches)")
            if not (1 <= self.cbf_bits <= 8):
                raise ValueError("swbf counter width cbf_bits in [1, 8]")
            if self.effective_layout != "planes":
                raise ValueError("swbf only exists on the plane layout "
                                 "(layout='planes' or 'auto'; DESIGN §3.7)")
        if self.variant in COUNTING_VARIANTS:
            if not (1 <= self.count_bits <= 16):
                raise ValueError("counting-sketch counter width count_bits "
                                 "in [1, 16]")
            if not (1 <= self.count_threshold <= (1 << self.count_bits) - 1):
                raise ValueError(
                    f"count_threshold must lie in [1, 2^count_bits - 1] = "
                    f"[1, {(1 << self.count_bits) - 1}] — cells saturate "
                    f"there, so a larger threshold can never fire")
            if self.effective_layout != "planes":
                raise ValueError(
                    f"{self.variant} only exists on the plane layout "
                    f"(layout='planes' or 'auto'; DESIGN §3.8)")
        if self.s < 8:
            raise ValueError("filter too small: raise memory_bits or lower k/shards")
        if not (0.0 < self.p_star < 1.0):
            raise ValueError("p_star in (0,1)")
        if self.layout not in ("auto", "dense8", "planes"):
            raise ValueError(
                f"layout {self.layout!r}; one of ('auto', 'dense8', 'planes')")
        if self.layout == "dense8" and self.packed:
            raise ValueError("layout='dense8' contradicts packed=True "
                             "(packed is the legacy alias for the plane "
                             "layout)")
        if self.backend not in ("jnp", "pallas"):
            raise ValueError(f"backend {self.backend!r}; one of ('jnp', 'pallas')")
        if self.backend == "pallas" and not self.is_planes:
            raise ValueError("pallas backend requires the plane layout "
                             "(layout='planes' or packed=True)")
        if self.rebalance_buckets < 0:
            raise ValueError("rebalance_buckets must be >= 0")
        if self.rebalance_threshold != 0.0 and self.rebalance_threshold <= 1.0:
            raise ValueError(
                "rebalance_threshold is a max/mean load ratio (always >= 1): "
                "use a value > 1.0, or 0 to disable the monitor")
        if self.rebalance_threshold > 1.0 and self.rebalance_buckets == 0:
            raise ValueError(
                "rebalance_threshold needs elastic routing: set "
                "rebalance_buckets > 0 (DESIGN §4.4)")
        if self.n_tenants < 1:
            raise ValueError("n_tenants must be >= 1 (DESIGN §4.6)")
        if self.n_tenants > 1 and self.n_tenants & (self.n_tenants - 1):
            raise ValueError(
                f"n_tenants {self.n_tenants} must be a power of two — the "
                f"tenant id rides the top bits of the tenant-tagged key on "
                f"the sharded path (DESIGN §4.6)")
        return self

    @staticmethod
    def for_variant(variant: str, memory_bits: int, fpr_t: float = 0.1,
                    **kw) -> "DedupConfig":
        """Paper parameterization: derive k per Section 6.1."""
        if variant == "rsbf":
            k = rsbf_k(fpr_t)
        elif variant == "sbf":
            k = kw.pop("k", 3)
        elif variant == "swbf":
            k = kw.pop("k", 3)
            kw.setdefault("window", 8)
        elif variant in COUNTING_VARIANTS:
            k = kw.pop("k", 4)
            if variant == "hh":
                kw.setdefault("count_threshold", 8)
        else:
            k = kw.pop("k", 2)  # paper settles on k=2 for BSBF/BSBFSD/RLBSBF
        return DedupConfig(variant=variant, memory_bits=memory_bits, k=k,
                           fpr_t=fpr_t, **kw).validate()
