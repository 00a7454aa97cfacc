"""Analytical model of the paper — Sections 3.1/3.2/4.1/4.3/5.1 — the port
of ``repro.core.theory``.

Implements the X_{m+1} recurrences that drive every theoretical claim:

  generic framework (Eqs. 3.1-3.7):
      Y_{m+1} = ((U-1)/U)^m
      FPR_{m+1} = Y_{m+1} * X_{m+1}
      FNR_{m+1} = (1 - Y_{m+1}) * (1 - X_{m+1})

  RSBF with p*  (Eqs. 3.27 / 3.28):
      m <= p:  X_{m+1} = [ X_m^{1/k} (X_m + (1-X_m)(1-1/m)) + (1-X_m)/m ]^k
      m  > p:  X_{m+1} = [ X_m^{1/k} (X_m + (1-X_m)(1-1/s)) + (1-X_m)/s ]^k

  BSBF   (Eq. 4.3):   X_{m+1} = [ X_m^{1/k} (X_m + (1-X_m)(1-1/s))  + (1-X_m)/s ]^k
  BSBFSD (Eq. 4.5):   X_{m+1} = [ X_m^{1/k} (X_m + (1-X_m)(1-1/(ks))) + (1-X_m)/s ]^k
  RLBSBF (Eq. 5.2):   X_{m+1} = [ X_m^{1/k} (X_m + (1-X_m)(1-L_m/s^2)) + (1-X_m)/s ]^k
      with the expected load evolved jointly:
      E[dL | insert] = (1 - L/s) - (L/s)^2 ;  P(insert) = reported-distinct.

The reference iterates ``x_series`` as a jitted float32 ``lax.scan``; here
it is the same float32 recurrence as a loop over numpy float32 scalars on
the host, operation for operation (Python floats enter as the reference's
weakly typed constants do, rounded to float32 where they meet a float32
value). Its ``power`` is numpy's, not XLA's, so the curves agree within
float32 rounding, not bit for bit: ``tests/test_torch_pipeline.py`` holds
them to rtol 1e-4 over n = 20000. The closed forms are copies.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from .config import DedupConfig, sbf_stable_zero_fraction

F32 = np.float32


class TheoryCurves(NamedTuple):
    m: np.ndarray      # stream positions (1-indexed)
    X: np.ndarray      # P(all k probed bits set)
    Y: np.ndarray      # P(element is actually distinct)
    fpr: np.ndarray
    fnr: np.ndarray
    load: np.ndarray | None  # expected per-filter load (RLBSBF only)


def y_series(m, universe: float) -> np.ndarray:
    """Eq. 3.7: Y_m = ((U-1)/U)^(m-1) — the probability that the element at
    1-indexed stream position m is distinct (the first element always is:
    Y_1 = 1). Computed in log space to survive m ~ 1e9."""
    m = np.asarray(m, dtype=np.float64)
    return np.exp((m - 1.0) * math.log1p(-1.0 / universe))


def _xk_update(x, k, leak, inject):
    """Common shape: [ x^{1/k} (x + (1-x)*leak) + (1-x)*inject ]^k, in
    float32."""
    root = np.power(np.maximum(x, F32(1e-30)), F32(1.0 / k))
    return np.power(root * (x + (F32(1) - x) * F32(leak))
                    + (F32(1) - x) * F32(inject), F32(k))


def x_series(cfg: DedupConfig, n: int, universe: float | None = None
             ) -> TheoryCurves:
    """Iterate the variant's recurrence for n steps."""
    cfg.validate()
    s, k = float(cfg.s), float(cfg.k)
    p_point = cfg.rsbf_phase3_start
    variant = cfg.variant
    if variant == "sbf":
        raise ValueError("SBF stability is closed-form; use sbf_stable_fpr")
    if variant == "swbf":
        raise ValueError("the windowed counting filter has no X_m "
                         "recurrence — its steady state is the window "
                         "occupancy (DESIGN §3.7)")
    if variant not in ("rsbf", "bsbf", "bsbfsd", "rlbsbf"):
        raise ValueError(variant)
    s32 = F32(s)
    x, load = F32(0), F32(0)
    xs = np.empty(n, dtype=np.float32)
    loads = np.empty(n, dtype=np.float32)
    for m in range(1, n + 1):
        mf = F32(m)
        if variant == "rsbf":
            # phase 1 (m <= s): every element inserted, no deletions —
            # plain Bloom fill; Eq. 3.27 covers phase 2 (1/m leak) and Eq.
            # 3.28 phase 3 (1/s)
            if mf <= s32:
                x_new = np.power(F32(1) - np.power(F32(1.0 - 1.0 / s), mf),
                                 F32(k))
            else:
                denom = max(mf, F32(2)) if m <= p_point else s32
                inv = F32(1) / denom
                x_new = _xk_update(x, k, F32(1) - inv, inv)
        elif variant == "bsbf":
            x_new = _xk_update(x, k, 1.0 - 1.0 / s, 1.0 / s)
        elif variant == "bsbfsd":
            x_new = _xk_update(x, k, 1.0 - 1.0 / (k * s), 1.0 / s)
        else:  # rlbsbf
            x_new = _xk_update(x, k, F32(1) - load / F32(s * s), 1.0 / s)
            p_insert = F32(1) - x                      # reported distinct
            ls = load / s32
            dload = p_insert * ((F32(1) - ls) - ls ** 2)
            load = np.clip(load + dload, F32(0), s32)
        x = np.clip(F32(x_new), F32(0), F32(1))
        xs[m - 1], loads[m - 1] = x, load
    xs64 = xs.astype(np.float64)
    m_np = np.arange(1, n + 1, dtype=np.float64)
    if universe is None:
        universe = float(cfg.s) * cfg.k  # a finite-universe default
    y = y_series(m_np, universe)
    return TheoryCurves(
        m=m_np, X=xs64, Y=y, fpr=y * xs64, fnr=(1 - y) * (1 - xs64),
        load=loads if variant == "rlbsbf" else None)


def rsbf_closed_form_fpr(cfg: DedupConfig, m: float, universe: float) -> float:
    """Eq. 3.8 — RSBF (no p*) closed-form FPR at stream length m."""
    s, k = float(cfg.s), float(cfg.k)
    y = math.exp(m * math.log1p(-1.0 / universe))
    bracket = 1.0 - k * s / m + ((1.0 - 1.0 / math.e) * s / m) ** k
    return y * max(0.0, bracket)


def rsbf_fnr_order(cfg: DedupConfig, universe: float) -> float:
    """Eq. 3.9 — FNR ~ O(k/U)."""
    return cfg.k / universe


def sbf_stable_fpr(cfg: DedupConfig) -> float:
    """Deng & Rafiei stable-point FPR for our configured (K, P, Max)."""
    zeros = sbf_stable_zero_fraction(
        float(cfg.sbf_p_effective), cfg.k, cfg.s, cfg.sbf_max)
    return (1.0 - zeros) ** cfg.k


def standard_bloom_fpr(n: float, m_bits: float, k: int) -> float:
    """Section 2 background: FPR ~ (1 - e^{-kn/m})^k."""
    return (1.0 - math.exp(-k * n / m_bits)) ** k


def verify_monotone_convergence(cfg: DedupConfig, n: int = 200_000
                                ) -> dict:
    """Numerical check of Theorem 3.1 / Lemma 1: X monotone non-decreasing,
    bounded by 1, and approaching 1."""
    curves = x_series(cfg, n)
    diffs = np.diff(curves.X)
    return {
        "monotone": bool((diffs >= -1e-9).all()),
        "bounded": bool((curves.X <= 1.0 + 1e-9).all()),
        "final_X": float(curves.X[-1]),
        "final_fnr_factor": float(1.0 - curves.X[-1]),
    }
