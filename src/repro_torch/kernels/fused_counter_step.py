"""Deprecated names: ``make_fused_counter_step`` and
``make_fused_swbf_step``, the port of
``repro/kernels/fused_counter_step.py``. The counter-family steps come
from ``fused_template.make_fused_step``; this module keeps the historical
factories importable, with the reference's warnings and refusals."""

from __future__ import annotations

import warnings

from .common import DEFAULT_TILE_W
from .fused_template import make_fused_step


def _refuse_unless(ok: bool, cfg) -> None:
    # the reference refuses with a bare assert; this raises the same
    # AssertionError under ``python -O`` too
    if not ok:
        raise AssertionError(cfg)


def make_fused_counter_step(cfg, *, tile_w: int = DEFAULT_TILE_W,
                            interpret: bool | None = None, device=None):
    """Deprecated alias: the SBF counter-plane step of ``make_fused_step``
    — the same step and results. Takes sbf on the plane layout only."""
    warnings.warn(
        "repro_torch.kernels.fused_counter_step.make_fused_counter_step is "
        "deprecated; use repro_torch.kernels.fused_template.make_fused_step "
        "instead", DeprecationWarning, stacklevel=2)
    cfg = cfg.validate()
    _refuse_unless(cfg.variant == "sbf" and cfg.is_planes, cfg)
    return make_fused_step(cfg, tile_w=tile_w, interpret=interpret,
                           device=device)


def make_fused_swbf_step(cfg, *, tile_w: int = DEFAULT_TILE_W,
                         interpret: bool | None = None, device=None):
    """Deprecated alias: the SWBF sliding-window step of
    ``make_fused_step`` — the same step and results. Takes swbf only."""
    warnings.warn(
        "repro_torch.kernels.fused_counter_step.make_fused_swbf_step is "
        "deprecated; use repro_torch.kernels.fused_template.make_fused_step "
        "instead", DeprecationWarning, stacklevel=2)
    cfg = cfg.validate()
    _refuse_unless(cfg.variant == "swbf" and cfg.is_planes, cfg)
    return make_fused_step(cfg, tile_w=tile_w, interpret=interpret,
                           device=device)
