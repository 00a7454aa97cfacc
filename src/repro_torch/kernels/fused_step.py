"""Deprecated name: ``make_fused_batched_step``, the port of
``repro/kernels/fused_step.py``. The bitset-family step comes from
``fused_template.make_fused_step``; this module keeps the historical
factory importable, with the reference's warning and refusal."""

from __future__ import annotations

import warnings

from .common import DEFAULT_CHUNK_B, DEFAULT_TILE_W
from .fused_template import make_fused_step


def make_fused_batched_step(cfg, *, tile_w: int = DEFAULT_TILE_W,
                            chunk_b: int = DEFAULT_CHUNK_B,
                            interpret: bool | None = None, device=None):
    """Deprecated alias: the bitset-family step of ``make_fused_step`` —
    the same step and results. Refuses a counter-family variant."""
    warnings.warn(
        "repro_torch.kernels.fused_step.make_fused_batched_step is "
        "deprecated; use repro_torch.kernels.fused_template.make_fused_step "
        "instead", DeprecationWarning, stacklevel=2)
    cfg = cfg.validate()
    from ..core.sketch import get_spec
    spec = get_spec(cfg.variant)
    if spec.family != "bitset":
        raise ValueError(
            f"make_fused_batched_step serves the 1-bit (bitset) variants; "
            f"{cfg.variant!r} is counter-family — use "
            f"fused_template.make_fused_step")
    return make_fused_step(cfg, spec, tile_w=tile_w, chunk_b=chunk_b,
                           interpret=interpret, device=device)
