"""Optimizer substrate of the port (``repro.optim``)."""

from .optimizers import (OptimizerConfig, OptState, apply_updates,
                         clip_by_global_norm, global_norm, init_opt_state,
                         schedule)

__all__ = ["OptimizerConfig", "OptState", "apply_updates",
           "clip_by_global_norm", "global_norm", "init_opt_state",
           "schedule"]
