"""Training substrate of the port (``repro.train``): the train step with
gradient accumulation and the fault-tolerant loop. ``jit_sharded`` waits
for the mesh launcher (ROADMAP item 14e)."""

from .steps import make_train_step
from .trainer import (MeshShape, StragglerWatchdog, Trainer, TrainerConfig,
                      remesh)

__all__ = ["make_train_step", "MeshShape",
           "StragglerWatchdog", "Trainer", "TrainerConfig", "remesh"]
