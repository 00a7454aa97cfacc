"""Training substrate of the port (``repro.train``): the train step with
gradient accumulation, its placement on a mesh (``jit_sharded``) and the
fault-tolerant loop."""

from .steps import jit_sharded, make_train_step
from .trainer import (MeshShape, StragglerWatchdog, Trainer, TrainerConfig,
                      remesh)

__all__ = ["jit_sharded", "make_train_step", "MeshShape",
           "StragglerWatchdog", "Trainer", "TrainerConfig", "remesh"]
