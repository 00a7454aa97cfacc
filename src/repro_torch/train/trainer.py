"""Fault-tolerant training loop — the port of ``repro.train.trainer``:
dedup-gated data, a straggler watchdog, checkpoint/restart and an elastic
re-mesh helper.

Failure model (what survives what):
  * step exception / injected fault  -> restore from the latest checkpoint
    (params, optimizer, *and the dedup filter state incl. stream
    position*), then continue; bounded retries;
  * straggler steps                   -> wall-clock EWMA; steps slower than
    ``straggler_sigma`` deviations are logged and counted;
  * device-set change (elastic)       -> ``remesh()`` shrinks the mesh to
    the live devices; a checkpoint restores onto whatever the new
    template holds (leaves are host npz).

The step's one wait is the host read of its loss (``float(loss)``, the
reference's ``jax.block_until_ready`` then ``float``), so a step's wall
clock ends when the card has finished it. The data draw (``next(data)``)
stays outside that clock, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
import os
import tempfile
import time
from typing import Callable, Iterator, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import CheckpointManager
from ..dedup.pipeline import DedupPipeline


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = dataclasses.field(default_factory=lambda: os.path.join(
        tempfile.gettempdir(), "repro_ckpt"))
    keep_n: int = 3
    max_retries: int = 3
    straggler_sigma: float = 3.0
    log_every: int = 10


class StragglerWatchdog:
    """EWMA of step wall-clock; flags outliers (mean + sigma * std)."""

    def __init__(self, sigma: float, alpha: float = 0.1):
        self.sigma = sigma
        self.alpha = alpha
        self.mean = None
        self.var = 0.0
        self.flagged = 0

    def observe(self, dt: float) -> bool:
        if self.mean is None:
            self.mean = dt
            return False
        slow = dt > self.mean + self.sigma * math.sqrt(self.var) + 1e-4
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if slow:
            self.flagged += 1
        return slow


class Trainer:
    def __init__(self, cfg: TrainerConfig, train_step: Callable,
                 params, opt_state, data: Iterator[dict],
                 dedup: Optional[DedupPipeline] = None,
                 batch_to_inputs: Optional[Callable] = None,
                 fault_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.train_step = train_step
        self.params = params
        self.opt_state = opt_state
        self.data = data
        self.dedup = dedup
        self.batch_to_inputs = batch_to_inputs or (lambda b: b)
        self.fault_hook = fault_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep_n=cfg.keep_n)
        self.watchdog = StragglerWatchdog(cfg.straggler_sigma)
        self.step = 0
        self.history: list[dict] = []

    # -------------------------------------------------------------- //
    def _state_tree(self):
        tree = {"params": self.params, "opt_state": self.opt_state}
        if self.dedup is not None:
            tree["dedup"] = self.dedup.state_dict()
        return tree

    def _load_state_tree(self, tree):
        self.params = tree["params"]
        self.opt_state = tree["opt_state"]
        if self.dedup is not None and "dedup" in tree:
            self.dedup.load_state_dict(tree["dedup"])

    def save(self):
        self.ckpt.save(self.step, self._state_tree())

    def try_restore(self) -> bool:
        step, tree = self.ckpt.restore_latest(self._state_tree())
        if step is None:
            return False
        self._load_state_tree(tree)
        self.step = step
        return True

    # -------------------------------------------------------------- //
    def _one_step(self, batch: dict):
        weights = None
        if self.dedup is not None:
            db = self.dedup.process(batch)
            batch, weights = db.data, db.weights
        inputs = self.batch_to_inputs(batch)
        self.params, self.opt_state, metrics = self.train_step(
            self.params, self.opt_state, inputs, weights)
        return metrics

    def run(self) -> dict:
        retries = 0
        while self.step < self.cfg.total_steps:
            batch = next(self.data)
            t0 = time.perf_counter()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(self.step)     # may raise (fault injection)
                metrics = self._one_step(batch)
                loss = float(metrics["loss"])      # the step's one wait
            except Exception as e:              # noqa: BLE001 — recovery path
                retries += 1
                if retries > self.cfg.max_retries:
                    raise RuntimeError(
                        f"step {self.step}: retries exhausted") from e
                restored = self.try_restore()
                print(f"[trainer] step {self.step} failed ({type(e).__name__}:"
                      f" {e}); restored={restored}; retry {retries}")
                continue
            dt = time.perf_counter() - t0
            slow = self.watchdog.observe(dt)
            self.step += 1
            rec = {"step": self.step, "loss": loss, "dt": dt,
                   "straggler": slow}
            self.history.append(rec)
            if self.step % self.cfg.log_every == 0:
                print(f"[trainer] step {self.step} "
                      f"loss={rec['loss']:.4f} dt={dt*1e3:.1f}ms"
                      + (" STRAGGLER" if slow else ""))
            if self.step % self.cfg.ckpt_every == 0:
                self.save()
        self.save()
        return {
            "final_loss": self.history[-1]["loss"] if self.history else None,
            "steps": self.step,
            "stragglers": self.watchdog.flagged,
        }


class MeshShape(NamedTuple):
    """``remesh``'s answer where no process group is up: the reference
    mesh's axis names, sizes (``shape``, a dict as ``jax.sharding.Mesh``
    gives it) and the devices laid out in that shape."""
    axis_names: tuple
    shape: dict
    devices: np.ndarray


def _live_devices() -> list:
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def remesh(axis_sizes: dict, devices=None):
    """Elastic re-mesh: shrink the ``data`` then the ``pod`` axis (halving)
    until the mesh fits the live devices, keeping every axis name; raise
    if it cannot fit. The live devices are the process group's ranks where
    one is up, else this host's cards (the CPU where there are none).

    -> a ``torch.distributed.device_mesh.DeviceMesh`` over the first n
    ranks where a process group is up; otherwise a ``MeshShape`` record of
    the names, sizes and devices. A checkpoint saved on the old mesh
    restores onto the new one through ``CheckpointManager`` (leaves are
    host npz; placement follows the new template)."""
    grouped = devices is None and dist.is_available() and dist.is_initialized()
    if devices is None:
        devices = (list(range(dist.get_world_size())) if grouped
                   else _live_devices())
    n = int(np.prod(list(axis_sizes.values())))
    if len(devices) < n:
        axis_sizes = dict(axis_sizes)
        for ax in ("data", "pod"):
            while (ax in axis_sizes and axis_sizes[ax] > 1
                   and int(np.prod(list(axis_sizes.values()))) > len(devices)):
                axis_sizes[ax] //= 2
        n = int(np.prod(list(axis_sizes.values())))
    if len(devices) < n:
        raise ValueError(f"cannot fit mesh {axis_sizes} on {len(devices)} devices")
    names = tuple(axis_sizes.keys())
    if grouped:
        from ..distributed.sharding import MeshAxes
        from ..launch.mesh import mesh_over_ranks
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        return mesh_over_ranks(MeshAxes(names, dict(axis_sizes)), kind)
    layout = np.empty(n, dtype=object)
    layout[:] = list(devices[:n])
    return MeshShape(names, dict(axis_sizes),
                     layout.reshape(*axis_sizes.values()))

