"""Mesh builders — the port of ``repro.launch.mesh``: the production
meshes and the local one, as ``torch.distributed`` ``DeviceMesh``es over
the live process group.

Functions, never module constants: importing this module touches no
process group (the dry run brings up its fake 256- or 512-rank world
first, tests and the card keep theirs). The device type is ``cuda``
unless the caller passes ``device="cpu"``; without a card and without
that request they raise (``core/device.py``).
"""

from __future__ import annotations

import math

import torch

from ..core.device import resolve_device
from ..distributed.sharding import MeshAxes


def production_axes(multi_pod: bool = False) -> MeshAxes:
    """Single pod: (data=16, model=16) = 256 chips. Multi-pod: (pod=2,
    data=16, model=16) = 512 chips. Names and sizes only."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshAxes(names, dict(zip(names, shape)))


def mesh_over_ranks(axes: MeshAxes, device=None):
    """A ``DeviceMesh`` of ``axes`` over the first ranks of the live
    process group, in row-major order."""
    from torch.distributed.device_mesh import DeviceMesh
    kind = resolve_device(device).type
    sizes = [axes.shape[a] for a in axes.axis_names]
    return DeviceMesh(kind, torch.arange(math.prod(sizes)).reshape(sizes),
                      mesh_dim_names=tuple(axes.axis_names))


def make_production_mesh(multi_pod: bool = False, device=None):
    """The production mesh over a process group of 256 (512) ranks."""
    return mesh_over_ranks(production_axes(multi_pod), device)


def make_local_mesh(model: int = 1, device=None):
    """("data", "model") over every rank of the live process group —
    used by tests, the card's smoke run and ``train.remesh``."""
    import torch.distributed as dist
    n = dist.get_world_size()
    data = max(1, n // model)
    return mesh_over_ranks(MeshAxes(("data", "model"),
                                    {"data": data, "model": model}), device)
