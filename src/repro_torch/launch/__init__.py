"""Launchers of the port: the H100's constants (``hw``), the production
and local meshes (``mesh``), the per-device step analysis (``analysis``),
the end-to-end training driver (``train``: ``python -m
repro_torch.launch.train``) and the multi-pod dry run (``dryrun``:
``python -m repro_torch.launch.dryrun``).

``dryrun`` and ``train`` are not imported here: importing this package
touches no process group and builds no model; the dry run brings up its
fake world in its own process. The reference's hill-climb waits for
ROADMAP item 13b.
"""

from . import analysis, hw
from .mesh import make_local_mesh, make_production_mesh

__all__ = ["make_local_mesh", "make_production_mesh", "analysis", "hw",
           "train"]
