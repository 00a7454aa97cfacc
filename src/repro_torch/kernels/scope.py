"""Plain regions: where a kernel wrapper runs its kernel's plain version.

On a CPU tensor every kernel wrapper of this package runs the plain
PyTorch version of its kernel inside ``plain_region(name)``, and so do the
builders of operands that only a plain version reads (the counter
family's delta planes). A region marks the ops that stand in for one
kernel launch on the card: an observer (the dispatch trace of the
hot-path linter, ``repro_torch.analysis.trace_lint``) sees one kernel
event per outermost region and skips the ops inside it, so a trace taken
on the CPU holds the same glue that the card runs. A launch on the card
goes through ``ctypes`` and is never dispatched, so the card's trace holds
the glue only.

The depth and the observer are thread-local; with no observer a region
costs one attribute read and two writes.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Optional

_local = threading.local()


def depth() -> int:
    """How many plain regions this thread is inside."""
    return getattr(_local, "depth", 0)


@contextlib.contextmanager
def plain_region(name: str):
    """Run the body as the plain version of kernel ``name``."""
    d = depth()
    if d == 0:
        observer = getattr(_local, "observer", None)
        if observer is not None:
            observer(name)
    _local.depth = d + 1
    try:
        yield
    finally:
        _local.depth = d


@contextlib.contextmanager
def observing(observer: Optional[Callable[[str], None]]):
    """Call ``observer(name)`` as this thread enters each outermost plain
    region, until the block ends."""
    before = getattr(_local, "observer", None)
    _local.observer = observer
    try:
        yield
    finally:
        _local.observer = before
