"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (DESIGN §3.4) — the port of ``repro/kernels``.

hashmix        — k-way murmur hashing (``csrc/hashmix.cu``)
bloom_probe    — packed-filter gather + bit test, and ``fused_probe``, the
                 whole probe of a batch in one launch (``csrc/bloom_probe.cu``)
scatter_delta  — OR-union of bit masks into a packed delta
                 (``csrc/scatter_delta.cu``)
fused_template — the fused steps: ``bitset_step`` and ``counter_step``
                 (``csrc/bitset_step.cu``, ``csrc/counter_step.cu``) and
                 ``make_fused_step``, the step of a ``SketchSpec``
common         — the reference's VMEM budget model and the card's
fused_step / fused_counter_step — deprecated names of the per-variant
                 factories (``make_fused_batched_step``,
                 ``make_fused_counter_step``, ``make_fused_swbf_step``)

``ops`` holds the public wrappers, ``ref`` the reference's oracle names
over the plain versions. Importing this package builds nothing: a kernel's
library is built at its first launch (``build``).
"""

from . import ops, ref
from .hashmix import hashmix
from .bloom_probe import bloom_probe
from .scatter_delta import scatter_delta
from .fused_template import make_fused_step
from .fused_step import make_fused_batched_step
from .fused_counter_step import make_fused_counter_step

__all__ = ["ops", "ref", "hashmix", "bloom_probe", "scatter_delta",
           "make_fused_step", "make_fused_batched_step",
           "make_fused_counter_step"]
