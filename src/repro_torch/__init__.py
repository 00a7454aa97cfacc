"""repro_torch — the PyTorch / CUDA port of ``repro`` for NVIDIA Hopper.

Streaming approximate de-duplication after Bera, Dutta, Narang and
Bhattacherjee, "Advanced Bloom Filter Based Algorithms for Efficient
Approximate Data De-Duplication in Streams" (2012). The package imports
``torch`` and numpy, never ``jax`` and nothing of ``repro``; its tests hold
it bit for bit against ``repro`` on the CPU, and ``chip_smoke.py`` holds
each CUDA kernel against its plain PyTorch version on the card.

The reference's ``compat.py`` has no counterpart: each of its functions
resolves how one JAX version spells something (``shard_map``'s module,
``cost_analysis``' list or dict, ``set_mesh``, the threefry layout flag,
the jit cache count), which has no meaning under torch.
"""

from .core import DedupConfig, Dedup, FilterState, get_engine

__version__ = "0.1.0"
__all__ = ["DedupConfig", "Dedup", "FilterState", "get_engine"]
