"""State and config carried across between the JAX package and the port.

A filter state is the system's "weights": a stream started under one
framework continues under the other from the same four leaves —

    {"bits": (k, W) uint32, "position": () int32, "load": (k,) int32,
     "rng": (2,) uint32}

where ``rng`` is ``jax.random.key_data(state.rng)``. ``state_from_numpy``
builds the port's ``FilterState`` from such a dict, ``state_to_numpy``
returns one with the same dtypes and bytes, and ``config_from_dict`` takes
a config from ``dataclasses.asdict`` of either package's ``DedupConfig``.
The plane layout at d = 1 is the only state shape this slice carries.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import u32
from .core.config import DedupConfig
from .core.device import resolve_device
from .core.state import FilterState


def config_from_dict(d: dict) -> DedupConfig:
    names = {f.name for f in dataclasses.fields(DedupConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown DedupConfig fields {sorted(unknown)}")
    return DedupConfig(**d).validate()


def state_from_numpy(leaves: dict, cfg: DedupConfig, device=None
                     ) -> FilterState:
    device = resolve_device(device)
    k, w = cfg.n_rows, cfg.s_words
    bits = np.asarray(leaves["bits"])
    load = np.asarray(leaves["load"])
    rng = np.asarray(leaves["rng"])
    position = np.asarray(leaves["position"])
    if bits.shape != (k, w) or bits.dtype != np.uint32:
        raise ValueError(f"bits must be uint32 {(k, w)} for this config, "
                         f"got {bits.dtype} {bits.shape}")
    if load.shape != (k,) or rng.shape != (2,) or position.shape != ():
        raise ValueError(f"load (k,), rng (2,) and a scalar position "
                         f"expected; got {load.shape}, {rng.shape}, "
                         f"{position.shape}")
    return FilterState(
        bits=u32.from_numpy_u32(bits, device),
        position=torch.tensor(int(position), dtype=torch.int32,
                              device=device),
        load=torch.from_numpy(load.astype(np.int32)).to(device),
        rng=u32.from_numpy_u32(rng, device),
    )


def state_to_numpy(state: FilterState) -> dict:
    return {
        "bits": u32.to_numpy_u32(state.bits),
        "position": np.asarray(int(state.position), dtype=np.int32),
        "load": state.load.detach().cpu().numpy().astype(np.int32),
        "rng": u32.to_numpy_u32(state.rng),
    }
