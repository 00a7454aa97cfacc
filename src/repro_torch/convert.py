"""State and config carried across between the JAX package and the port.

A filter state is the system's "weights": a stream started under one
framework continues under the other from the same leaves —

    {"bits": (k, W) | (d, 1, W) | (1, W) uint32, "position": () int32,
     "load": (k,) int32, "rng": (2,) uint32}

plus, for swbf, ``"ring_events"`` (window, E) int32 and ``"ring_slot"`` ()
int32 — the reference's ``state.ring.events`` and ``state.ring.slot``.
``bits`` is the bitset family's (k, W) rows or the counter family's
(d, 1, W) bit-planes, squeezed to (1, W) at d == 1; ``rng`` is
``jax.random.key_data(state.rng)``. ``state_from_numpy`` builds the port's
``FilterState`` from such a dict, ``state_to_numpy`` returns one with the
same dtypes and bytes, and ``config_from_dict`` takes a config from
``dataclasses.asdict`` of either package's ``DedupConfig``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core import u32
from .core.config import DedupConfig
from .core.device import resolve_device
from .core.state import FilterState, WindowRing, bits_shape


def config_from_dict(d: dict) -> DedupConfig:
    names = {f.name for f in dataclasses.fields(DedupConfig)}
    unknown = set(d) - names
    if unknown:
        raise ValueError(f"unknown DedupConfig fields {sorted(unknown)}")
    return DedupConfig(**d).validate()


def state_from_numpy(leaves: dict, cfg: DedupConfig, device=None
                     ) -> FilterState:
    device = resolve_device(device)
    shape = bits_shape(cfg)
    bits = np.asarray(leaves["bits"])
    load = np.asarray(leaves["load"])
    rng = np.asarray(leaves["rng"])
    position = np.asarray(leaves["position"])
    if bits.shape != shape or bits.dtype != np.uint32:
        raise ValueError(f"bits must be uint32 {shape} for this config, "
                         f"got {bits.dtype} {bits.shape}")
    if load.shape != (cfg.n_rows,) or rng.shape != (2,) or position.shape:
        raise ValueError(f"load ({cfg.n_rows},), rng (2,) and a scalar "
                         f"position expected; got {load.shape}, "
                         f"{rng.shape}, {position.shape}")
    ring = None
    if cfg.variant == "swbf":
        events = np.asarray(leaves["ring_events"])
        slot = np.asarray(leaves["ring_slot"])
        if (events.ndim != 2 or events.shape[0] != cfg.window
                or events.dtype != np.int32 or slot.shape):
            raise ValueError(f"ring_events must be int32 ({cfg.window}, E) "
                             f"and ring_slot a scalar; got {events.dtype} "
                             f"{events.shape} and {slot.shape}")
        ring = WindowRing(
            events=torch.from_numpy(events.copy()).to(device),
            slot=torch.tensor(int(slot), dtype=torch.int32, device=device))
    return FilterState(
        bits=u32.from_numpy_u32(bits, device),
        position=torch.tensor(int(position), dtype=torch.int32,
                              device=device),
        load=torch.from_numpy(load.astype(np.int32)).to(device),
        rng=u32.from_numpy_u32(rng, device),
        ring=ring,
    )


def state_to_numpy(state: FilterState) -> dict:
    leaves = {
        "bits": u32.to_numpy_u32(state.bits),
        "position": np.asarray(int(state.position), dtype=np.int32),
        "load": state.load.detach().cpu().numpy().astype(np.int32),
        "rng": u32.to_numpy_u32(state.rng),
    }
    if state.ring is not None:
        leaves["ring_events"] = state.ring.events.detach().cpu().numpy()
        leaves["ring_slot"] = np.asarray(int(state.ring.slot),
                                         dtype=np.int32)
    return leaves
