"""The port's device rule: every entry point runs on ``cuda`` unless the
caller passes ``device="cpu"``. Without a CUDA device and without that
request it raises; it never falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` by default; raises when the card is missing and the caller
    did not ask for the CPU."""
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"device {device} is neither cpu nor cuda")
    return device
