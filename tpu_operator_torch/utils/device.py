"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a CUDA card it raises: the port runs on the CPU only when the caller
asks for it, as the tests do, and never falls back there quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_kind(device: torch.device) -> str:
    """The card's product name (``torch.cuda.get_device_name``), or the
    device type for the CPU: the key of the peak tables."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type
