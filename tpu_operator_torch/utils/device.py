"""Device selection for the port's entry points.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``.
Without a CUDA card it raises: the port runs on the CPU only when the caller
asks for it, as the tests do, and never falls back there quietly.

Importing it also puts the port's spans (``utils/trace.py``) into
``torch.profiler``'s trace while the profiler records: every module that
runs device work imports it.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as autograd_profiler

from tpu_operator_torch.utils import trace


def _profiler_hook():
    """``utils/trace.py``'s profiler hook (``Tracer.profiler``):
    (recording, enter, exit). Whether the profiler records is asked of the
    profiler module's own flag first (true while any profiler runs in the
    process: a plain read, as on ``flash_attention``'s hot path), then of
    the calling thread's profiler state. The annotations are
    ``record_function``'s (``user_annotation`` in the Chrome trace), opened
    through the autograd profiler's own enter and exit calls, which cost a
    third of ``record_function``'s."""
    enabled = torch.autograd._profiler_enabled

    def recording():
        return autograd_profiler._is_profiler_enabled and enabled()
    return (recording, torch._C._autograd._record_function_with_args_enter,
            torch._C._autograd._record_function_with_args_exit)


trace.Tracer.profiler = _profiler_hook()


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
