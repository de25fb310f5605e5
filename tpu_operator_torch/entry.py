"""Entry point: the burn-in forward pass on the card.

The port's counterpart of ``__graft_entry__.entry()``, at the model's full
width (``BurninConfig()`` defaults) rather than the reference's small
compile-check size.
"""

from __future__ import annotations

import torch

from tpu_operator_torch.ops.burnin import BurninConfig, init_burnin
from tpu_operator_torch.utils.device import resolve_device


def entry(device="cuda"):
    """Return ``(fn, args)``: the burn-in model and its input, on
    ``device``. ``fn(*args)`` runs the forward pass."""
    dev = resolve_device(device)
    cfg = BurninConfig()
    model = init_burnin(cfg, device=dev)
    x = torch.ones((cfg.batch, cfg.d_model), dtype=cfg.dtype, device=dev)
    return model, (x,)
