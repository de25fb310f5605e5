"""The burn-in model: a residual MLP, the flagship device workload.

The port of ``tpu_operator/ops/burnin.py``'s forward pass. Parameters stay
stacked by layer (``w_in`` [L, d, h], ``w_out`` [L, h, d]), in bf16 by
default, and each layer computes ``h + gelu(h @ w_in) @ w_out`` in the
activations' dtype. ``jax.nn.gelu`` defaults to the tanh approximation, so
the port uses ``F.gelu(approximate="tanh")``.

Weights come from a seeded ``torch.Generator``; they do not reproduce JAX's
draws, and nothing relies on them doing so. :func:`params_from_jax` moves
JAX-initialised parameters across through numpy, which is how the parity
tests compare the two packages. The train step is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_operator_torch.utils.device import resolve_device


@dataclass(frozen=True)
class BurninConfig:
    d_model: int = 512
    d_hidden: int = 2048
    n_layers: int = 4
    batch: int = 32
    dtype: torch.dtype = torch.bfloat16
    learning_rate: float = 1e-3

    def flops_per_step(self) -> int:
        # fwd + bwd ~= 3x fwd matmul FLOPs
        fwd = 2 * self.batch * (self.d_model * self.d_hidden * 2) * self.n_layers
        return 3 * fwd


class BurninModel(nn.Module):
    """Residual MLP over layer-stacked weights."""

    def __init__(self, w_in: torch.Tensor, w_out: torch.Tensor):
        super().__init__()
        if w_in.dim() != 3 or w_out.shape != (w_in.shape[0], w_in.shape[2],
                                              w_in.shape[1]):
            raise ValueError(f"need w_in [L,d,h] and w_out [L,h,d], got "
                             f"{tuple(w_in.shape)} and {tuple(w_out.shape)}")
        self.w_in = nn.Parameter(w_in)
        self.w_out = nn.Parameter(w_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for w_in, w_out in zip(self.w_in, self.w_out):
            y = F.gelu(h @ w_in, approximate="tanh") @ w_out
            h = (h + y).to(h.dtype)
        return h


def init_burnin(cfg: BurninConfig = BurninConfig(), seed: int = 42,
                device="cuda") -> BurninModel:
    """Random weights scaled by 1/√fan-in, drawn from a seeded generator."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape_in = (cfg.n_layers, cfg.d_model, cfg.d_hidden)
    shape_out = (cfg.n_layers, cfg.d_hidden, cfg.d_model)
    w_in = torch.randn(shape_in, generator=gen, device=dev) \
        / math.sqrt(cfg.d_model)
    w_out = torch.randn(shape_out, generator=gen, device=dev) \
        / math.sqrt(cfg.d_hidden)
    return BurninModel(w_in.to(cfg.dtype), w_out.to(cfg.dtype))


def _tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    # JAX's bf16 arrays reach numpy as ml_dtypes.bfloat16, which
    # torch.from_numpy refuses: widen to f32 (lossless) and narrow back
    if a.dtype.name == "bfloat16":
        wide = torch.tensor(np.asarray(a, np.float32))
        return wide.to(device=device, dtype=torch.bfloat16)
    return torch.tensor(a, device=device)


def params_from_jax(params: dict, device="cuda") -> BurninModel:
    """A :class:`BurninModel` holding the reference's parameters
    (``{"w_in", "w_out"}`` as numpy arrays), in their dtype."""
    dev = resolve_device(device)
    return BurninModel(_tensor_from_numpy(np.asarray(params["w_in"]), dev),
                       _tensor_from_numpy(np.asarray(params["w_out"]), dev))
