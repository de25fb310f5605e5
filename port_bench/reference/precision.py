"""Pinned float32 and the lower precisions of the controls."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0   # the largest finite float8 e4m3fn value


@contextlib.contextmanager
def pinned_f32():
    """Float32 matrix products without TF32 for the duration of the
    block; the caller's settings come back afterwards."""
    precision = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        if torch.backends.cuda.matmul.allow_tf32:
            raise RuntimeError("TF32 is still on inside the reference")
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale for the whole tensor
    (its largest magnitude onto 448, as fp8 kernels scale their operands),
    returned in float32."""
    x = x.float()
    amax = x.abs().max()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return (x / scale).to(torch.float8_e4m3fn).float() * scale
