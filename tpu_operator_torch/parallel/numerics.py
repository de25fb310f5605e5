"""Derived comparison tolerances for cross-checking kernels and paths.

The port's copy of ``tpu_operator/parallel/numerics.py``. Every cross-check
compares a kernel or a fast path against a pinned-precision reference, and
the tolerance comes from the precision the multiplies actually run at and
the depth of the reduction, never from a magic constant.

The reference leaves GPUs out of its matrix-unit rule on purpose; the port
adds the CUDA one. bfloat16 operands multiply at bf16 precision everywhere
(unit roundoff 2^-8). An f32 matrix product on a CUDA card runs in TF32
(10 stored mantissa bits, unit roundoff 2^-11) when PyTorch is told to
allow it, through ``torch.backends.cuda.matmul.allow_tf32`` or a
``torch.get_float32_matmul_precision()`` other than ``"highest"``; otherwise
it runs in full f32. The CPU always honours the operand dtype.
"""

from __future__ import annotations

import math

import torch

_BF16_EPS = 2.0 ** -8
_TF32_EPS = 2.0 ** -11
_F32_EPS = float(torch.finfo(torch.float32).eps)


def _tf32_enabled() -> bool:
    return (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest")


def effective_matmul_eps(dtype: torch.dtype, platform: str = "cpu") -> float:
    """Unit roundoff of the multiply precision a matmul actually uses on
    ``platform`` (a device type, ``"cpu"`` or ``"cuda"``)."""
    if dtype == torch.bfloat16:
        return _BF16_EPS
    if platform == "cuda" and dtype == torch.float32 and _tf32_enabled():
        return _TF32_EPS
    return float(torch.finfo(dtype).eps)


def attention_tolerance(dtype: torch.dtype, head_dim: int,
                        platform: str = "cpu") -> float:
    """Absolute tolerance for an online-softmax attention path against the
    pinned-precision reference. Outputs are convex combinations of V rows,
    so the error does not grow with sequence length: the effective multiply
    precision of the score matmul (amplified through exp) dominates, plus
    f32 accumulation noise growing with the square root of the head
    dimension. Same formula as the reference."""
    eps_eff = effective_matmul_eps(dtype, platform)
    return 8.0 * eps_eff + 32.0 * _F32_EPS * math.sqrt(head_dim)


def reduction_tolerance(dtype: torch.dtype, n_terms: int) -> float:
    """rtol/atol for two association orders of the same ``n_terms``-deep
    reduction: worst-case relative error eps·n, with an 8x margin."""
    return 8.0 * float(torch.finfo(dtype).eps) * n_terms


def residual_tolerance(dtype: torch.dtype, n_layers: int, width: int,
                       platform: str = "cpu") -> float:
    """Tolerance, relative to the output's largest magnitude, for two
    implementations of an ``n_layers``-deep residual MLP whose widest
    reduction is ``width`` terms. Each layer rounds its matmul outputs, its
    activation and its residual sum at the effective precision (a few unit
    roundoffs, taken as 8), plus f32 accumulation noise growing with the
    square root of the width, as in :func:`attention_tolerance`; the layers'
    errors add."""
    per_layer = (8.0 * effective_matmul_eps(dtype, platform)
                 + 32.0 * _F32_EPS * math.sqrt(width))
    return n_layers * per_layer


def residual_limit(want: torch.Tensor, dtype: torch.dtype, n_layers: int,
                   platform: str = "cpu") -> torch.Tensor:
    """Per-element limit on |got − want| for an ``n_layers``-deep residual
    MLP run in ``dtype`` against ``want``, the same model in f32.

    The output's own rounding errs by at most eps·|want|. Each layer rounds
    its matmul outputs, its activation and its residual sum, errors of
    about eps times the activations, whose size is the output's rms; the
    layers' errors are independent and add in quadrature, to about
    √L·eps·rms. The limit allows four times that for the largest of the
    output's elements."""
    eps = effective_matmul_eps(dtype, platform)
    rms = want.float().pow(2).mean().sqrt()
    return eps * want.float().abs() + 4.0 * eps * math.sqrt(n_layers) * rms
