"""The pinned-precision attention oracle.

The port of ``_softmax_attention`` and ``reference_attention`` from
``tpu_operator/parallel/ring_attention.py``: the O(T²)-memory
softmax(q·Kᵀ)·V that every attention cross-check compares against. The
ring and Ulysses schemes of that module are multi-device and not ported yet.

Its precision is pinned: f32 operands, f32 accumulation, and no TF32. A
float32 matmul on a CUDA card may run in TF32 when
``torch.backends.cuda.matmul.allow_tf32`` is set (or the float32 matmul
precision is not ``"highest"``), and cuDNN allows TF32 by default
(``torch.backends.cudnn.allow_tf32``). The oracle turns both off for the
duration of the call, asserts that they are off, and restores the caller's
settings afterwards, so it never changes them for the rest of the process.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def pinned_f32():
    """Matrix products in full f32 (no TF32) for the duration of the block;
    the caller's settings come back afterwards."""
    precision = torch.get_float32_matmul_precision()
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        if torch.backends.cuda.matmul.allow_tf32 \
                or torch.backends.cudnn.allow_tf32:
            raise RuntimeError("TF32 still enabled inside the oracle")
        yield
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn_tf32


def softmax_weights(q, k, sm_scale: float | None = None,
                    causal: bool = False):
    """softmax(q·Kᵀ·scale) in f32 over the last two axes, the scale 1/√D by
    default; the causal mask fills with -inf, as in the reference."""
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal:
        t = q.shape[-2]
        keep = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        scores = torch.where(keep, scores, float("-inf"))
    return torch.softmax(scores, dim=-1)


def _softmax_attention(q, k, v, causal: bool, sm_scale: float | None = None):
    """softmax(q·Kᵀ·scale)·V in f32, returned in the input dtype."""
    w = softmax_weights(q, k, sm_scale, causal)
    return torch.matmul(w, v.float()).to(q.dtype)


def reference_attention(q, k, v, causal: bool = False):
    """The oracle side of every attention cross-check, at pinned f32
    precision. Tolerances against it come from
    ``tpu_operator_torch.parallel.numerics.attention_tolerance``."""
    with pinned_f32():
        return _softmax_attention(q, k, v, causal)
