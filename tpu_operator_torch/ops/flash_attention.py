"""Single-card flash attention (forward) on a hand-written CUDA kernel.

The port of ``tpu_operator/ops/flash_attention.py``. The burn-in matmul
proves raw tensor-core throughput; this kernel proves the composed pattern
long-context workloads run: blockwise q·Kᵀ, online softmax, ·V, never
materialising the [T, T] score matrix. ``csrc/flash_fwd.cu`` says what
bounds it on the card and how its design answers that.

Inputs are [T, D], or [H, T, D] with the heads as a grid axis (the
counterpart of the reference's ``jax.vmap`` contract). The kernel's tiles
are 64 query rows by 64 key rows; the reference's ``DEFAULT_BLOCKS`` were
sized for a TPU's VMEM and do not carry over.

:func:`flash_attention` launches the kernel for CUDA tensors (bf16 only)
and runs the plain PyTorch version, :func:`attention_plain`, only for CPU
tensors.
"""

from __future__ import annotations

import math

import torch

from tpu_operator_torch import _native
from tpu_operator_torch.parallel.numerics import effective_matmul_eps
from tpu_operator_torch.parallel.ring_attention import (_softmax_attention,
                                                        pinned_f32,
                                                        softmax_weights)

BLOCK = 64          # the kernel's q and kv tile rows (kBlockQ, kBlockK)
HEAD_DIM = 128      # the head dimension the kernel is built for


def attention_plain(q, k, v, sm_scale: float | None = None,
                    causal: bool = False):
    """The kernel's function in plain PyTorch: dense f32
    softmax(q·Kᵀ·scale)·V with the same scale and causal mask, returned in
    the input dtype. Takes any floating dtype."""
    return _softmax_attention(q, k, v, causal, sm_scale)


def kernel_error_limit(q, k, v, sm_scale: float | None = None,
                       causal: bool = False):
    """The f32 output of the plain version, and a per-element limit on how
    far a bf16 kernel's output may lie from it.

    The kernel, like the reference's, computes the scores, the softmax
    state and the output accumulator in f32, but rounds the probabilities
    P to bf16 before P·V and rounds the output to bf16 (unit roundoff u).
    The output's rounding errs by at most u·|o|. P's rounding adds
    Σ_j p_j·δ_j·v_j with independent |δ_j| ≤ u: a sum whose standard
    deviation is at most u/√3·√(Σ_j p_j²·v_j²). The limit allows 4·u times
    that root, about seven standard deviations. It scales with each
    output element, so a kernel that drops or mis-weights a kv tile, or
    scales its output by 1 + 1/64, exceeds it where an absolute tolerance
    set by the largest outputs would not see it.
    """
    u = effective_matmul_eps(torch.bfloat16)
    with pinned_f32():
        w = softmax_weights(q, k, sm_scale, causal)
        vf = v.float()
        ref = torch.matmul(w, vf)
        spread = torch.matmul(w * w, vf * vf).sqrt()
    return ref, u * ref.abs() + 4.0 * u * spread


def flash_attention(q, k, v, sm_scale: float | None = None,
                    causal: bool = False, block_q: int | None = None,
                    block_k: int | None = None):
    """softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or [H, T, D].

    T must divide by the blocks (pad upstream); ``sm_scale`` defaults to
    1/√D; the output has the input dtype. On a CUDA tensor the blocks must
    be the kernel's own (``BLOCK``), the dtype bf16 and D ``HEAD_DIM``.
    """
    if q.dim() not in (2, 3) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [T, D] or [H, T, D] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    t, d = q.shape[-2:]
    block_q = min(block_q or BLOCK, t)
    block_k = min(block_k or BLOCK, t)
    if t % block_q or t % block_k:
        raise ValueError(f"T={t} not divisible by blocks "
                         f"({block_q}, {block_k})")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if (block_q, block_k) != (BLOCK, BLOCK):
        raise ValueError(f"the CUDA kernel's tiles are {BLOCK}x{BLOCK} rows, "
                         f"got blocks ({block_q}, {block_k})")
    if d != HEAD_DIM:
        raise ValueError(f"the CUDA kernel takes head dim {HEAD_DIM}, "
                         f"got {d}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device or x.dtype != torch.bfloat16 \
                or not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"bfloat16 tensor on {q.device}, got {x.dtype} "
                             f"on {x.device}")
    lib = _native.library()
    out = torch.empty_like(q)
    heads = 1 if q.dim() == 2 else q.shape[0]
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), heads, t, d, scale,
                                 int(causal),
                                 torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_bf16")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
