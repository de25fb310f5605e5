"""softmax(q·Kᵀ/√D)·V in plain PyTorch, in blocks of query rows."""

from __future__ import annotations

import math

import torch

from port_bench.reference.precision import fp8, pinned_f32

BLOCK_ROWS = 1024


def attention(q, k, v, causal: bool, quantize=None) -> torch.Tensor:
    """Attention of [T, D] or [H, T, D] inputs in float32, with TF32 off,
    a block of :data:`BLOCK_ROWS` query rows at a time so that the scores
    of a long sequence never exist whole; the causal mask keeps the keys
    at or before each query. ``quantize`` (the control) rounds the inputs
    and the output to a lower precision."""
    if q.dim() == 3:
        return torch.stack([attention(*x, causal, quantize)
                            for x in zip(q, k, v)])
    rnd = quantize or (lambda x: x.float())
    q, k, v = rnd(q), rnd(k), rnd(v)
    t, d = q.shape
    out = torch.empty((t, d), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(d)
    with pinned_f32():
        for r0 in range(0, t, BLOCK_ROWS):
            r1 = min(t, r0 + BLOCK_ROWS)
            keys = r1 if causal else t
            s = (q[r0:r1] @ k[:keys].T) * scale
            if causal:
                rows = torch.arange(r0, r1, device=q.device)[:, None]
                cols = torch.arange(keys, device=q.device)[None, :]
                s = s.masked_fill(cols > rows, float("-inf"))
            out[r0:r1] = torch.softmax(s, dim=-1) @ v[:keys]
    return rnd(out)


def attention_fp8(q, k, v, causal: bool) -> torch.Tensor:
    """The control of a bf16 attention: inputs and output in fp8."""
    return attention(q, k, v, causal, quantize=fp8)


def max_abs_err(out: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest |out - ref| over every element, as a float (inf where
    the shapes differ or an element is not finite)."""
    if out.shape != ref.shape:
        return math.inf
    err = (out.float() - ref.float()).abs().max().item()
    return err if math.isfinite(err) else math.inf
