"""Ring attention over a mesh axis, and the pinned-precision oracle.

The port of ``tpu_operator/parallel/ring_attention.py``'s ring attention
(``_online_block``, ``ring_attention_shard``, ``ring_attention``) and of
``_softmax_attention`` and ``reference_attention``: the O(T²)-memory
softmax(q·Kᵀ)·V that every attention cross-check compares against. The
Ulysses scheme of that module is not ported yet.

Ring attention: each rank holds a contiguous block of the sequence. Queries
stay put; the K/V blocks hop one rank per step (``collectives.ppermute``)
while an online softmax in f32 folds each block in, the rank's own block
first. After n - 1 hops every query has seen the whole sequence, and no rank
held more than its 1/n of K/V.

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

from tpu_operator_torch.parallel.collectives import ppermute
from tpu_operator_torch.parallel.mesh import Mesh


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


def _online_block(m, l, acc, scores, v_blk):
    """Fold one K/V block into the running softmax state: m [..., Tq]
    running max, l [..., Tq] normalizer, acc [..., Tq, D] unnormalized
    output; scores [..., Tq, Tkv], v_blk [..., Tkv, D]."""
    m_new = torch.maximum(m, scores.max(dim=-1).values)
    p = torch.exp(scores - m_new[..., None])
    scale = torch.exp(m - m_new)
    l_new = l * scale + p.sum(dim=-1)
    acc_new = acc * scale[..., None] + p @ v_blk
    return m_new, l_new, acc_new


def ring_attention_shard(qs, ks, vs, mesh: Mesh, axis_name: str,
                         sm_scale: float | None = None,
                         causal: bool = False):
    """Attention for every rank's query block (``qs[r]``: [Tq_local, D]),
    with the global K/V distributed around ``axis_name`` (``ks[r]``,
    ``vs[r]``: [Tkv_local, D]). Returns each rank's [Tq_local, D] block of
    softmax(q·Kᵀ)·V over the full sequence. ``causal`` masks keys at global
    positions after each query's own, the diagonal kept; block b covers
    positions [b·Tkv, (b+1)·Tkv)."""
    n = mesh.shape[axis_name]
    d = qs[0].shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    perm = [(i, (i + 1) % n) for i in range(n)]
    tq, tkv = qs[0].shape[0], ks[0].shape[0]
    pos = [mesh.coords(r)[axis_name] for r in range(mesh.size)]

    def fold(r, state, k_blk, v_blk, src_block):
        q = qs[r]
        scores = (q.float() @ k_blk.float().T) * scale
        if causal:
            q_pos = pos[r] * tq + torch.arange(tq, device=q.device)
            k_pos = src_block * tkv + torch.arange(tkv, device=q.device)
            # a large finite fill, not -inf: a block whose rows are all
            # masked would give exp(-inf - -inf) = nan; -1e30 underflows to
            # 0 and never wins the running max, as the local block folds
            # first
            scores = torch.where(k_pos[None, :] > q_pos[:, None],
                                 torch.tensor(-1e30, device=q.device),
                                 scores)
        return _online_block(*state, scores, v_blk.float())

    states = [(torch.full((tq,), float("-inf"), device=q.device),
               torch.zeros((tq,), device=q.device),
               torch.zeros((tq, d), device=q.device)) for q in qs]
    states = [fold(r, states[r], ks[r], vs[r], pos[r])
              for r in range(mesh.size)]
    k_blks, v_blks = list(ks), list(vs)
    for i in range(n - 1):
        k_blks = ppermute(k_blks, mesh, axis_name, perm)
        v_blks = ppermute(v_blks, mesh, axis_name, perm)
        # after hop i+1 a rank holds the block that started i+1 ranks back
        states = [fold(r, states[r], k_blks[r], v_blks[r],
                       (pos[r] - i - 1) % n) for r in range(mesh.size)]
    return [(acc / l[..., None]).to(q.dtype)
            for q, (_, l, acc) in zip(qs, states)]


def ring_attention(q, k, v, mesh: Mesh, axis_name: str = "model",
                   sm_scale: float | None = None, causal: bool = False):
    """Sequence-parallel attention: ``q``, ``k``, ``v`` are whole [T, D]
    tensors, split on axis 0 over ``axis_name`` (replicated over the other
    axes); returns the whole output, assembled from the first group. T must
    divide evenly across the axis."""
    n = mesh.shape[axis_name]
    if q.shape[0] % n or k.shape[0] % n:
        raise ValueError(f"sequence {q.shape[0]} not divisible by {n}")

    def shards(t):
        parts = t.chunk(n)
        return [parts[mesh.coords(r)[axis_name]].to(mesh.device(r))
                for r in range(mesh.size)]

    outs = ring_attention_shard(shards(q), shards(k), shards(v), mesh,
                                axis_name, sm_scale, causal)
    return torch.cat([outs[r] for r in mesh.groups(axis_name)[0]])
