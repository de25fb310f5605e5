"""Sequence-parallel attention over a mesh axis (ring and Ulysses), and the
pinned-precision oracle.

The port of ``tpu_operator/parallel/ring_attention.py``: ring attention
(``_online_block``, ``ring_attention_shard``, ``ring_attention``), Ulysses
attention (``ulysses_attention``), and ``_softmax_attention`` and
``reference_attention``: the O(T²)-memory softmax(q·Kᵀ)·V that every
attention cross-check compares against.

Ring attention: each rank holds a contiguous block of the sequence. Queries
stay put; the K/V blocks hop one rank per step (``collectives.ppermute``)
while an online softmax in f32 folds each block in, the rank's own block
first. After n - 1 hops every query has seen the whole sequence, and no rank
held more than its 1/n of K/V.

Ulysses attention is the other long-context scheme, built on ``all_to_all``
where the ring is built on ``ppermute``: one exchange each turns the
sequence shards of q, k and v into head shards, every rank runs plain
attention over the whole sequence for its own heads (on the flash kernel
where its shapes allow), and a last exchange turns the result back.

The oracle's precision is pinned: f32 operands, f32 accumulation, and no TF32. A
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

from tpu_operator_torch.parallel.collectives import all_to_all, ppermute
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


def ulysses_attention(q, k, v, mesh: Mesh, axis_name: str = "model",
                      causal: bool = False):
    """Ulysses-style sequence parallelism. ``q``, ``k``, ``v`` hold one
    [Tl, H, Dh] tensor per rank: the rank's contiguous block of the
    sequence (in order of its position along ``axis_name``), all heads.
    Returns the same: each rank's [Tl, H, Dh] block of the attention over
    the whole sequence. H must divide by the axis size.

    An all-to-all each for q, k and v reshards to head parallelism (each
    rank holds H/n full-sequence heads), attention runs per head with no
    further communication, and one all-to-all reshards the output back:
    four exchanges of the activation size against ring attention's n - 1
    K/V rotations. The per-head attention runs at platform precision, not the
    oracle's pin: on flash attention ([H/n, T, Dh], made contiguous for it)
    by the reference's rule, a Dh that is a multiple of 128 and a full T
    that the blocks divide, as far as the CUDA kernels' widest head
    (``MAX_HEAD_DIM``) reaches; else dense."""
    # here, not at the top: ops.flash_attention imports this module
    from tpu_operator_torch.ops.flash_attention import (BLOCK, MAX_HEAD_DIM,
                                                        flash_attention)
    n = mesh.shape[axis_name]
    tl, h, dh = q[0].shape
    if h % n:
        raise ValueError(f"heads {h} not divisible by axis size {n}")

    def seq_to_heads(xs):
        # [Tl, H, Dh] → n blocks of H/n heads → exchange: every rank ends
        # with [n*Tl, H/n, Dh] = full sequence, local heads
        blocks = [x.reshape(tl, n, h // n, dh).permute(1, 0, 2, 3)
                  for x in xs]
        return [got.reshape(n * tl, h // n, dh)
                for got in all_to_all(blocks, mesh, axis_name)]

    def heads_to_seq(xs):
        # inverse reshard: [T, H/n, Dh] → [Tl, H, Dh]
        blocks = [x.reshape(n, tl, h // n, dh) for x in xs]
        return [got.permute(1, 0, 2, 3).reshape(tl, h, dh)
                for got in all_to_all(blocks, mesh, axis_name)]

    t_full = n * tl
    flash = (dh % 128 == 0 and dh <= MAX_HEAD_DIM
             and t_full % min(BLOCK, t_full) == 0)
    outs = []
    for qh, kh, vh in zip(*(seq_to_heads(xs) for xs in (q, k, v))):
        # heads first: [H/n, T, Dh], one attention per head
        qh, kh, vh = (x.permute(1, 0, 2).contiguous() for x in (qh, kh, vh))
        out = (flash_attention(qh, kh, vh, causal=causal) if flash
               else _softmax_attention(qh, kh, vh, causal))
        outs.append(out.permute(1, 0, 2))
    return heads_to_seq(outs)
