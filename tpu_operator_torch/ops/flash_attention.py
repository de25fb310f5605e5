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

The card's schedule. The TPU kernel walks the kv tiles of a q tile in order
on one core. On the card the kv loop of a q tile is cut into *units* of at
most :data:`SPLIT` kv tiles, so that a long causal row of tiles does not
become one long chain on one SM while others idle. :func:`work_list` builds
the units, longest first. A q tile with one unit writes its output; the
units of a split q tile write their partial softmax state (row max m, row
sum l, unnormalised f32 acc) to a workspace, and a second kernel merges
them by the log-sum-exp rule in a fixed order (no atomics: the same bits on
every run). :func:`flash_split_plain` is that schedule in plain PyTorch.

:func:`flash_attention` launches the kernels for CUDA tensors (bf16 only)
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
SPLIT = 8           # kv tiles per unit at most, from chip_smoke.py's sweep
MASK_FILL = -1e30   # the causal mask's fill, as in the reference


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

    The split schedule keeps that assumption: a unit rounds
    exp(s − m_unit) to bf16, and the combine rescales the unit's sum by
    exp(m_unit − m) in f32, so each p_j still carries one bf16 rounding of
    relative size ≤ u, and only f32 roundings besides.
    """
    u = effective_matmul_eps(torch.bfloat16)
    with pinned_f32():
        w = softmax_weights(q, k, sm_scale, causal)
        vf = v.float()
        ref = torch.matmul(w, vf)
        spread = torch.matmul(w * w, vf * vf).sqrt()
    return ref, u * ref.abs() + 4.0 * u * spread


# -- the card's schedule ------------------------------------------------------

def work_list(heads: int, t: int, causal: bool, split: int):
    """The kernel's units and merges for [heads, t, D] inputs.

    Units are (row tile, first kv tile, end kv tile, slot), row tile =
    head · (t / BLOCK) + q tile: q tile i covers kv tiles [0, i + 1) if
    ``causal`` else all, cut from the start into runs of ``split`` (the
    last one shorter). They are ordered longest first, so the last wave of
    blocks is short. A q tile with one unit has slot -1 (it writes the
    output); the units of a split q tile get consecutive workspace slots in
    kv order. Merges are (row tile, first slot, count), one per split q
    tile."""
    if split < 1:
        raise ValueError(f"split {split} must be at least 1")
    nq = t // BLOCK
    units, merges, slots = [], [], 0
    for row in range(heads * nq):
        qi = row % nq
        n_kv = qi + 1 if causal else nq
        runs = [(j, min(j + split, n_kv)) for j in range(0, n_kv, split)]
        if len(runs) == 1:
            units.append((row, *runs[0], -1))
            continue
        merges.append((row, slots, len(runs)))
        for j0, j1 in runs:
            units.append((row, j0, j1, slots))
            slots += 1
    units.sort(key=lambda u: (u[1] - u[2], u[0], u[1]))
    return units, merges


def split_partials(q, k, v, causal: bool, split: int,
                   sm_scale: float | None = None):
    """Each unit's softmax state as the kernel leaves it, for q, k, v of
    shape [T, D] or [H, T, D]: {q tile: [(m, l, acc), ...] in kv order},
    each of shape [H, BLOCK], [H, BLOCK], [H, BLOCK, D] in f32. Per kv tile
    the online update rounds P = exp(s − m) to bf16 before P·V, and sums
    the unrounded P into l."""
    q3, k3, v3 = (x.reshape(-1, *x.shape[-2:]).float() for x in (q, k, v))
    heads, t, d = q3.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    diag = torch.triu(torch.ones((BLOCK, BLOCK), dtype=torch.bool,
                                 device=q3.device), diagonal=1)
    parts = {}
    with pinned_f32():
        for row, j0, j1, _ in sorted(work_list(1, t, causal, split)[0],
                                     key=lambda u: (u[0], u[1])):
            qt = q3[:, row * BLOCK:(row + 1) * BLOCK]
            m = torch.full((heads, BLOCK), float("-inf"), device=q3.device)
            l = torch.zeros((heads, BLOCK), device=q3.device)
            acc = torch.zeros((heads, BLOCK, d), device=q3.device)
            for j in range(j0, j1):
                kt = k3[:, j * BLOCK:(j + 1) * BLOCK]
                vt = v3[:, j * BLOCK:(j + 1) * BLOCK]
                s = torch.matmul(qt, kt.transpose(-1, -2)) * scale
                if causal and j == row:
                    s = s.masked_fill(diag, MASK_FILL)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.matmul(
                    p.to(torch.bfloat16).float(), vt)
                m = m_new
            parts.setdefault(row, []).append((m, l, acc))
    return parts


def combine_partials(parts):
    """One q tile's output from its units' (m, l, acc), in f32: the
    log-sum-exp merge the combine kernel makes, in the units' order."""
    if len(parts) == 1:
        m, l, acc = parts[0]
        return acc / l[..., None]
    m = parts[0][0]
    for m_u, _, _ in parts[1:]:
        m = torch.maximum(m, m_u)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(parts[0][2])
    for m_u, l_u, acc_u in parts:
        w = torch.exp(m_u - m)
        l = l + l_u * w
        acc = acc + acc_u * w[..., None]
    return acc / l[..., None]


def flash_split_plain(q, k, v, causal: bool = False, split: int = SPLIT,
                      sm_scale: float | None = None):
    """The card's schedule in plain PyTorch: :func:`split_partials`, then
    :func:`combine_partials` per q tile, the output rounded once to the
    input dtype."""
    parts = split_partials(q, k, v, causal, split, sm_scale)
    out = torch.cat([combine_partials(parts[row])
                     for row in range(len(parts))], dim=-2)
    return out.reshape(q.shape).to(q.dtype)


# -- the kernel -------------------------------------------------------------

_works: dict[tuple, tuple] = {}


def _int4s(rows, device):
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device)


def _device_work(device: torch.device, heads: int, t: int, causal: bool,
                 split: int):
    """The work list on the card, built once per (device, shape, split):
    units [U, 4] and merges [C, 4] int32, and the workspace slots."""
    key = (device, heads, t, causal, split)
    if key not in _works:
        units, merges = work_list(heads, t, causal, split)
        _works[key] = (_int4s(units, device),
                       _int4s([(*m, 0) for m in merges], device), len(units),
                       len(merges), sum(count for *_, count in merges))
    return _works[key]


def flash_launch(q, k, v, scale: float, causal: bool, split: int = SPLIT):
    """Launch the kernels on checked inputs (see :func:`flash_attention`)
    with units of at most ``split`` kv tiles; the output, not yet
    synchronised. ``chip_smoke.py`` sweeps ``split`` through here."""
    heads = 1 if q.dim() == 2 else q.shape[0]
    t = q.shape[-2]
    units, merges, n_units, n_merges, slots = _device_work(
        q.device, heads, t, causal, split)
    out = torch.empty_like(q)
    part_acc = torch.empty((slots, BLOCK, HEAD_DIM), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((slots, 2, BLOCK), dtype=torch.float32,
                          device=q.device)
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), units.data_ptr(), n_units,
                                 merges.data_ptr(), n_merges,
                                 part_acc.data_ptr(), part_ml.data_ptr(),
                                 heads, t, HEAD_DIM, scale, int(causal),
                                 torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_bf16")
    return out


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
    out = flash_launch(q, k, v, scale, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
