"""Single-card flash attention (forward) on hand-written CUDA kernels.

The port of ``tpu_operator/ops/flash_attention.py``. The burn-in matmul
proves raw tensor-core throughput; this kernel proves the composed pattern
long-context workloads run: blockwise q·Kᵀ, online softmax, ·V, never
materialising the [T, T] score matrix. ``csrc/flash_fwd.cu`` says what
bounds it on the card and how its design answers that.

Inputs are [T, D], or [H, T, D] with the heads as a grid axis (the
counterpart of the reference's ``jax.vmap`` contract). The kernels' q tiles
are 64 rows; the reference's ``DEFAULT_BLOCKS`` were sized for a TPU's VMEM
and do not carry over.

The card's schedule. The TPU kernel walks the kv tiles of a q tile in order
on one core. On the card the kv loop of a q tile is cut into *units* of at
most :data:`SPLIT` kv tiles of 64 keys, so that a long causal row of tiles
does not become one long chain on one SM while others idle.
:func:`work_list` builds the units, longest first. A q tile with one unit
writes its output; the units of a split q tile write their partial softmax
state (row max m, row sum l, unnormalised f32 acc) to a workspace, and a
second kernel merges them by the log-sum-exp rule in a fixed order (no
atomics: the same bits on every run). :func:`flash_split_plain` is that
schedule in plain PyTorch.

Three kernels run that schedule (:func:`kernel_for` routes a CUDA input):

- K2 (``csrc/flash_fwd.cu``, the instance the node validator runs): bf16,
  D = 128, T a multiple of 64; wgmma and TMA.
- K2w (:func:`flash_wgmma`, the same kernel template): f16 and bf16, D ≤
  256 with D % 8 = 0, any T.
- K2s (:func:`flash_generic`, ``csrc/flash_fwd_generic.cu``): f32, and
  16-bit inputs K2w does not take, D ≤ :data:`MAX_HEAD_DIM`, any T; CUDA
  cores, register-tiled.

:func:`flash_attention` runs the plain PyTorch version,
:func:`attention_plain`, only for CPU tensors.
"""

from __future__ import annotations

import math

import torch

from tpu_operator_torch import _native
from tpu_operator_torch.parallel.ring_attention import (_softmax_attention,
                                                        pinned_f32,
                                                        softmax_weights)

BLOCK = 64          # the kernels' q tile rows and the work list's kv tiles
HEAD_DIM = 128      # K2's head dimension
SPLIT = 8           # kv tiles per unit at most, from chip_smoke.py's sweep
MASK_FILL = -1e30   # the causal mask's fill, as in the reference
MAX_HEAD_DIM = 512  # the largest D any kernel (K2s) takes
WGMMA_MAX_HEAD_DIM = 256  # the largest D K2w takes
# the kernels' element types, by the code their C entry points take
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# K2w's keys a kv step by head-dim bucket (chip_smoke.py sweeps DP = 256)
WGMMA_BLOCK_K = {64: 64, 128: 64, 256: 32}


def head_bucket(d: int, widest: int = MAX_HEAD_DIM) -> int:
    """The padded head dim DP a kernel is built for: the smallest of 64,
    128, 256, 384 and 512 that holds ``d`` (K2w's widest is 256)."""
    for dp in (64, 128, 256, 384, 512):
        if d <= dp <= widest:
            return dp
    raise ValueError(f"head dim {d} above {widest}")


def kernel_for(dtype: torch.dtype, d: int, t: int) -> str:
    """Which kernel a CUDA input of ``dtype`` and shape [.., t, d] goes to:
    "K2" (bf16, D = 128, T a multiple of 64), "K2w" (f16 or bf16, D ≤ 256,
    D % 8 = 0) or "K2s" (every other input of :data:`DTYPE_CODES` with D ≤
    :data:`MAX_HEAD_DIM`)."""
    if dtype == torch.bfloat16 and d == HEAD_DIM and t % BLOCK == 0:
        return "K2"
    if (dtype in (torch.float16, torch.bfloat16)
            and d <= WGMMA_MAX_HEAD_DIM and d % 8 == 0):
        return "K2w"
    return "K2s"


def attention_plain(q, k, v, sm_scale: float | None = None,
                    causal: bool = False):
    """The kernels' function in plain PyTorch: dense f32
    softmax(q·Kᵀ·scale)·V with the same scale and causal mask, returned in
    the input dtype. Takes any floating dtype."""
    return _softmax_attention(q, k, v, causal, sm_scale)


def unit_roundoff(dtype: torch.dtype) -> float:
    """Half the gap between 1 and the next value of ``dtype``: 2⁻⁸ for
    bf16, 2⁻¹¹ for f16."""
    return float(torch.finfo(dtype).eps) / 2


def kernel_error_limit(q, k, v, sm_scale: float | None = None,
                       causal: bool = False):
    """The f32 output of the plain version, and a per-element limit on how
    far a 16-bit (bf16 or f16) kernel's output may lie from it.

    The kernels, like the reference's, compute the scores, the softmax
    state and the output accumulator in f32, but round the probabilities P
    to the input type before P·V and round the output to it (unit roundoff
    u, :func:`unit_roundoff`). The output's rounding errs by at most u·|o|.
    P's rounding adds Σ_j p_j·δ_j·v_j with independent |δ_j| ≤ u: a sum
    whose standard deviation is at most u/√3·√(Σ_j p_j²·v_j²). The limit
    allows 4·u times that root, about seven standard deviations. It scales
    with each output element, so a kernel that drops or mis-weights a kv
    tile, or scales its output by 1 + 1/64, exceeds it where an absolute
    tolerance set by the largest outputs would not see it.

    The split schedule keeps that assumption: a unit rounds exp(s − m_unit)
    to the input type, and the combine rescales the unit's sum by
    exp(m_unit − m) in f32, so each p_j still carries one rounding of
    relative size ≤ u, and only f32 roundings besides.
    """
    if q.dtype not in (torch.bfloat16, torch.float16):
        raise ValueError(f"the per-element limit is for 16-bit inputs, got "
                         f"{q.dtype}")
    u = unit_roundoff(q.dtype)
    with pinned_f32():
        w = softmax_weights(q, k, sm_scale, causal)
        vf = v.float()
        ref = torch.matmul(w, vf)
        spread = torch.matmul(w * w, vf * vf).sqrt()
    return ref, u * ref.abs() + 4.0 * u * spread


# -- the card's schedule ------------------------------------------------------

def work_list(heads: int, t: int, causal: bool, split: int):
    """The kernels' units and merges for [heads, t, D] inputs.

    Units are (row tile, first kv tile, end kv tile, slot), row tile =
    head · ⌈t / BLOCK⌉ + q tile, kv tiles of BLOCK keys (the last one cut
    at t): q tile i covers kv tiles [0, i + 1) if ``causal`` else all, cut
    from the start into runs of ``split`` (the last one shorter). They are
    ordered longest first, so the last wave of blocks is short. A q tile
    with one unit has slot -1 (it writes the output); the units of a split
    q tile get consecutive workspace slots in kv order. Merges are (row
    tile, first slot, count), one per split q tile."""
    if split < 1:
        raise ValueError(f"split {split} must be at least 1")
    nq = -(-t // BLOCK)
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
                   sm_scale: float | None = None, block_k: int = BLOCK):
    """Each unit's softmax state as the kernels leave it, for q, k, v of
    shape [T, D] or [H, T, D], any T and D: {q tile: [(m, l, acc), ...] in
    kv order}, each of shape [H, rows], [H, rows], [H, rows, D] in f32
    (rows: the tile's rows inside T). A unit walks its keys in steps of
    ``block_k`` (a divisor of BLOCK; the last step cut at T). Per step the
    online update rounds P = exp(s − m) to the input dtype before P·V, and
    sums the unrounded P into l."""
    if BLOCK % block_k:
        raise ValueError(f"block_k {block_k} must divide {BLOCK}")
    q3, k3, v3 = (x.reshape(-1, *x.shape[-2:]).float() for x in (q, k, v))
    heads, t, d = q3.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    keys = torch.arange(t, device=q3.device)
    parts = {}
    with pinned_f32():
        for row, j0, j1, _ in sorted(work_list(1, t, causal, split)[0],
                                     key=lambda u: (u[0], u[1])):
            rows = keys[row * BLOCK:(row + 1) * BLOCK]
            qt = q3[:, rows]
            m = torch.full((heads, len(rows)), float("-inf"),
                           device=q3.device)
            l = torch.zeros((heads, len(rows)), device=q3.device)
            acc = torch.zeros((heads, len(rows), d), device=q3.device)
            for k0 in range(j0 * BLOCK, min(j1 * BLOCK, t), block_k):
                cols = keys[k0:k0 + block_k]
                s = torch.matmul(qt, k3[:, cols].transpose(-1, -2)) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > rows[:, None],
                                      MASK_FILL)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.matmul(
                    p.to(q.dtype).float(), v3[:, cols])
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
                      sm_scale: float | None = None, block_k: int = BLOCK):
    """The card's schedule in plain PyTorch: :func:`split_partials`, then
    :func:`combine_partials` per q tile, the output rounded once to the
    input dtype."""
    parts = split_partials(q, k, v, causal, split, sm_scale, block_k)
    out = torch.cat([combine_partials(parts[row])
                     for row in range(len(parts))], dim=-2)
    return out.reshape(q.shape).to(q.dtype)


# -- the kernels ------------------------------------------------------------

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


def _schedule(q, causal: bool, split: int, dp: int):
    """The output, the heads, and the arguments every kernel's C entry
    point takes after q, k, v and o: the work list, its counts and a
    partials workspace of ``dp`` columns, with the workspace's tensors,
    which the caller keeps until it has launched."""
    heads = 1 if q.dim() == 2 else q.shape[0]
    units, merges, n_units, n_merges, slots = _device_work(
        q.device, heads, q.shape[-2], causal, split)
    part_acc = torch.empty((slots, BLOCK, dp), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((slots, 2, BLOCK), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    return out, heads, (units.data_ptr(), n_units, merges.data_ptr(),
                        n_merges, part_acc.data_ptr(),
                        part_ml.data_ptr()), (part_acc, part_ml)


def flash_launch(q, k, v, scale: float, causal: bool, split: int = SPLIT):
    """Launch K2 on checked inputs (see :func:`flash_attention`) with units
    of at most ``split`` kv tiles; the output, not yet synchronised.
    ``chip_smoke.py`` sweeps ``split`` through here."""
    out, heads, work, _workspace = _schedule(q, causal, split, HEAD_DIM)
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), *work, heads, q.shape[-2],
                                 HEAD_DIM, scale, int(causal),
                                 torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_bf16")
    return out


def flash_wgmma(q, k, v, sm_scale: float | None = None,
                causal: bool = False):
    """K2w's wrapper: softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or
    [H, T, D], f16 or bf16, D ≤ :data:`WGMMA_MAX_HEAD_DIM` with D % 8 = 0,
    any T. Launches the tensor-core kernel (``csrc/flash_fwd.cu``) for CUDA
    tensors and runs :func:`attention_plain` for CPU tensors; the output
    has the input dtype."""
    _check_shapes(q, k, v)
    t, d = q.shape[-2:]
    if q.dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"K2w takes float16 and bfloat16, got {q.dtype}")
    if d > WGMMA_MAX_HEAD_DIM or d % 8:
        raise ValueError(f"K2w takes a head dim that is a multiple of 8 and "
                         f"at most {WGMMA_MAX_HEAD_DIM}, got {d}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    return _wgmma_launch(*_cuda_inputs(q, k, v), scale, causal)


flash_wgmma.launches = 0


def _wgmma_launch(q, k, v, scale: float, causal: bool,
                  block_k: int | None = None):
    """Launch K2w on inputs :func:`_cuda_inputs` checked, with kv steps of
    ``block_k`` keys (the bucket's :data:`WGMMA_BLOCK_K` by default;
    ``chip_smoke.py`` sweeps it at DP = 256); the output, not yet
    synchronised."""
    dp = head_bucket(q.shape[-1], WGMMA_MAX_HEAD_DIM)
    out, heads, work, _workspace = _schedule(q, causal, SPLIT, dp)
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), *work, DTYPE_CODES[q.dtype],
                                  heads, q.shape[-2], q.shape[-1],
                                  block_k or WGMMA_BLOCK_K[dp], scale,
                                  int(causal),
                                  torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_wgmma")
    flash_wgmma.launches += 1
    return out


def flash_generic(q, k, v, sm_scale: float | None = None,
                  causal: bool = False):
    """K2s's wrapper: softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or
    [H, T, D], f32, f16 or bf16, D ≤ :data:`MAX_HEAD_DIM`, any T. Launches
    ``csrc/flash_fwd_generic.cu`` for CUDA tensors and runs
    :func:`attention_plain` for CPU tensors; the output has the input
    dtype."""
    _check_shapes(q, k, v)
    d = q.shape[-1]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    return _generic_launch(*_cuda_inputs(q, k, v), scale, causal)


flash_generic.launches = 0


def _generic_launch(q, k, v, scale: float, causal: bool):
    """Launch K2s on inputs :func:`_cuda_inputs` checked; the output, not
    yet synchronised."""
    out, heads, work, _workspace = _schedule(q, causal, SPLIT,
                                             head_bucket(q.shape[-1]))
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_generic(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                    out.data_ptr(), *work,
                                    DTYPE_CODES[q.dtype], heads, q.shape[-2],
                                    q.shape[-1], scale, int(causal),
                                    torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_generic")
    flash_generic.launches += 1
    return out


def _check_shapes(q, k, v):
    if q.dim() not in (2, 3) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [T, D] or [H, T, D] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _cuda_inputs(q, k, v):
    """q, k, v checked for the kernels and made contiguous: one dtype of
    :data:`DTYPE_CODES`, D ≤ :data:`MAX_HEAD_DIM`, one CUDA device."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take float32, float16 and "
                         f"bfloat16, got {q.dtype}")
    if q.shape[-1] > MAX_HEAD_DIM:
        raise ValueError(f"the CUDA kernels take head dim at most "
                         f"{MAX_HEAD_DIM}, got {q.shape[-1]}")
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    for name, x in (("k", k), ("v", v)):
        if x.device != q.device or x.dtype != q.dtype:
            raise ValueError(f"{name} is {x.dtype} on {x.device}, q is "
                             f"{q.dtype} on {q.device}")
    return tuple(_contiguous_aligned(x) for x in (q, k, v))


def _contiguous_aligned(x):
    x = x.contiguous()
    # a fresh copy is 16-byte aligned, as the TMA and cp.async loads need
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q, k, v, sm_scale: float | None = None,
                    causal: bool = False, block_q: int | None = None,
                    block_k: int | None = None):
    """softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or [H, T, D].

    T must divide by the blocks (pad upstream), checked as the reference
    checks it; ``sm_scale`` defaults to 1/√D; the output has the input
    dtype. On the card the blocks are a tiling hint only: each kernel tiles
    by its own rows. A CUDA input goes to the kernel :func:`kernel_for`
    names: K2 (counted here), K2w (:func:`flash_wgmma`) or K2s
    (:func:`flash_generic`); other dtypes and heads wider than
    :data:`MAX_HEAD_DIM` raise.
    """
    _check_shapes(q, k, v)
    t, d = q.shape[-2:]
    block_q = min(block_q or BLOCK, t)
    block_k = min(block_k or BLOCK, t)
    if t % block_q or t % block_k:
        raise ValueError(f"T={t} not divisible by blocks "
                         f"({block_q}, {block_k})")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    q, k, v = _cuda_inputs(q, k, v)
    kernel = kernel_for(q.dtype, d, t)
    if kernel == "K2w":
        return _wgmma_launch(q, k, v, scale, causal)
    if kernel == "K2s":
        return _generic_launch(q, k, v, scale, causal)
    out = flash_launch(q, k, v, scale, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
