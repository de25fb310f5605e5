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
most a few kv tiles of 64 keys, so that a long causal row of tiles does not
become one long chain on one SM while others idle: K2's length comes from
the shape and the card (:func:`k2_split`), the other kernels' is
:data:`SPLIT`. :func:`work_list` builds the units, longest first. A q tile
with one unit writes its output; the units of a split q tile write their
partial softmax state (row max m, row sum l, unnormalised f32 acc) to a
workspace, and a second kernel merges them by the log-sum-exp rule in a
fixed order (no atomics: the same bits on every run).
:func:`flash_split_plain` is that schedule in plain PyTorch.

Four kernels run that schedule (:func:`kernel_for` routes a CUDA input):

- K2 (``csrc/flash_fwd.cu``, the instance the node validator runs): bf16,
  D = 128, T a multiple of 64; wgmma and TMA.
- K2w (:func:`flash_wgmma`, the same kernel template): f16 and bf16, D ≤
  :data:`WGMMA_MAX_HEAD_DIM`, any T.
- K2dw (:func:`flash_wide_wgmma`, ``csrc/flash_fwd_wide_wgmma.cu``): f16
  and bf16 with D > :data:`WGMMA_MAX_HEAD_DIM`, any T; wgmma and TMA. The
  output's head dim is cut into chunks of :data:`WIDE_CHUNK` columns, one
  block a (unit, chunk), and each block forms the scores from all of D
  again; :func:`flash_chunked_plain` is that schedule in plain PyTorch.
- K2dt (:func:`flash_wide_tf32`, ``csrc/flash_fwd_wide_tf32.cu``): f32
  at any D and T; K2dw's schedule on the tensor cores at a chunk of
  :func:`tf32_chunk` columns (the head bucket up to 256), every product
  split into three TF32 products (3xTF32) so that it keeps f32 grade;
  :func:`flash_chunked_tf32_plain` is its arithmetic in plain PyTorch.

TMA, which feeds K2w, K2dw and K2dt, needs a row stride of a multiple of
16 bytes. They take a head dim off it through a padded row stride of
:func:`padded_width` columns, the tensor maps' width staying D: K2w and
K2dw copy q, k and v into a padded workspace, K2dt's pre-pass writes its
split copies at that stride. So every head dim the reference's Pallas
kernel takes has a kernel.
:func:`flash_attention` runs the plain PyTorch version,
:func:`attention_plain`, only for CPU tensors.
"""

from __future__ import annotations

import heapq
import math

import torch
from torch.autograd import profiler as autograd_profiler

from tpu_operator_torch import _native
from tpu_operator_torch.parallel.ring_attention import (_softmax_attention,
                                                        pinned_f32,
                                                        softmax_weights)
from tpu_operator_torch.utils import trace
from tpu_operator_torch.utils.device import resolve_device
from tpu_operator_torch.utils.timing import measure_best, median_differential

BLOCK = 64          # the kernels' q tile rows and the work list's kv tiles
HEAD_DIM = 128      # K2's head dimension
# kv tiles per unit at most for K2w, K2dw and K2dt, and K2's shortest
# (:func:`k2_split`): chip_smoke.py's sweep at T = 4096 found shorter units
# slower
SPLIT = 8
# K2's blocks resident on one SM: its 80 KiB of shared memory
# (``Smem<128, 64>`` in ``csrc/flash_fwd.cu``) lets two share an SM's
# 227 KiB, a third does not fit, and two blocks of 128 threads at 125
# registers use a quarter of the register file
K2_BLOCKS_PER_SM = 2
MASK_FILL = -1e30   # the causal mask's fill, as in the reference
# the largest D K2w takes (16-bit); past it K2dw takes 16-bit
WGMMA_MAX_HEAD_DIM = 256
# K2dw's output columns a block (``kDC`` in ``csrc/flash_fwd_wide_wgmma.cu``,
# whose C entry refuses a workspace narrower than D rounded up to it), and
# K2dt's past D = 256 (:func:`tf32_chunk`)
WIDE_CHUNK = 256
# the kernels' element types, by the code their C entry points take
DTYPE_CODES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
# K2w's keys a kv step by head-dim bucket (chip_smoke.py sweeps DP = 256)
WGMMA_BLOCK_K = {64: 64, 128: 64, 256: 32}


def head_bucket(d: int) -> int:
    """The padded head dim DP that K2w is built for, and K2dt's chunk width
    up to 256 (:func:`tf32_chunk`): the smallest of 64, 128 and 256 that
    holds ``d``."""
    for dp in (64, 128, 256):
        if d <= dp:
            return dp
    raise ValueError(f"head dim {d} above 256")


def kernel_for(dtype: torch.dtype, d: int, t: int) -> str:
    """Which kernel a CUDA input of ``dtype`` and shape [.., t, d] goes to:
    "K2" (bf16, D = 128, T a multiple of 64); for the other f16 and bf16
    inputs, "K2w" up to :data:`WGMMA_MAX_HEAD_DIM` and "K2dw" past it; for
    f32, "K2dt"; any D (a head off 16 bytes a row goes through
    :func:`padded_width`). Each wrapper takes exactly its rows
    (:func:`wide_wgmma_takes`, :func:`wide_tf32_takes`)."""
    if dtype == torch.bfloat16 and d == HEAD_DIM and t % BLOCK == 0:
        return "K2"
    if wide_wgmma_takes(dtype, d):
        return "K2dw"
    if wide_tf32_takes(dtype, d):
        return "K2dt"
    return "K2w"


def wide_wgmma_takes(dtype: torch.dtype, d: int) -> bool:
    """K2dw's range: f16 and bf16 past :data:`WGMMA_MAX_HEAD_DIM`, any D."""
    return dtype in (torch.float16, torch.bfloat16) and d > WGMMA_MAX_HEAD_DIM


def wide_tf32_takes(dtype: torch.dtype, d: int) -> bool:
    """K2dt's range: f32, any D ≥ 1."""
    return dtype == torch.float32 and d >= 1


def padded_width(dtype: torch.dtype, d: int) -> int:
    """The row stride, in elements, at which K2w, K2dw and K2dt hand a
    [.., D] operand to TMA: D rounded up to 8 (16-bit) or 4 (f32), so that
    a row is a multiple of 16 bytes. The tensor maps' width stays D, so TMA
    fills zeros past it and never reads a pad column."""
    per_16_bytes = 16 // torch.empty((), dtype=dtype).element_size()
    return -(-d // per_16_bytes) * per_16_bytes


def tf32_chunk(d: int) -> int:
    """K2dt's output columns a block (``DC`` in
    ``csrc/flash_fwd_wide_tf32.cu``): the head bucket (:func:`head_bucket`:
    64, 128 or 256) up to D = 256, :data:`WIDE_CHUNK` past it."""
    return head_bucket(d) if d <= WGMMA_MAX_HEAD_DIM else WIDE_CHUNK


def wide_columns(d: int, chunk: int = WIDE_CHUNK) -> int:
    """K2dw's and K2dt's partial-workspace row: D rounded up to the chunk
    width (K2dw's :data:`WIDE_CHUNK`, K2dt's :func:`tf32_chunk`), the
    columns of all of a unit's chunk blocks."""
    return -(-d // chunk) * chunk


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


def card_slots(device: torch.device) -> int:
    """The K2 blocks ``device`` holds at once: its SMs times
    :data:`K2_BLOCKS_PER_SM`."""
    return (torch.cuda.get_device_properties(device).multi_processor_count
            * K2_BLOCKS_PER_SM)


def schedule_makespan(heads: int, t: int, causal: bool, split: int,
                      slots: int) -> int:
    """The kv tiles after which the last of ``slots`` ends when the units
    of :func:`work_list`, in its order (longest first), go each to the slot
    that frees first, as the card's block scheduler hands out a grid: the
    list schedule of K2's grid, a unit costing its kv tiles."""
    units, _ = work_list(heads, t, causal, split)
    ends = [0] * min(slots, len(units))
    for _, j0, j1, _ in units:
        heapq.heapreplace(ends, ends[0] + j1 - j0)
    return max(ends)


def k2_split(heads: int, t: int, causal: bool, slots: int) -> int:
    """K2's kv tiles a unit at most for [heads, t, 128] inputs on a card
    that holds ``slots`` K2 blocks at once (:func:`card_slots`).

    Each unit pays its own Q load and pipeline fill, and each unit of a
    split q tile writes a partial state that the merge reads back, so the
    longer the units the less the schedule costs beside the work; but units
    as long as a causal row leave most slots idle while the longest rows
    run. The candidates are :data:`SPLIT` and its doublings below the row's
    ⌈t / 64⌉ kv tiles, the whole row (no split) and the even share of the
    kv tiles a slot, rounded up, none shorter than :data:`SPLIT`. Of these
    the longest is taken whose :func:`schedule_makespan` ends within 5% of
    the even share; where none does (few tiles for the slots), the longest
    of those that end first."""
    nq = -(-t // BLOCK)
    tiles = heads * (nq * (nq + 1) // 2 if causal else nq * nq)
    # The list schedule counts kv tiles alone, while a unit's prologue and
    # the masked diagonal tile of a causal row make block times differ by a
    # few percent: an end within 5% of the even share is as balanced as the
    # count can tell apart, and a longer unit within it costs fewer
    # prologues, partials and merges.
    target = 1.05 * tiles / slots
    candidates = {nq, min(max(-(-tiles // slots), SPLIT), nq)}
    split = SPLIT
    while split < nq:
        candidates.add(split)
        split *= 2
    order = sorted(candidates, reverse=True)
    for split in order:
        # a unit of min(split, nq) tiles alone ends past the target
        if (min(split, nq) <= target
                and schedule_makespan(heads, t, causal, split,
                                      slots) <= target):
            return split
    ends = {split: schedule_makespan(heads, t, causal, split, slots)
            for split in order}
    return max(split for split, end in ends.items()
               if end == min(ends.values()))


def split_partials(q, k, v, causal: bool, split: int,
                   sm_scale: float | None = None, block_k: int = BLOCK,
                   v_cols: slice = slice(None), matmul=torch.matmul):
    """Each unit's softmax state as the kernels leave it, for q, k, v of
    shape [T, D] or [H, T, D], any T and D: {q tile: [(m, l, acc), ...] in
    kv order}, each of shape [H, rows], [H, rows], [H, rows, C] in f32
    (rows: the tile's rows inside T; C: the columns of V that ``v_cols``
    picks, all of D by default; the scores always come from all of D). A
    unit walks its keys in steps of ``block_k`` (a divisor of BLOCK; the
    last step cut at T). Per step the online update rounds P = exp(s − m)
    to the input dtype before P·V, and sums the unrounded P into l.
    ``matmul`` forms both products, Q·Kᵀ and P·V (:func:`tf32_matmul` for
    K2dt's)."""
    if BLOCK % block_k:
        raise ValueError(f"block_k {block_k} must divide {BLOCK}")
    q3, k3, v3 = (x.reshape(-1, *x.shape[-2:]).float() for x in (q, k, v))
    heads, t, d = q3.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    v3 = v3[..., v_cols]
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
            acc = torch.zeros((heads, len(rows), v3.shape[-1]),
                              device=q3.device)
            for k0 in range(j0 * BLOCK, min(j1 * BLOCK, t), block_k):
                cols = keys[k0:k0 + block_k]
                s = matmul(qt, k3[:, cols].transpose(-1, -2)) * scale
                if causal:
                    s = s.masked_fill(cols[None, :] > rows[:, None],
                                      MASK_FILL)
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + matmul(
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


def flash_chunked_plain(q, k, v, causal: bool = False, split: int = SPLIT,
                        chunk: int = WIDE_CHUNK,
                        sm_scale: float | None = None, matmul=torch.matmul):
    """K2dw's schedule in plain PyTorch: for each chunk of
    ``chunk`` output columns, every unit's (m, l, acc) with the scores from
    all of D and P·V over the chunk's columns of V (:func:`split_partials`,
    its products by ``matmul``), merged per q tile
    (:func:`combine_partials`); the chunks side by side, rounded once to
    the input dtype. Any T and D, 16-bit or f32 inputs."""
    if chunk < 1:
        raise ValueError(f"chunk {chunk} must be at least 1")
    d = q.shape[-1]
    chunks = []
    for c0 in range(0, d, chunk):
        parts = split_partials(q, k, v, causal, split, sm_scale,
                               v_cols=slice(c0, c0 + chunk), matmul=matmul)
        chunks.append(torch.cat([combine_partials(parts[row])
                                 for row in range(len(parts))], dim=-2))
    out = torch.cat(chunks, dim=-1)
    return out.reshape(q.shape).to(q.dtype)


#: K2dt's three TF32 products of an f32 product a·b, in the order it adds
#: them: the two with a small part first, as CUTLASS's fast-f32 mode does
TF32_PRODUCTS = ("small_big", "big_small", "big_big")


def tf32_split(x):
    """f32 ``x`` as (big, small): big = x rounded to TF32 (10 mantissa
    bits), small = x − big rounded to TF32, each to nearest with ties away
    from zero by the bit mask K2dt applies, ``(bits + 0x1000) & ~0x1fff``.
    big + small is x to about 2⁻²¹ of its magnitude; big alone to 2⁻¹¹."""
    def rounded(y):
        bits = y.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)
    big = rounded(x)
    return big, rounded(x - big)


def tf32_matmul(products=TF32_PRODUCTS):
    """An f32 matmul as K2dt forms it: both operands split by
    :func:`tf32_split` and the named ``products`` of :data:`TF32_PRODUCTS`
    (each exact on TF32 values, summed in f32) added in that order. One
    product alone, ``("big_big",)``, is a plain TF32 matmul."""
    unknown = set(products) - set(TF32_PRODUCTS)
    if unknown or not products:
        raise ValueError(f"products must name some of {TF32_PRODUCTS}, got "
                         f"{products}")

    def matmul(a, b):
        (a_big, a_small), (b_big, b_small) = tf32_split(a), tf32_split(b)
        pairs = {"small_big": (a_small, b_big), "big_small": (a_big, b_small),
                 "big_big": (a_big, b_big)}
        out = None
        for name in products:
            term = torch.matmul(*pairs[name])
            out = term if out is None else out + term
        return out
    return matmul


def flash_chunked_tf32_plain(q, k, v, causal: bool = False,
                             split: int = SPLIT, chunk: int | None = None,
                             sm_scale: float | None = None,
                             products=TF32_PRODUCTS):
    """K2dt's arithmetic in plain PyTorch, for f32 inputs: K2dw's chunked
    schedule (:func:`flash_chunked_plain`) at ``chunk`` output columns a
    block (K2dt's own, :func:`tf32_chunk` of D, by default) with Q·Kᵀ and
    P·V each formed from TF32 parts (:func:`tf32_matmul` of ``products``),
    scores, softmax state and output in f32."""
    if q.dtype != torch.float32:
        raise ValueError(f"K2dt's arithmetic is for float32, got {q.dtype}")
    chunk = chunk or tf32_chunk(q.shape[-1])
    return flash_chunked_plain(q, k, v, causal, split, chunk, sm_scale,
                               matmul=tf32_matmul(products))


# -- the kernels ------------------------------------------------------------

_works: dict[tuple, tuple] = {}


def _int4s(rows, device):
    return torch.tensor(rows, dtype=torch.int32).reshape(-1, 4).to(device)


def _device_work(device: torch.device, heads: int, t: int, causal: bool,
                 split: int | None):
    """The work list on the card, built once per (device, shape, split),
    a ``split`` of None standing for K2's own (:func:`k2_split` on the
    card's :func:`card_slots`): units [U, 4] and merges [C, 4] int32, their
    counts, and the workspace slots."""
    key = (device, heads, t, causal, split)
    if key not in _works:
        if split is None:
            split = k2_split(heads, t, causal, card_slots(device))
        units, merges = work_list(heads, t, causal, split)
        _works[key] = (_int4s(units, device),
                       _int4s([(*m, 0) for m in merges], device), len(units),
                       len(merges), sum(count for *_, count in merges))
    return _works[key]


def _schedule(q, causal: bool, split: int | None, dp: int, steps=None):
    """The output, the heads, and the arguments every kernel's C entry
    point takes after q, k, v and o: the work list, its counts and a
    partials workspace of ``dp`` columns, with the workspace's tensors,
    which the caller keeps until it has launched. ``split`` as
    :func:`_device_work` takes it. With ``steps`` (see
    :class:`_Steps`) it opens ``flash_op.schedule``."""
    heads = 1 if q.dim() == 2 else q.shape[0]
    if steps is not None:
        steps.step("flash_op.schedule")
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


def flash_launch(q, k, v, scale: float, causal: bool,
                 split: int | None = None, steps=None):
    """Launch K2 on checked inputs (see :func:`flash_attention`) with units
    of at most ``split`` kv tiles, :func:`k2_split`'s for the shape on this
    card by default; the output, not yet synchronised. ``chip_smoke.py``
    sweeps ``split`` through here. ``flash_launch.units`` and
    ``.partial_slots`` then hold the launch's units and the partial states
    its split q tiles write. With ``steps``, as in each route's launcher,
    the work list and the workspaces are the ``flash_op.schedule`` step
    and the rest the ``flash_op.launch`` step."""
    out, heads, work, workspace = _schedule(q, causal, split, HEAD_DIM,
                                            steps)
    if steps is not None:
        steps.step("flash_op.launch")
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_bf16(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                 out.data_ptr(), *work, heads, q.shape[-2],
                                 HEAD_DIM, scale, int(causal),
                                 torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_bf16")
    flash_launch.units, flash_launch.partial_slots = (work[1],
                                                      workspace[0].shape[0])
    return out


flash_launch.units = flash_launch.partial_slots = 0


def flash_wgmma(q, k, v, sm_scale: float | None = None,
                causal: bool = False):
    """K2w's wrapper: softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or
    [H, T, D], f16 or bf16, D ≤ :data:`WGMMA_MAX_HEAD_DIM` (any D), any T.
    Launches the tensor-core kernel (``csrc/flash_fwd.cu``) for CUDA
    tensors and runs :func:`attention_plain` for CPU tensors; the output
    has the input dtype. Another dtype or a wider head is refused on any
    device (K2dw or K2dt takes it)."""
    _check_shapes(q, k, v)
    d = q.shape[-1]
    if q.dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"K2w takes float16 and bfloat16, got {q.dtype}")
    if d > WGMMA_MAX_HEAD_DIM:
        raise ValueError(f"K2w takes a head dim at most "
                         f"{WGMMA_MAX_HEAD_DIM}, got {d}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    return _wgmma_launch(*_cuda_inputs(q, k, v), scale, causal)


flash_wgmma.launches = 0


def _wgmma_launch(q, k, v, scale: float, causal: bool,
                  block_k: int | None = None, steps=None):
    """Launch K2w on inputs :func:`_cuda_inputs` checked, with kv steps of
    ``block_k`` keys (the bucket's :data:`WGMMA_BLOCK_K` by default;
    ``chip_smoke.py`` sweeps it at DP = 256); the output, not yet
    synchronised. Where D is off :func:`padded_width`, the C entry first
    copies q, k and v into a [3, H, T, Dp] workspace (Dp = that width), as
    K2dw's does."""
    t, d = q.shape[-2:]
    dp = head_bucket(d)
    out, heads, work, _workspace = _schedule(q, causal, SPLIT, dp, steps)
    padded = _padded_workspace(q, heads)
    if steps is not None:
        steps.step("flash_op.launch")
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_wgmma(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  out.data_ptr(), *work,
                                  None if padded is None
                                  else padded.data_ptr(),
                                  DTYPE_CODES[q.dtype], heads, t, d,
                                  block_k or WGMMA_BLOCK_K[dp], scale,
                                  int(causal),
                                  torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_wgmma")
    flash_wgmma.launches += 1
    return out


def _padded_workspace(q, heads: int):
    """The [3, H, T, Dp] workspace that K2w's and K2dw's C entries copy a
    16-bit head off 8 into (Dp: :func:`padded_width`), or None where D is a
    multiple of 8."""
    t, d = q.shape[-2:]
    dp = padded_width(q.dtype, d)
    return (None if dp == d else
            torch.empty((3, heads, t, dp), dtype=q.dtype, device=q.device))


def flash_wide_wgmma(q, k, v, sm_scale: float | None = None,
                     causal: bool = False):
    """K2dw's wrapper: softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or
    [H, T, D], f16 or bf16, D > :data:`WGMMA_MAX_HEAD_DIM` (any D), any T.
    Launches the tensor-core kernel (``csrc/flash_fwd_wide_wgmma.cu``) for
    CUDA tensors and runs :func:`attention_plain` for CPU tensors; the
    output has the input dtype. Another dtype or head dim is refused on any
    device (K2w or K2dt takes it)."""
    _check_shapes(q, k, v)
    d = q.shape[-1]
    if q.dtype not in (torch.float16, torch.bfloat16):
        raise ValueError(f"K2dw takes float16 and bfloat16, got {q.dtype}")
    if not wide_wgmma_takes(q.dtype, d):
        raise ValueError(f"K2dw takes a head dim above {WGMMA_MAX_HEAD_DIM}, "
                         f"got {d}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    return _wide_wgmma_launch(*_cuda_inputs(q, k, v), scale, causal)


flash_wide_wgmma.launches = 0


def _wide_wgmma_launch(q, k, v, scale: float, causal: bool, steps=None):
    """Launch K2dw on inputs :func:`_cuda_inputs` checked; the output, not
    yet synchronised. The partial workspace's rows are
    :func:`wide_columns`; where D is off :func:`padded_width`, the C entry
    first copies q, k and v into a [3, H, T, Dp] workspace (Dp = that
    width)."""
    d = q.shape[-1]
    out, heads, work, _workspace = _schedule(q, causal, SPLIT,
                                             wide_columns(d), steps)
    padded = _padded_workspace(q, heads)
    if steps is not None:
        steps.step("flash_op.launch")
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_wide_wgmma(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *work,
            wide_columns(d), None if padded is None else padded.data_ptr(),
            DTYPE_CODES[q.dtype], heads, q.shape[-2], d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_wide_wgmma")
    flash_wide_wgmma.launches += 1
    return out


def flash_wide_tf32(q, k, v, sm_scale: float | None = None,
                    causal: bool = False):
    """K2dt's wrapper: softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or
    [H, T, D], f32, any D and T. Launches the 3xTF32 tensor-core kernel
    (``csrc/flash_fwd_wide_tf32.cu``) for CUDA tensors and runs
    :func:`attention_plain` for CPU tensors; the output is f32. Another
    dtype is refused on any device (a 16-bit kernel takes it)."""
    _check_shapes(q, k, v)
    d = q.shape[-1]
    if q.dtype != torch.float32:
        raise ValueError(f"K2dt takes float32, got {q.dtype}")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale, causal)
    return _wide_tf32_launch(*_cuda_inputs(q, k, v), scale, causal)


flash_wide_tf32.launches = 0


def _wide_tf32_launch(q, k, v, scale: float, causal: bool, steps=None):
    """Launch K2dt on inputs :func:`_cuda_inputs` checked; the output, not
    yet synchronised. Its work list is K2dw's, its partial workspace's rows
    D rounded up to :func:`tf32_chunk`; the C entry's pre-pass writes the TF32 parts into three more workspaces,
    Q's and K's [2H, T, Dp] (Dp: :func:`padded_width`, the pad columns
    never written or read) and V's transposed [2H, D, Tp] (Tp: T rounded
    up to :data:`BLOCK`)."""
    t, d = q.shape[-2:]
    cols = wide_columns(d, tf32_chunk(d))
    out, heads, work, _workspace = _schedule(q, causal, SPLIT, cols, steps)
    split_q = torch.empty((2 * heads, t, padded_width(q.dtype, d)),
                          dtype=torch.float32, device=q.device)
    split_k = torch.empty_like(split_q)
    split_v = torch.empty((2 * heads, d, -(-t // BLOCK) * BLOCK),
                          dtype=torch.float32, device=q.device)
    if steps is not None:
        steps.step("flash_op.launch")
    lib = _native.library()
    with torch.cuda.device(q.device):
        err = lib.flash_fwd_wide_tf32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), *work,
            cols, split_q.data_ptr(), split_k.data_ptr(), split_v.data_ptr(),
            heads, t, d, scale, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _native.check(err, "flash_fwd_wide_tf32")
    flash_wide_tf32.launches += 1
    return out


def _check_shapes(q, k, v):
    if q.dim() not in (2, 3) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q, k, v must share a [T, D] or [H, T, D] shape, "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def _cuda_inputs(q, k, v):
    """q, k, v checked for the kernels and made contiguous: one dtype of
    :data:`DTYPE_CODES`, one CUDA device. Each wrapper checks the head dims
    its own kernel takes."""
    if q.dtype not in DTYPE_CODES:
        raise ValueError(f"the CUDA kernels take float32, float16 and "
                         f"bfloat16, got {q.dtype}")
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


class _Steps:
    """A ``flash_op.call`` span and its steps, one open at a time, made
    only while something records (``utils/trace.py``): :meth:`step` closes
    the open step and opens the next, :meth:`finish` closes the step and
    the call."""

    def __init__(self):
        self.call = trace.span("flash_op.call").__enter__()
        self.open = None

    def step(self, name: str) -> None:
        if self.open is not None:
            self.open.__exit__(None, None, None)
        self.open = trace.span(name).__enter__()

    def finish(self, *exc) -> None:
        if self.open is not None:
            self.open.__exit__(*exc)
        self.call.__exit__(*exc)


def flash_attention(q, k, v, sm_scale: float | None = None,
                    causal: bool = False, block_q: int | None = None,
                    block_k: int | None = None):
    """softmax(q·Kᵀ·scale)·V for q, k, v of shape [T, D] or [H, T, D].

    T must divide by the blocks (pad upstream), checked as the reference
    checks it; ``sm_scale`` defaults to 1/√D; the output has the input
    dtype. On the card the blocks are a tiling hint only: each kernel tiles
    by its own rows. A CUDA input goes to the kernel :func:`kernel_for`
    names: K2 (counted here), K2w (:func:`flash_wgmma`), K2dw
    (:func:`flash_wide_wgmma`) or K2dt (:func:`flash_wide_tf32`); other
    dtypes raise.

    While something records (``utils/trace.py``), the call is a
    ``flash_op.call`` span with three steps on the card:
    ``flash_op.prepare`` (the checks, the contiguous copies and the
    route), ``flash_op.schedule`` and ``flash_op.launch``
    (:class:`_Steps`); on the CPU the call alone. With nothing recording
    the host path pays two plain reads: no span open on any thread, no
    profiler in the process.
    """
    steps = (_Steps() if (trace.Tracer.active
                          or autograd_profiler._is_profiler_enabled)
             and trace.Tracer.recording() else None)
    try:
        cuda = q.device.type != "cpu"
        if steps is not None and cuda:
            steps.step("flash_op.prepare")
        _check_shapes(q, k, v)
        t, d = q.shape[-2:]
        block_q = min(block_q or BLOCK, t)
        block_k = min(block_k or BLOCK, t)
        if t % block_q or t % block_k:
            raise ValueError(f"T={t} not divisible by blocks "
                             f"({block_q}, {block_k})")
        scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
        if not cuda:
            return attention_plain(q, k, v, scale, causal)
        q, k, v = _cuda_inputs(q, k, v)
        kernel = kernel_for(q.dtype, d, t)
        if kernel == "K2w":
            return _wgmma_launch(q, k, v, scale, causal, None, steps)
        if kernel == "K2dw":
            return _wide_wgmma_launch(q, k, v, scale, causal, steps)
        if kernel == "K2dt":
            return _wide_tf32_launch(q, k, v, scale, causal, steps)
        out = flash_launch(q, k, v, scale, causal, None, steps)
        flash_attention.launches += 1
        return out
    except BaseException as e:
        if steps is not None:
            steps.finish(type(e), e, e.__traceback__)
            steps = None
        raise
    finally:
        if steps is not None:
            steps.finish(None, None, None)


flash_attention.launches = 0


# -- the bench: K2 against SDPA ---------------------------------------------

#: the SDPA backends :func:`flash_vs_sdpa_tflops` tries on the card, as
#: ``torch.nn.attention.SDPBackend`` names; the CPU has only the math one
SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def _sdpa(backend: str):
    """Causal SDPA on one backend as a [T, D] → [T, D] function: the inputs
    go in as [1, 1, T, D], the only form the fused backends take."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    def attend(q, k, v):
        with sdpa_kernel(getattr(SDPBackend, backend)):
            out = F.scaled_dot_product_attention(
                q[None, None], k[None, None], v[None, None], is_causal=True)
        return out[0, 0]
    return attend


def _chained(fn, q, k, v, reps: int):
    """A function that runs ``reps`` calls of ``fn`` chained (each output
    is the next call's q), sums the last output in f32 and fetches the sum,
    the completion barrier. On the card the calls and the sum are one CUDA
    graph, captured here after one uncaptured run sets up what the calls
    cache, so a run is one replay and the host's time per call is not in
    it."""
    def body():
        acc = q
        for _ in range(reps):
            acc = fn(acc, k, v)
        return acc.float().sum()

    if q.device.type != "cuda":
        return lambda: body().item()
    body().item()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        total = body()

    def run():
        graph.replay()
        return total.item()
    return run


def _per_call_seconds(run_hi, run_lo, hi: int, lo: int, iters: int,
                      repeats: int):
    """Seconds a call by the two-point differential between ``hi`` and
    ``lo`` chained calls, and the median sample's Δt; when timer noise
    swamps every differential, the ``hi`` run's absolute time a call and
    Δt None."""
    last = {}

    def t_hi():
        last["secs"] = measure_best(run_hi, iters=iters, warmup=0)
        return last["secs"]

    def t_lo():
        return measure_best(run_lo, iters=iters, warmup=0)

    med = median_differential(t_hi, t_lo, hi - lo, repeats)
    if med is None:
        return last["secs"] / hi, None
    return 1.0 / med[0], med[1]


def flash_vs_sdpa_tflops(t: int = 16384, d: int = 128, reps_hi: int = 48,
                         reps_lo: int = 12, iters: int = 2, repeats: int = 3,
                         device="cuda") -> dict:
    """Causal flash attention (:func:`flash_attention`: K2 at bf16, D = 128,
    T % 64 = 0) against the fastest SDPA backend that takes the same
    inputs, in the same process on the same payload.

    The inputs are three [t, d] bf16 draws of a generator seeded 0. Each
    side runs ``reps`` chained calls (:func:`_chained`), timed by the
    two-point differential between ``reps_hi`` and ``reps_lo`` chains
    (``median_differential`` over ``repeats``, each time the best of
    ``iters`` runs), with the absolute time as the fallback. Both sides
    run chains of equal length, so that their Δt are of the same order:
    the reference lengthens its kernel's chains 8 times, for a kernel 4x
    faster than its comparator; on an H100 K2 takes 1.25x cuDNN's time a
    call at the defaults (``PERF.md``). The comparator is the backend
    of :data:`SDPA_BACKENDS` whose ``reps_lo`` chain runs fastest; a
    backend that refuses the inputs is passed over. FLOPs a call: 2·t²·d
    (the causal half of the pairs).

    On the CPU (tests) the flash side is the plain version and the
    comparator SDPA's math backend: the numbers mean nothing there, as
    ``note`` says.

    Returns ``seq_len``, ``d``, ``flash_tflops``, ``sdpa_tflops``,
    ``sdpa_backend``, ``speedup`` (SDPA's seconds a call over flash's),
    ``checksum_rel_err`` (the flash output's sum against the comparator's)
    and each side's Δt (None where the absolute time stood in).
    """
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((t, d), generator=gen, device=dev,
                           dtype=torch.bfloat16) for _ in range(3))

    def flash(a, b, c):
        return flash_attention(a, b, c, causal=True)

    # the comparator: the fastest backend that takes the inputs, by its
    # short chain (reused below)
    lo_runs = {}
    for backend in SDPA_BACKENDS if dev.type == "cuda" else ("MATH",):
        try:
            run = _chained(_sdpa(backend), q, k, v, reps_lo)
        except RuntimeError:
            continue
        lo_runs[backend] = (measure_best(run, iters=iters, warmup=1), run)
    if not lo_runs:
        raise RuntimeError(f"no SDPA backend takes bf16 [{t}, {d}] causal")
    backend = min(lo_runs, key=lambda name: lo_runs[name][0])
    sdpa, sdpa_lo = _sdpa(backend), lo_runs.pop(backend)[1]
    del lo_runs  # the other backends' graphs and their memory pools

    got = flash(q, k, v).float().sum().item()
    want = sdpa(q, k, v).float().sum().item()
    rel_err = abs(got - want) / max(abs(want), 1e-6)

    s_flash, dt_flash = _per_call_seconds(
        _chained(flash, q, k, v, reps_hi), _chained(flash, q, k, v, reps_lo),
        reps_hi, reps_lo, iters, repeats)
    s_sdpa, dt_sdpa = _per_call_seconds(
        _chained(sdpa, q, k, v, reps_hi), sdpa_lo, reps_hi, reps_lo, iters,
        repeats)
    flops = 2 * t * t * d
    rep = {"seq_len": t, "d": d,
           "flash_tflops": flops / s_flash / 1e12,
           "sdpa_tflops": flops / s_sdpa / 1e12,
           "sdpa_backend": backend,
           "speedup": s_sdpa / s_flash,
           "checksum_rel_err": rel_err,
           "flash_dt_s": dt_flash, "sdpa_dt_s": dt_sdpa}
    if dev.type == "cpu":
        rep["note"] = ("CPU: the plain version against SDPA's math "
                       "backend; these times are not a card's")
    return rep
