"""The card's schedule for K2 (flash attention), in plain PyTorch on the CPU.

On the card the kv loop of each q tile is cut into units of at most
``split`` kv tiles; a split q tile's units leave partial softmax states that
a second kernel merges by the log-sum-exp rule. ``flash_split_plain`` runs
that schedule with the kernel's roundings (P to bf16 before P·V, the output
once to bf16). It must stay within the per-element limit of the f32 oracle
that the kernel is held to on the card, and within the attention tolerance
of the reference's Pallas kernel in interpret mode, on the same numpy
inputs; a merge that drops a unit or skips the rescale must not.
"""

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import limit_ratio
from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance

T, D = 576, 128   # 9 tiles of 64: with split 8, a unit of 8 and one of 1
_rng = np.random.default_rng(23)
INPUTS = {heads: [_rng.standard_normal(shape, dtype=np.float32)
                  for _ in range(3)]
          for heads, shape in ((1, (T, D)), (4, (4, T, D)))}


def _torch(heads):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in INPUTS[heads]]


@functools.lru_cache(maxsize=None)
def _reference(heads, causal):
    """The reference's Pallas kernel in interpret mode, in bf16."""
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in INPUTS[heads])

    def one(a, b, c):
        return jax_flash(a, b, c, causal=causal, block_q=port.BLOCK,
                         block_k=port.BLOCK, interpret=True)
    out = jax.vmap(one)(jq, jk, jv) if heads > 1 else one(jq, jk, jv)
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", [1, 2, 8])
def test_split_plain_within_the_kernel_limit_and_the_reference(split, causal,
                                                               heads):
    q, k, v = _torch(heads)
    got = port.flash_split_plain(q, k, v, causal, split)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(torch.bfloat16, D)
    np.testing.assert_allclose(got.float().numpy(), _reference(heads, causal),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("split", [1, 3, 8, 64])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,t", [(1, 64), (1, 576), (3, 1024),
                                     (1, 4096)])
def test_work_list_covers_each_tile_pair_once_longest_first(heads, t, causal,
                                                            split):
    units, merges = port.work_list(heads, t, causal, split)
    nq = t // port.BLOCK
    covered = collections.Counter(
        (row, j) for row, j0, j1, _ in units for j in range(j0, j1))
    assert set(covered.values()) == {1}
    assert set(covered) == {(row, j) for row in range(heads * nq)
                            for j in range(row % nq + 1 if causal else nq)}
    lengths = [j1 - j0 for _, j0, j1, _ in units]
    assert lengths == sorted(lengths, reverse=True)
    assert max(lengths) == min(split, nq)
    # a q tile with one unit writes the output; a split one's units take
    # consecutive slots in kv order, and one merge covers them
    by_row = collections.defaultdict(list)
    for row, j0, _, slot in units:
        by_row[row].append((j0, slot))
    slots = {row: [slot for _, slot in sorted(us)]
             for row, us in by_row.items()}
    assert {row: (s[0], len(s)) for row, s in slots.items()
            if s[0] >= 0} == {row: (first, count)
                              for row, first, count in merges}
    for s in slots.values():
        assert s == [-1] or s == list(range(s[0], s[0] + len(s)))
    assert sorted(s for row in slots for s in slots[row] if s >= 0) == \
        list(range(sum(count for *_, count in merges)))


def test_work_list_at_the_main_path_shape():
    """T = 4096 causal with 8 kv tiles a unit: 288 units in place of the 64
    q tiles, the longest 8 tiles instead of 64."""
    units, merges = port.work_list(1, 4096, True, 8)
    assert len(units) == 288 and len(merges) == 56
    assert units[0][2] - units[0][1] == 8
    with pytest.raises(ValueError, match="split"):
        port.work_list(1, 4096, True, 0)


def _merged(parts, merge):
    return torch.cat([merge(parts[row]) for row in range(len(parts))],
                     dim=-2).to(torch.bfloat16)


def _drop_a_unit(ps):
    return port.combine_partials(ps[:-1] if len(ps) > 1 else ps)


def _skip_the_rescale(ps):
    l = sum(p[1] for p in ps)
    return sum(p[2] for p in ps) / l[..., None]


@pytest.mark.parametrize("merge", [_drop_a_unit, _skip_the_rescale])
@pytest.mark.parametrize("causal", [False, True])
def test_a_wrong_merge_is_rejected_by_the_limit(causal, merge):
    q, k, v = _torch(1)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    parts = port.split_partials(q, k, v, causal, 2)
    assert limit_ratio(_merged(parts, port.combine_partials), ref,
                       limit) <= 1.0
    assert limit_ratio(_merged(parts, merge), ref, limit) > 1.0


def test_one_unit_per_q_tile_is_the_unsplit_online_softmax():
    """With units as long as a row, no merge runs: each q tile's output is
    its one unit's acc / l."""
    q, k, v = _torch(4)
    whole = port.split_partials(q, k, v, True, T // port.BLOCK)
    assert all(len(ps) == 1 for ps in whole.values())
    torch.testing.assert_close(
        port.flash_split_plain(q, k, v, True, T // port.BLOCK),
        _merged(whole, port.combine_partials).reshape(q.shape))


# -- the schedule at any T, any D and both 16-bit types (K2w, K2s) ----------

GRID_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
               "float16": (jnp.float16, torch.float16)}


@functools.lru_cache(maxsize=None)
def _grid_case(dtype, d, t, causal):
    """Three heads of numpy inputs, and the reference's Pallas kernel on
    them in interpret mode, in ``dtype``, with blocks that divide T."""
    rng = np.random.default_rng(d * 7 + t)
    arrays = [rng.standard_normal((3, t, d), dtype=np.float32)
              for _ in range(3)]
    jdt, _ = GRID_DTYPES[dtype]
    block = min(t, 256)

    def one(a, b, c):
        return jax_flash(a, b, c, causal=causal, block_q=block,
                         block_k=block, interpret=True)
    want = jax.vmap(one)(*(jnp.asarray(a, jdt) for a in arrays))
    return arrays, np.asarray(want, np.float32)


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [96, 200, 1024])
@pytest.mark.parametrize("d", [64, 96, 256])
@pytest.mark.parametrize("dtype", sorted(GRID_DTYPES))
def test_split_plain_at_any_shape_matches_the_reference(dtype, d, t, causal,
                                                        heads):
    """The schedule's plain twin at T that 64 does not divide (96, 200), D
    off the buckets (96) and both 16-bit types, in units of 3 kv tiles:
    within the per-element limit of the f32 oracle and the attention
    tolerance of the reference's kernel."""
    arrays, want = _grid_case(dtype, d, t, causal)
    q, k, v = (torch.from_numpy(a[:heads]).to(GRID_DTYPES[dtype][1])
               for a in arrays)
    want = want[:heads]
    if heads == 1:
        q, k, v, want = q[0], k[0], v[0], want[0]
    got = port.flash_split_plain(q, k, v, causal, split=3)
    assert got.dtype == q.dtype and got.shape == q.shape
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [200, 1024])
def test_split_plain_in_steps_of_32_keys(t, causal):
    """K2w's schedule at DP = 256 with kv steps of 32 keys (two a 64-key
    tile): the same limit and tolerance."""
    arrays, want = _grid_case("bfloat16", 256, t, causal)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = port.flash_split_plain(q, k, v, causal, split=3, block_k=32)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, 256)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="block_k"):
        port.split_partials(q, k, v, causal, 3, block_k=48)


@pytest.mark.parametrize("split", [1, 3, 8])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("heads,t", [(1, 1), (1, 96), (2, 200), (3, 1000)])
def test_work_list_at_ragged_t_covers_each_tile_pair_once(heads, t, causal,
                                                          split):
    """At T that 64 does not divide the last q and kv tiles are short:
    ⌈T/64⌉ of each, every (q tile, kv tile) pair once, longest first."""
    units, merges = port.work_list(heads, t, causal, split)
    nq = -(-t // port.BLOCK)
    covered = collections.Counter(
        (row, j) for row, j0, j1, _ in units for j in range(j0, j1))
    assert set(covered.values()) == {1}
    assert set(covered) == {(row, j) for row in range(heads * nq)
                            for j in range(row % nq + 1 if causal else nq)}
    lengths = [j1 - j0 for _, j0, j1, _ in units]
    assert lengths == sorted(lengths, reverse=True)
    assert max(lengths) == min(split, nq)
    assert sum(count for *_, count in merges) == \
        sum(1 for *_, slot in units if slot >= 0)


@pytest.mark.parametrize("merge", [_drop_a_unit, _skip_the_rescale])
def test_a_wrong_merge_is_rejected_at_a_ragged_f16_shape(merge):
    """The limit at f16's unit roundoff still rejects a merge that drops a
    unit or skips the rescale, at T = 200, D = 96."""
    arrays, _ = _grid_case("float16", 96, 200, True)
    q, k, v = (torch.from_numpy(a[0]).to(torch.float16) for a in arrays)
    ref, limit = port.kernel_error_limit(q, k, v, causal=True)
    parts = port.split_partials(q, k, v, True, 1)
    merged = torch.cat([merge(parts[row]) for row in range(len(parts))],
                       dim=-2).to(torch.float16)
    assert limit_ratio(merged, ref, limit) > 1.0
