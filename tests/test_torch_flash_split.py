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

import pytest
import torch

from chip_smoke import limit_ratio
from torch_flash_split import T, bf16_inputs, grid_case
from tpu_operator_torch.ops import flash_attention as port

# The schedule's plain twin against the reference's kernel is spread over
# test_torch_flash_split_limit_*.py (T = 576) and the grid's files,
# test_torch_flash_split_grid_*.py (any T, any D, both 16-bit types),
# about a minute of one worker each; their shared inputs are in
# tests/torch_flash_split.py.


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
    q, k, v = bf16_inputs(1)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    parts = port.split_partials(q, k, v, causal, 2)
    assert limit_ratio(_merged(parts, port.combine_partials), ref,
                       limit) <= 1.0
    assert limit_ratio(_merged(parts, merge), ref, limit) > 1.0


def test_one_unit_per_q_tile_is_the_unsplit_online_softmax():
    """With units as long as a row, no merge runs: each q tile's output is
    its one unit's acc / l."""
    q, k, v = bf16_inputs(4)
    whole = port.split_partials(q, k, v, True, T // port.BLOCK)
    assert all(len(ps) == 1 for ps in whole.values())
    torch.testing.assert_close(
        port.flash_split_plain(q, k, v, True, T // port.BLOCK),
        _merged(whole, port.combine_partials).reshape(q.shape))


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
    arrays, _ = grid_case("float16", 96, 200, True)
    q, k, v = (torch.from_numpy(a[0]).to(torch.float16) for a in arrays)
    ref, limit = port.kernel_error_limit(q, k, v, causal=True)
    parts = port.split_partials(q, k, v, True, 1)
    merged = torch.cat([merge(parts[row]) for row in range(len(parts))],
                       dim=-2).to(torch.float16)
    assert limit_ratio(merged, ref, limit) > 1.0
