"""The port's multi-device dry run on the CPU: n virtual ranks, one
full-width sharded train step, the collectives assertion and the ring
kernels' plain versions held against the library collectives."""

import pytest
import torch

from tpu_operator_torch import entry
from tpu_operator_torch.ops import burnin
from tpu_operator_torch.parallel import collectives
from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh


@pytest.mark.parametrize("n,plan", [(4, "data=2,model=2"),
                                    (8, "data=2,model=4"),
                                    (2, "data=2,model=1"),
                                    (1, "data=1,model=1")])
def test_dryrun_on_the_cpu_prints_ok(capsys, n, plan):
    loss = entry.dryrun_multigpu(n, device="cpu")
    out = capsys.readouterr().out
    assert f"DRYRUN OK: n={n} plan=({plan}) loss={loss:.4f}" in out
    assert "devices=['cpu']" in out


def test_dryrun_fails_without_the_model_group_sum(monkeypatch):
    """A step that leaves out the row-parallel output sum must fail the
    collectives assertion (its loss alone would not show it)."""
    def psum_without_model(xs, mesh, axis):
        if axis == "model":
            return list(xs)
        return collectives.psum(xs, mesh, axis)

    monkeypatch.setattr(burnin, "psum", psum_without_model)
    with pytest.raises(AssertionError, match="model axis grouping"):
        entry.dryrun_multigpu(4, device="cpu")


def test_assert_collectives_tells_data_from_model_groups():
    """With data == model the group sizes alias; the groupings do not."""
    plan = MeshPlan(2, 2)
    mesh = make_mesh(4, plan, device="cpu")
    xs = [torch.ones(1) for _ in range(4)]
    with collectives.recording() as log:
        collectives.psum(xs, mesh, "model")
    with pytest.raises(AssertionError, match="data axis grouping"):
        entry._assert_collectives(log, plan)
    with collectives.recording() as log:
        collectives.psum(xs, mesh, "model")
        collectives.psum(xs, mesh, "data")
    entry._assert_collectives(log, plan)
    entry._assert_collectives([], MeshPlan(1, 1))


def test_check_ring_kernels_catches_a_wrong_reduction(monkeypatch):
    from tpu_operator_torch.parallel import ring
    monkeypatch.setattr(entry, "ring_all_reduce_sharded",
                        lambda a, mesh, axis: 1.001 * ring
                        .ring_all_reduce_sharded(a, mesh, axis))
    with pytest.raises(AssertionError, match="ring all-reduce"):
        entry.dryrun_multigpu(4, device="cpu")


def test_dryrun_needs_a_width_the_mesh_divides():
    # 6 ranks plan as (2, 3): d_hidden 2048 does not split three ways
    with pytest.raises(ValueError, match="divisible"):
        entry.dryrun_multigpu(6, device="cpu")


def test_dryrun_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry.dryrun_multigpu(4)
