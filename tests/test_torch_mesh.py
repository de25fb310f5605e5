"""The port's mesh against the reference's: the same plans, the same rank
grid and the same groups along each axis."""

import jax
import numpy as np
import pytest
import torch

from tpu_operator.parallel.mesh import MeshPlan as JaxPlan
from tpu_operator.parallel.mesh import make_mesh as jax_make_mesh
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh


@pytest.mark.parametrize("n", range(1, 65))
def test_auto_plan_equals_the_reference(n):
    for max_model in (8, max(1, n // 2), 1, 64):
        want = JaxPlan.auto(n, max_model=max_model)
        got = MeshPlan.auto(n, max_model=max_model)
        assert (got.data, got.model) == (want.data, want.model)
        assert got.n_devices == n


@pytest.mark.parametrize("data,model", [(1, 1), (2, 1), (1, 2), (2, 2),
                                        (4, 2), (2, 4), (8, 1), (1, 8)])
def test_rank_grid_and_groups_equal_the_reference_mesh(data, model):
    n = data * model
    ref = jax_make_mesh(n, JaxPlan(data, model))
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    mesh = make_mesh(n, MeshPlan(data, model), device="cpu")
    assert mesh.axis_names == ref.axis_names == ("data", "model")
    assert mesh.shape == dict(ref.shape)
    np.testing.assert_array_equal(np.arange(n).reshape(data, model), ids)
    # model groups are the rows of the grid (contiguous), data groups its
    # columns (strided by plan.model)
    assert mesh.groups("model") == [list(row) for row in ids]
    assert mesh.groups("data") == [list(col) for col in ids.T]
    assert mesh.grouping("data") == frozenset(
        frozenset(range(j, n, model)) for j in range(model))
    for rank in range(n):
        coords = mesh.coords(rank)
        assert ids[coords["data"], coords["model"]] == rank


def test_virtual_ranks_share_the_one_device():
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    assert [mesh.device(r) for r in range(4)] == [torch.device("cpu")] * 4
    assert mesh.size == 4


def test_explicit_devices_are_laid_out_row_major():
    devices = [torch.device("cpu", i) for i in range(6)]
    mesh = make_mesh(6, MeshPlan(3, 2), devices=devices)
    assert [mesh.device(r) for r in range(6)] == devices
    assert mesh.groups("model") == [[0, 1], [2, 3], [4, 5]]


def test_one_axis_mesh_has_one_group():
    mesh = Mesh(np.array([torch.device("cpu")] * 3, dtype=object), ("ring",))
    assert mesh.shape == {"ring": 3} and mesh.groups("ring") == [[0, 1, 2]]


def test_make_mesh_rejects_a_plan_that_does_not_cover():
    with pytest.raises(ValueError, match="does not cover"):
        make_mesh(4, MeshPlan(2, 1), device="cpu")
    with pytest.raises(ValueError, match="requested"):
        make_mesh(4, MeshPlan(2, 2), devices=[torch.device("cpu")] * 2)


def test_reference_mesh_is_over_the_virtual_cpu_devices():
    assert len(jax.devices()) == 8
