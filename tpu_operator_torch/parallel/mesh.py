"""The (data, model) rank mesh, over virtual ranks on one card.

The port of ``tpu_operator/parallel/mesh.py``. ``MeshPlan`` and
``MeshPlan.auto`` are copied (that module imports jax) into the torch-free
``mesh_plan`` and re-exported here, so the validator and the operator's
reshard planner share one factorization. A :class:`Mesh` is a
grid of rank devices in row-major order, as the reference's naive layout
(``np.array(devices).reshape(data, model)``), with the axis names and, for
each axis, its rank groups: the ranks that differ only in that axis's
coordinate. On a (data, model) mesh the model groups are contiguous and the
data groups strided by ``plan.model``, as ``__graft_entry__._assert_collectives``
expects.

A rank is a flat index into the grid. Without ``devices``, ``make_mesh``
puts every rank on one device: n *virtual ranks*, each with its own tensors,
that the port's collectives and ring kernels treat as separate ranks. NCCL
refuses two ranks on one GPU, and the machine the port is measured on has
one card, so that is how the multi-device path runs there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_operator_torch.parallel.mesh_plan import MeshPlan
from tpu_operator_torch.utils.device import resolve_device


class Mesh:
    """A grid of rank devices with named axes.

    ``devices`` is an array of ``torch.device`` (any shape, one dimension
    per axis); rank r is the r-th element in row-major order."""

    def __init__(self, devices, axis_names: tuple[str, ...]):
        grid = np.vectorize(torch.device, otypes=[object])(
            np.asarray(devices, dtype=object))
        if grid.ndim != len(axis_names):
            raise ValueError(f"{grid.ndim}-d device grid for axes "
                             f"{axis_names}")
        self.devices = grid
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, grid.shape))
        self._ranks = np.arange(grid.size).reshape(grid.shape)

    @property
    def size(self) -> int:
        return self.devices.size

    def device(self, rank: int) -> torch.device:
        return self.devices.flat[rank]

    def coords(self, rank: int) -> dict[str, int]:
        """The rank's coordinate along each axis."""
        idx = np.unravel_index(rank, self.devices.shape)
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def groups(self, axis: str) -> list[list[int]]:
        """The rank groups of ``axis``, each in order of its coordinate."""
        k = self.axis_names.index(axis)
        moved = np.moveaxis(self._ranks, k, -1)
        return [[int(r) for r in row]
                for row in moved.reshape(-1, self.shape[axis])]

    def grouping(self, axis: str) -> frozenset[frozenset[int]]:
        """The groups of ``axis`` as a set of sets, the form the reference
        parses out of an HLO's ``replica_groups``."""
        return frozenset(frozenset(g) for g in self.groups(axis))


def make_mesh(n_devices: int, plan: MeshPlan | None = None, devices=None,
              device="cuda") -> Mesh:
    """A 2-axis ("data", "model") mesh of ``n_devices`` ranks, laid out
    row-major. With no ``devices``, all ranks are virtual ranks on
    ``device``."""
    if plan is None:
        plan = MeshPlan.auto(n_devices)
    if plan.n_devices != n_devices:
        raise ValueError(f"plan {plan} does not cover {n_devices} devices")
    if devices is None:
        devices = [resolve_device(device)] * n_devices
    if n_devices > len(devices):
        raise ValueError(f"requested {n_devices} devices, have {len(devices)}")
    grid = np.empty(n_devices, dtype=object)
    grid[:] = list(devices[:n_devices])
    return Mesh(grid.reshape(plan.data, plan.model), ("data", "model"))
