"""Library collectives over a mesh axis, on per-rank lists of tensors.

The port's counterparts of ``lax.psum``, ``lax.all_gather(tiled=True)``,
``lax.psum_scatter(tiled=True)`` and ``lax.ppermute`` as the reference's dry
run and ring attention use them. Every function takes ``xs``, one tensor per
rank of the mesh (indexed by flat rank), and returns the same: each group of
the axis exchanges among its own members, and each result lies on its rank's
device. They are plain PyTorch; the hand-scheduled ring kernels are in
``parallel/ring.py``.

Each call appends one :class:`Collective` record to every open
:func:`recording` log: the op, the axis and its grouping (a set of sets of
ranks). The log stands in for the ``replica_groups`` the reference parses
out of the compiled HLO, so the dry run can assert which groups a step's
sums ran over.

:func:`psum` is differentiable: its gradient is a psum over the same groups
(the transpose of a sum that every member receives), computed in the
backward pass. The log records the forward calls only.

The reference's bandwidth suite in its ``collectives.py`` is not ported yet.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from tpu_operator_torch.parallel.mesh import Mesh


@dataclass(frozen=True)
class Collective:
    op: str
    axis: str
    grouping: frozenset


_logs: list[list[Collective]] = []


@contextlib.contextmanager
def recording():
    """Collect the collectives called inside the block into a list."""
    log: list[Collective] = []
    _logs.append(log)
    try:
        yield log
    finally:
        _logs.remove(log)


def _record(op: str, mesh: Mesh, axis: str) -> list[list[int]]:
    for log in _logs:
        log.append(Collective(op, axis, mesh.grouping(axis)))
    return mesh.groups(axis)


def _check(xs, mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} tensors for a mesh of {mesh.size} ranks")


def _sum(xs):
    """x0 + x1 + ... in order, on x0's device."""
    total = xs[0]
    for x in xs[1:]:
        total = total + x.to(total.device)
    return total


class _GroupSum(torch.autograd.Function):
    """One group's sum, handed to every member; its gradient is the same
    sum of the members' gradients."""

    @staticmethod
    def forward(ctx, *xs):
        total = _sum(xs)
        return tuple(total.to(x.device, copy=True) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        total = _sum(grads)
        return tuple(total.to(g.device, copy=True) for g in grads)


def psum(xs, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Every rank gets the sum over its ``axis`` group."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for group in _record("psum", mesh, axis):
        for rank, y in zip(group, _GroupSum.apply(*(xs[r] for r in group))):
            out[rank] = y
    return out


def all_gather(xs, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Every rank gets its group's tensors concatenated on axis 0, in group
    order (``lax.all_gather(tiled=True)``)."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for group in _record("all_gather", mesh, axis):
        for rank in group:
            dev = mesh.device(rank)
            out[rank] = torch.cat([xs[r].to(dev) for r in group])
    return out


def psum_scatter(xs, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """The group's sum, split on axis 0 into as many chunks as members: the
    member at position p gets chunk p (``lax.psum_scatter(tiled=True)``)."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for group in _record("psum_scatter", mesh, axis):
        if xs[group[0]].shape[0] % len(group):
            raise ValueError(f"axis 0 of {tuple(xs[group[0]].shape)} not "
                             f"divisible by {len(group)}")
        chunks = _sum([xs[r] for r in group]).chunk(len(group))
        for rank, chunk in zip(group, chunks):
            out[rank] = chunk.to(mesh.device(rank), copy=True)
    return out


def ppermute(xs, mesh: Mesh, axis: str, perm) -> list[torch.Tensor]:
    """Send position ``src``'s tensor to position ``dst`` of the same group,
    for each ``(src, dst)`` in ``perm``; a rank that receives nothing gets
    zeros (``lax.ppermute``)."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for group in _record("ppermute", mesh, axis):
        for rank in group:
            out[rank] = torch.zeros_like(xs[rank])
        for src, dst in perm:
            out[group[dst]] = xs[group[src]].to(mesh.device(group[dst]),
                                                copy=True)
    return out
