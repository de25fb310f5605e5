"""Library collectives over a mesh axis, on per-rank lists of tensors, and
the collective bandwidth suite.

The port's counterparts of ``lax.psum``, ``lax.all_gather(tiled=True)``,
``lax.psum_scatter(tiled=True)``, ``lax.all_to_all`` and ``lax.ppermute`` as
the reference's dry run, bandwidth suite and sequence-parallel attention use
them. Every function takes ``xs``, one tensor per
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

The bandwidth suite (:func:`run_collective_suite`) is the validator's fabric
check: it runs every collective the framework relies on over a mesh axis and
reports achieved GB/s, with the ring-algorithm "bus bandwidth" conventions
of nccl-tests so that figures compare across fabrics:

  allreduce      busbw = 2 * (n-1)/n * bytes / t
  all_gather     busbw = (n-1)/n * bytes_out / t
  reduce_scatter busbw = (n-1)/n * bytes_in / t
  all_to_all     busbw = (n-1)/n * bytes_per_rank / t   (each rank keeps 1/n)
  ppermute ring  busbw = bytes / t            (each link carries the payload)

On a mesh of virtual ranks of one card it also times the hand-scheduled
ring all-reduces of ``parallel/ring.py`` on the same payload: the pinned-schedule comparators
whose gap to the library sum separates a poor schedule from a slow link.
On virtual ranks of one card nothing crosses a link: every figure is then a
loopback through device memory (copies and adds of the card's own memory,
with the host's time per call in it), not an NVLink rate.
"""

from __future__ import annotations

import contextlib
from dataclasses import asdict, dataclass

import torch

from tpu_operator_torch.parallel.mesh import Mesh
from tpu_operator_torch.utils.timing import measure_best


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


def all_to_all(xs, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Each rank's tensor has one block per group member on axis 0; the
    member at position p sends block i to position i and ends with the
    blocks it received, in position order (``lax.all_to_all`` with
    ``split_axis=0, concat_axis=0``)."""
    _check(xs, mesh)
    out = [None] * mesh.size
    for group in _record("all_to_all", mesh, axis):
        for r in group:
            if xs[r].shape[0] != len(group):
                raise ValueError(f"axis 0 of {tuple(xs[r].shape)} is not "
                                 f"the group size {len(group)}")
        for i, rank in enumerate(group):
            dev = mesh.device(rank)
            out[rank] = torch.stack([xs[r][i].to(dev) for r in group])
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


# -- the bandwidth suite ------------------------------------------------------

@dataclass(frozen=True)
class CollectiveReport:
    op: str
    axis: str
    n_devices: int
    payload_bytes: int
    seconds: float
    busbw_gbps: float  # bus bandwidth, GB/s (1e9 bytes/s)

    def to_dict(self) -> dict:
        return asdict(self)


def _timed(fn, iters: int) -> float:
    """Best wall time of ``fn()``, which returns one tensor or a list of
    them. The completion barrier is a synchronise of the device's stream,
    then a fetch of one element of each output: on virtual ranks, where the
    collective itself only moves device memory, a barrier that read every
    output would add as many bytes as it times."""
    def run():
        ys = fn()
        ys = [ys] if isinstance(ys, torch.Tensor) else ys
        if ys[0].device.type == "cuda":
            torch.cuda.current_stream(ys[0].device).synchronize()
        return [y[(0,) * y.dim()].item() for y in ys]
    return measure_best(run, iters=iters)


def _zeros(mesh: Mesh, shape) -> list[torch.Tensor]:
    return [torch.zeros(shape, dtype=torch.float32, device=mesh.device(r))
            for r in range(mesh.size)]


def allreduce_bandwidth(mesh: Mesh, axis: str = "model", mbytes: int = 64,
                        iters: int = 5) -> CollectiveReport:
    """psum a float32 buffer of ``mbytes`` MB per rank across ``axis``."""
    n = mesh.shape[axis]
    elems = mbytes * (1 << 20) // 4
    xs = _zeros(mesh, (1, elems))
    t = _timed(lambda: psum(xs, mesh, axis), iters)
    per_rank_bytes = elems * 4
    busbw = 2 * (n - 1) / n * per_rank_bytes / t / 1e9
    return CollectiveReport("allreduce", axis, n, per_rank_bytes, t, busbw)


def allgather_bandwidth(mesh: Mesh, axis: str = "model", mbytes: int = 64,
                        iters: int = 5) -> CollectiveReport:
    """all_gather shards of an ``mbytes`` MB output buffer across ``axis``."""
    n = mesh.shape[axis]
    elems = mbytes * (1 << 20) // 4 // n
    xs = _zeros(mesh, (1, elems))
    out_bytes = elems * n * 4
    t = _timed(lambda: all_gather(xs, mesh, axis), iters)
    busbw = (n - 1) / n * out_bytes / t / 1e9
    return CollectiveReport("all_gather", axis, n, out_bytes, t, busbw)


def reducescatter_bandwidth(mesh: Mesh, axis: str = "model",
                            mbytes: int = 64,
                            iters: int = 5) -> CollectiveReport:
    """psum_scatter an ``mbytes`` MB per-rank buffer across ``axis``."""
    n = mesh.shape[axis]
    elems = mbytes * (1 << 20) // 4
    elems -= elems % n
    xs = _zeros(mesh, (elems,))
    in_bytes = elems * 4
    t = _timed(lambda: psum_scatter(xs, mesh, axis), iters)
    busbw = (n - 1) / n * in_bytes / t / 1e9
    return CollectiveReport("reduce_scatter", axis, n, in_bytes, t, busbw)


def alltoall_bandwidth(mesh: Mesh, axis: str = "model", mbytes: int = 64,
                       iters: int = 5) -> CollectiveReport:
    """all_to_all an ``mbytes`` MB per-rank buffer across ``axis``: the
    transpose behind expert parallelism and the head/sequence reshard of
    Ulysses attention. Each rank sends (n-1)/n of its payload."""
    n = mesh.shape[axis]
    elems = mbytes * (1 << 20) // 4
    elems -= elems % n
    xs = _zeros(mesh, (n, elems // n))
    per_rank_bytes = elems * 4
    t = _timed(lambda: all_to_all(xs, mesh, axis), iters)
    busbw = (n - 1) / n * per_rank_bytes / t / 1e9
    return CollectiveReport("all_to_all", axis, n, per_rank_bytes, t, busbw)


def ppermute_ring_bandwidth(mesh: Mesh, axis: str = "model",
                            mbytes: int = 64,
                            iters: int = 5) -> CollectiveReport:
    """Shift an ``mbytes`` MB buffer one hop around the ``axis`` ring: the
    single-link rate, the building block of ring attention."""
    n = mesh.shape[axis]
    elems = mbytes * (1 << 20) // 4
    xs = _zeros(mesh, (1, elems))
    perm = [(i, (i + 1) % n) for i in range(n)]
    t = _timed(lambda: ppermute(xs, mesh, axis, perm), iters)
    bytes_ = elems * 4
    return CollectiveReport("ppermute_ring", axis, n, bytes_, t,
                            bytes_ / t / 1e9)


def ring_allreduce_bandwidth(mesh: Mesh, axis: str = "model",
                             mbytes: int = 64, iters: int = 5,
                             bidir: bool = False) -> CollectiveReport:
    """Time the hand-scheduled ring all-reduce (``parallel/ring.py``) on
    the same payload as :func:`allreduce_bandwidth`; ``bidir`` times the
    bidirectional kernel (both directions loaded)."""
    from tpu_operator_torch.parallel.ring import (
        ring_all_reduce_bidir_sharded, ring_all_reduce_sharded)
    n = mesh.shape[axis]
    # per-rank addend (rows/n, cols); the kernels chunk rows/n by n (2n for
    # bidir), so round the row count up to the next multiple
    cols = 512
    per_rank_rows = max(1, mbytes * (1 << 20) // 4 // cols)
    per_rank_rows += -per_rank_rows % (2 * n if bidir else n)
    x = torch.zeros((n * per_rank_rows, cols), dtype=torch.float32,
                    device=mesh.device(0))
    kernel = ring_all_reduce_bidir_sharded if bidir \
        else ring_all_reduce_sharded
    t = _timed(lambda: kernel(x, mesh, axis), iters)
    per_rank_bytes = per_rank_rows * cols * 4
    busbw = 2 * (n - 1) / n * per_rank_bytes / t / 1e9
    return CollectiveReport(
        "ring_allreduce_bidir" if bidir else "ring_allreduce", axis, n,
        per_rank_bytes, t, busbw)


def run_collective_suite(mesh: Mesh, axis: str = "model", mbytes: int = 64,
                         iters: int = 5) -> list[CollectiveReport]:
    """The validator's fabric check: every collective the framework relies
    on."""
    if mesh.shape[axis] < 2:
        return []  # a single rank on this axis: fabric N/A
    reports = [
        allreduce_bandwidth(mesh, axis, mbytes, iters),
        allgather_bandwidth(mesh, axis, mbytes, iters),
        reducescatter_bandwidth(mesh, axis, mbytes, iters),
        alltoall_bandwidth(mesh, axis, mbytes, iters),
        ppermute_ring_bandwidth(mesh, axis, mbytes, iters),
    ]
    if mesh.device(0).type == "cuda" and len(
            {mesh.device(r) for r in range(mesh.size)}) == 1:
        # the hand-scheduled comparators are CUDA kernels over virtual
        # ranks of one card; on a CPU mesh their plain versions would time
        # a simulation, not a fabric, and they take no ranks across cards
        reports.append(ring_allreduce_bandwidth(mesh, axis, mbytes, iters))
        reports.append(ring_allreduce_bandwidth(mesh, axis, mbytes, iters,
                                                bidir=True))
    return reports
