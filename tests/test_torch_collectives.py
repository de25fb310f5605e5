"""The port's all_to_all and collective bandwidth suite against the
reference's, on the same numpy inputs and the same payload sizes."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tpu_operator.parallel import collectives as jax_collectives
from tpu_operator.parallel.mesh import MeshPlan as JaxMeshPlan
from tpu_operator.parallel.mesh import make_mesh as jax_make_mesh
from tpu_operator_torch.parallel import collectives
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh

SUITE_OPS = ["allreduce", "all_gather", "reduce_scatter", "all_to_all",
             "ppermute_ring"]


def _line_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("model",))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_all_to_all_equals_the_reference_exchange(n):
    """The same numpy payload through the exchange the reference's probe
    times (``_alltoall_step``) and through the port's: exactly equal."""
    elems = 6 * n
    x = np.random.default_rng(n).standard_normal((n, elems), dtype=np.float32)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    step = jax_collectives._alltoall_step(jmesh, "model", n, elems)
    want = np.asarray(step(jax.device_put(
        x, NamedSharding(jmesh, P("model", None)))))
    # the reference's per-device shard is (1, elems), reshaped to n blocks
    xs = [torch.from_numpy(x[r]).reshape(n, elems // n) for r in range(n)]
    got = collectives.all_to_all(xs, _line_mesh(n), "model")
    assert all(g.shape == (n, elems // n) for g in got)
    np.testing.assert_array_equal(
        np.concatenate([g.numpy() for g in got]), want)


def test_all_to_all_is_the_transpose():
    n = 4
    x = torch.arange(n * n, dtype=torch.float32).reshape(n, n)
    got = collectives.all_to_all([x[r].reshape(n, 1) for r in range(n)],
                                 _line_mesh(n), "model")
    assert torch.equal(torch.stack(got).reshape(n, n), x.T)


def test_all_to_all_exchanges_within_each_group_and_is_recorded():
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    xs = [torch.full((2, 3), float(r)) for r in range(4)]
    with collectives.recording() as log:
        got = collectives.all_to_all(xs, mesh, "model")
    # model groups are (0, 1) and (2, 3): each member ends with one block
    # from each member of its own group, in position order
    for rank, members in ((0, (0, 1)), (1, (0, 1)), (2, (2, 3)),
                          (3, (2, 3))):
        assert got[rank][:, 0].tolist() == [float(m) for m in members]
    assert log == [collectives.Collective("all_to_all", "model",
                                          mesh.grouping("model"))]


def test_all_to_all_rejects_a_wrong_block_count():
    with pytest.raises(ValueError, match="group size"):
        collectives.all_to_all([torch.zeros((3, 2))] * 4, _line_mesh(4),
                               "model")


def test_collective_suite_reports_what_the_reference_reports():
    """mbytes = 1 over the model axis of a (2, 4) mesh, as the reference's
    own test runs it: the same ops in the same order, the same payload
    bytes and group size, and a finite positive rate."""
    want = jax_collectives.run_collective_suite(
        jax_make_mesh(8, JaxMeshPlan(data=2, model=4)), axis="model",
        mbytes=1, iters=1)
    got = collectives.run_collective_suite(
        make_mesh(8, MeshPlan(data=2, model=4), device="cpu"), axis="model",
        mbytes=1, iters=2)
    # off CUDA neither side appends its hand-ring comparators
    assert [r.op for r in got] == [r.op for r in want] == SUITE_OPS
    for g, w in zip(got, want):
        assert (g.axis, g.n_devices, g.payload_bytes) == \
            (w.axis, w.n_devices, w.payload_bytes)
        assert np.isfinite(g.busbw_gbps) and g.busbw_gbps > 0
        assert g.seconds > 0
        assert set(g.to_dict()) == set(w.to_dict())


@pytest.mark.parametrize("n", [3, 8])
def test_payloads_round_down_to_the_group_size_as_the_reference(n):
    """An axis of 3 does not divide 1 MiB of f32: the reduce-scatter and
    all-to-all payloads lose the remainder, the all-gather's shards too."""
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    mesh = _line_mesh(n)
    for name in ("allgather_bandwidth", "reducescatter_bandwidth",
                 "alltoall_bandwidth"):
        want = getattr(jax_collectives, name)(jmesh, "model", 1, 1)
        got = getattr(collectives, name)(mesh, "model", 1, 1)
        assert (got.op, got.n_devices, got.payload_bytes) == \
            (want.op, want.n_devices, want.payload_bytes)


def test_bus_bandwidth_follows_the_conventions():
    n, mesh = 4, _line_mesh(4)
    for fn, factor in ((collectives.allreduce_bandwidth, 2 * (n - 1) / n),
                       (collectives.allgather_bandwidth, (n - 1) / n),
                       (collectives.reducescatter_bandwidth, (n - 1) / n),
                       (collectives.alltoall_bandwidth, (n - 1) / n),
                       (collectives.ppermute_ring_bandwidth, 1.0)):
        r = fn(mesh, "model", 1, 1)
        assert r.busbw_gbps == pytest.approx(
            factor * r.payload_bytes / r.seconds / 1e9)


def test_collective_suite_on_an_axis_of_one_is_not_applicable():
    mesh = make_mesh(8, MeshPlan(data=8, model=1), device="cpu")
    assert collectives.run_collective_suite(mesh, axis="model") == []


@pytest.mark.parametrize("bidir", [False, True])
def test_hand_ring_report_rounds_its_rows_as_the_reference(bidir):
    """Called directly on a CPU mesh (the suite leaves it out there), the
    hand-ring probe runs the kernels' plain versions: its payload is rows of
    512 columns rounded up to n (2n for the bidirectional ring)."""
    n = 4
    r = collectives.ring_allreduce_bandwidth(_line_mesh(n), "model",
                                             mbytes=0, iters=1, bidir=bidir)
    assert r.op == ("ring_allreduce_bidir" if bidir else "ring_allreduce")
    assert r.payload_bytes == (2 * n if bidir else n) * 512 * 4
    assert r.busbw_gbps > 0 and r.seconds > 0
