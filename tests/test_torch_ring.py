"""The port's ring collectives (K3–K6) against the reference's Pallas ring
kernels, run in interpret mode on the virtual CPU mesh.

On the CPU each wrapper runs its plain version, a hop-by-hop simulation of
the kernel's schedule; it must give the reference's bits exactly, since both
make the same f32 adds in the same order. The CUDA kernels are held to the
plain versions on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpu_operator.parallel import ring as jax_ring
from tpu_operator_torch.parallel import ring
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh
from tpu_operator_torch.parallel.numerics import reduction_tolerance

KERNELS = {
    "all_gather": (ring.ring_all_gather_sharded,
                   jax_ring.ring_all_gather_sharded),
    "reduce_scatter": (ring.ring_reduce_scatter_sharded,
                       jax_ring.ring_reduce_scatter_sharded),
    "all_reduce": (ring.ring_all_reduce_sharded,
                   jax_ring.ring_all_reduce_sharded),
    "all_reduce_bidir": (ring.ring_all_reduce_bidir_sharded,
                         jax_ring.ring_all_reduce_bidir_sharded),
}
CASES = [(name, n) for name in KERNELS
         for n in ((2, 6, 8) if name == "all_reduce_bidir" else (2, 4, 8))]


def _input(n, seed=0):
    # the dry run's shape: each rank's shard (2n, 128) splits into n
    # chunks, and into 2n for the bidirectional ring
    return np.random.default_rng(seed).standard_normal((2 * n * n, 128),
                                                       dtype=np.float32)


def _ring_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("ring",))


@pytest.mark.parametrize("name,n", CASES)
def test_plain_ring_equals_the_reference_bit_for_bit(name, n):
    port, ref = KERNELS[name]
    a = _input(n, seed=n)
    want = np.asarray(ref(a, JaxMesh(np.array(jax.devices()[:n]), ("ring",)),
                          "ring", interpret=True))
    got = port(torch.from_numpy(a), _ring_mesh(n), "ring").numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,n", CASES)
def test_plain_ring_matches_the_library_collective(name, n):
    port, _ = KERNELS[name]
    a = torch.from_numpy(_input(n, seed=100 + n))
    shards = a.chunk(n)
    got = port(a, _ring_mesh(n), "ring")
    if name == "all_gather":
        assert torch.equal(got, torch.cat(shards))
        return
    want = torch.stack(shards).sum(0)
    tol = reduction_tolerance(torch.float32, n)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_every_rank_holds_the_same_replicated_result():
    n = 4
    xs = list(torch.from_numpy(_input(n, 1)).chunk(n))
    for fn in (ring.ring_all_gather, ring.ring_all_reduce,
               ring.ring_all_reduce_bidir):
        outs = fn(xs)
        assert all(torch.equal(o, outs[0]) for o in outs)
    scattered = ring.ring_reduce_scatter(xs)
    assert [tuple(o.shape) for o in scattered] == [(2, 128)] * n


def test_one_rank_returns_its_input():
    x = torch.from_numpy(_input(1, 2))
    for fn in (ring.ring_all_gather, ring.ring_reduce_scatter,
               ring.ring_all_reduce, ring.ring_all_reduce_bidir):
        (out,) = fn([x])
        assert torch.equal(out, x)


def test_sharded_over_one_axis_of_a_two_axis_mesh():
    """On a (data, model) mesh the ring runs along the model axis, the
    array replicated over data, as the reference's ``P("model", None)``:
    each model group gives what a ring of its size gives alone."""
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    a = torch.from_numpy(_input(2, 3))
    for port, _ in KERNELS.values():
        assert torch.equal(port(a, mesh, "model"),
                           port(a, _ring_mesh(2), "ring"))


@pytest.mark.parametrize("fn,rows,n", [
    (ring.ring_all_reduce, 6, 4), (ring.ring_reduce_scatter, 6, 4),
    (ring.ring_all_reduce_bidir, 6, 4), (ring.ring_all_reduce_bidir, 12, 4)])
def test_shape_guards_say_divisible(fn, rows, n):
    with pytest.raises(ValueError, match="divisible"):
        fn([torch.ones((rows, 128)) for _ in range(n)])


def test_sharded_shape_guard_says_divisible():
    with pytest.raises(ValueError, match="divisible"):
        ring.ring_all_reduce_sharded(torch.ones((6, 128)), _ring_mesh(4),
                                     "ring")


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_credit_ledger_balances(n):
    """Every slot write had its credit and every credit was used: one per
    hop and rank (n - 1 hops, or 2(n - 1) for the all-reduces)."""
    xs = list(torch.from_numpy(_input(n, 4)).chunk(n))
    for fn, hops in ((ring.all_gather_plain, n - 1),
                     (ring.reduce_scatter_plain, n - 1),
                     (ring.all_reduce_plain, 2 * (n - 1))):
        ledger = ring._Ledger(n)
        fn(xs, ledger)
        if fn is ring.reduce_scatter_plain and n == 1:
            hops = 0
        assert ledger.granted == ledger.written
        assert [sum(g) for g in ledger.granted] == [hops] * n
    ledgers = (ring._Ledger(n), ring._Ledger(n))
    ring.all_reduce_bidir_plain(xs, ledgers)
    for ledger in ledgers:
        assert ledger.granted == ledger.written
        assert [sum(g) for g in ledger.granted] == [2 * (n - 1)] * n


def test_ledger_refuses_a_write_without_credit_and_an_unused_credit():
    ledger = ring._Ledger(2)
    with pytest.raises(ring.CreditError, match="before its credit"):
        ledger.write(1, 0)
    ledger.grant(0, 1)
    with pytest.raises(ring.CreditError, match="granted"):
        ledger.close()
    ledger.write(0, 1)
    ledger.close()


def test_wrappers_refuse_ranks_on_several_devices():
    xs = [torch.ones((8, 128)), torch.ones((8, 128), device="meta")]
    for fn in (ring.ring_all_gather, ring.ring_reduce_scatter,
               ring.ring_all_reduce, ring.ring_all_reduce_bidir):
        with pytest.raises(ValueError, match="several devices"):
            fn(xs)


def test_wrappers_refuse_ranks_of_different_shapes():
    with pytest.raises(ValueError, match="shape"):
        ring.ring_all_reduce([torch.ones((8, 128)), torch.ones((8, 64))])


def test_cpu_wrappers_leave_the_launch_counters_at_zero():
    xs = list(torch.from_numpy(_input(2, 5)).chunk(2))
    for fn in (ring.ring_all_gather, ring.ring_reduce_scatter,
               ring.ring_all_reduce, ring.ring_all_reduce_bidir):
        fn(xs)
        assert fn.launches == 0
