"""The ring kernels' (K3–K6) cross-launch protocol, on the CPU: launches that
follow each other with no zeroing in between, one a rank, as ranks on
distinct cards (or ``per_rank`` launches on one card) run them.

``ring.launches_direct_plain`` runs consecutive launches of one ring with one
coroutine per (rank, block) and one stream per rank under a seeded
scheduler, blocking on the kernels' own counters: each launch waits for
targets offset by its epoch, and the entry barrier counts one signal from
each neighbour per launch. Each rank enters each launch after a seeded
delay, and every launch has inputs of its own, so that a launch that read
its predecessor's data would show. The results must equal the slot
schedule's plain version (which equals the reference's kernels) bit for
bit, and two planted faults must be caught. The pointer table, the
placement of ranks on cards and the wrappers' checks of a placement are
held here too; the kernels themselves are held on the card
(``tests/test_torch_cuda.py``).
"""

import types

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpu_operator.parallel import ring as jax_ring
from tpu_operator_torch.parallel import mesh as mesh_mod
from tpu_operator_torch.parallel import ring

KINDS = ("all_gather", "reduce_scatter", "all_reduce", "all_reduce_bidir")
SLOTS = {"all_gather": ring.all_gather_plain,
         "reduce_scatter": ring.reduce_scatter_plain,
         "all_reduce": ring.all_reduce_plain,
         "all_reduce_bidir": ring.all_reduce_bidir_plain}
LAUNCHES = 3


def _runs(n, kind, launches=LAUNCHES, seed=0, rows_per_chunk=2, cols=8):
    """``launches`` sets of inputs, each rank's (rows, cols) f32, each set
    drawn anew."""
    rows = rows_per_chunk * n * (2 if kind == "all_reduce_bidir" else 1)
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.standard_normal((rows, cols),
                                                  dtype=np.float32))
             for _ in range(n)] for _ in range(launches)]


def _blocks(kind, per_direction=2):
    return 2 * per_direction if kind == "all_reduce_bidir" else per_direction


def _launch(kind, runs, seed, stagger=40):
    return ring.launches_direct_plain(kind, runs, blocks=_blocks(kind),
                                      piece_bytes=16, seed=seed,
                                      stagger=stagger)


def _exact(kind, runs, got) -> bool:
    return all(torch.equal(g, w)
               for xs, outs in zip(runs, got)
               for g, w in zip(outs, SLOTS[kind](xs)))


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_consecutive_launches_keep_the_slot_schedule_bits(kind, n):
    """Three launches of one ring, each on inputs of its own, the ranks
    entering each launch at seeded, staggered times: every launch gives
    the slot schedule's bits on its own inputs."""
    for seed in range(3):
        runs = _runs(n, kind, seed=seed)
        got = _launch(kind, runs, seed)
        assert len(got) == LAUNCHES
        assert _exact(kind, runs, got), (kind, n, seed)


@pytest.mark.parametrize("kind", KINDS)
def test_one_launch_is_the_single_launch_schedule(kind):
    """A ring's first launch is the single-launch schedule the wrappers'
    ``*_direct_plain`` run, whatever the stagger."""
    runs = _runs(4, kind, launches=1, seed=5)
    single = {"all_gather": ring.all_gather_direct_plain,
              "reduce_scatter": ring.reduce_scatter_direct_plain,
              "all_reduce": ring.all_reduce_direct_plain,
              "all_reduce_bidir": ring.all_reduce_bidir_direct_plain}[kind]
    want = single(runs[0], blocks=_blocks(kind), piece_bytes=16, seed=5)
    for got, exp in zip(_launch(kind, runs, 5)[0], want):
        assert torch.equal(got, exp)


def _caught(kind, seeds=8) -> int:
    """Runs at n = 2 and n = 4 under the planted fault that give wrong
    bits, or deadlock. Each fault shows at one of the two: at n = 2 K3
    forwards nothing it received, so it never reads early, and at n = 4 the
    one piece K4's first hop writes early is a staging piece that its
    neighbour has consumed (its output it reaches only through the other
    ranks' barriers); at n = 2 that first hop writes the output."""
    caught = 0
    for n in (2, 4):
        for seed in range(seeds):
            runs = _runs(n, kind, seed=100 + seed)
            try:
                caught += not _exact(kind, runs, _launch(kind, runs, seed))
            except ring.ProtocolError:
                caught += 1
    return caught


@pytest.mark.parametrize("kind", KINDS)
def test_a_rank_that_skips_the_entry_barrier_is_caught(kind, monkeypatch):
    """Rank 1 signals its neighbours but does not wait for them from its
    second launch on: it writes the next launch's data into its right
    neighbour's memory while that neighbour may still read the last
    one's."""
    real = ring._entry

    def skipping(sched, n, d, b, epoch):
        if d == 1 and epoch > 0:
            sched.signal(("from left", (d + 1) % n, b))
            sched.signal(("from right", (d - 1) % n, b))
        else:
            yield from real(sched, n, d, b, epoch)

    monkeypatch.setattr(ring, "_entry", skipping)
    assert _caught(kind) > 0


@pytest.mark.parametrize("kind", KINDS)
def test_an_epoch_target_one_short_is_caught(kind, monkeypatch):
    """Every launch after the first waits for one arrival fewer than its
    predecessors brought, so its first wait passes at once: a piece is
    read before it arrived, holding the last launch's data."""
    monkeypatch.setattr(ring, "_arrival_base",
                        lambda epoch, per_launch:
                        epoch * per_launch - (epoch > 0))
    assert _caught(kind) > 0


def test_the_faults_are_not_caught_without_them():
    """The same runs as the planted-fault tests, with no fault: none is
    caught, so what those tests catch is the fault."""
    assert all(_caught(kind) == 0 for kind in KINDS)


# -- the pointer table --------------------------------------------------------

COLUMNS = ("in", "out", "right_out", "left_out", "stage", "right_stage",
           "sig", "right_sig", "left_sig")


@pytest.mark.parametrize("n", [2, 4, 8])
def test_pointer_rows_name_each_ranks_neighbours(n):
    """Row d names rank d's own input, output, staging area and signal
    words, its right neighbour's (d + 1) output, staging area and signal
    words, which K3–K5 and K6's rightward blocks send to, and its left
    neighbour's (d - 1) output and signal words, which K6's leftward blocks
    send to."""
    base = {"in": 1000, "out": 2000, "stage": 3000, "sig": 4000}
    addr = {k: [v + d for d in range(n)] for k, v in base.items()}
    rows = ring.pointer_rows(addr["in"], addr["out"], addr["stage"],
                             addr["sig"], range(n))
    assert len(rows) == n
    for d, row in enumerate(rows):
        got = dict(zip(COLUMNS, row))
        right, left = (d + 1) % n, (d - 1) % n
        assert got == {"in": 1000 + d, "out": 2000 + d,
                       "right_out": 2000 + right, "left_out": 2000 + left,
                       "stage": 3000 + d, "right_stage": 3000 + right,
                       "sig": 4000 + d, "right_sig": 4000 + right,
                       "left_sig": 4000 + left}
    # a launch of one rank gets that rank's row alone
    assert ring.pointer_rows(addr["in"], addr["out"], addr["stage"],
                             addr["sig"], [n - 1]) == [rows[n - 1]]
    # both directions close the ring: rightward every rank is sent to
    # once, leftward too
    assert sorted(r[2] for r in rows) == sorted(r[3] for r in rows) \
        == addr["out"]


# -- the placement of ranks -----------------------------------------------------

def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("cards,n,want,fabric", [
    (8, 4, [f"cuda:{i}" for i in range(4)], "peer"),
    (4, 4, [f"cuda:{i}" for i in range(4)], "peer"),
    (2, 2, ["cuda:0", "cuda:1"], "peer"),
    (1, 4, ["cuda"] * 4, "loopback"),
    (2, 4, ["cuda"] * 4, "loopback"),
    (8, 1, ["cuda"], "loopback"),
])
def test_ranks_go_on_distinct_cards_when_there_are_enough(monkeypatch, cards,
                                                          n, want, fabric):
    _cards(monkeypatch, cards)
    devices = mesh_mod.rank_devices(n, "cuda")
    assert [str(d) for d in devices] == want
    assert mesh_mod.fabric(devices) == fabric
    mesh = mesh_mod.make_mesh(n, mesh_mod.MeshPlan(1, n), devices=devices)
    assert [str(mesh.device(r)) for r in range(n)] == want


def test_ranks_off_the_card_stay_virtual(monkeypatch):
    _cards(monkeypatch, 8)
    devices = mesh_mod.rank_devices(4, "cpu")
    assert devices == [torch.device("cpu")] * 4
    assert mesh_mod.fabric(devices) == "loopback"


def _fake(device, rows=8):
    """What ``_check_ranks`` reads of a tensor: shape, dtype, dim, device."""
    return types.SimpleNamespace(shape=torch.Size((rows, 128)),
                                 dtype=torch.float32, dim=lambda: 2,
                                 device=torch.device(device))


def test_wrappers_take_one_rank_a_card_with_peer_access(monkeypatch):
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    xs = [_fake(f"cuda:{i}") for i in range(4)]
    assert ring._check_ranks(xs, 4, "ring_all_reduce") == xs[0].device


def test_wrappers_name_the_cards_without_peer_access(monkeypatch):
    """Card 1 cannot reach card 2: the ring 0 → 1 → 2 → 3 needs it both
    ways, and the error names each missing direction."""
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: {a, b} != {1, 2})
    xs = [_fake(f"cuda:{i}") for i in range(4)]
    with pytest.raises(ValueError, match="no peer access between cards "
                                                 r"(1->2, 2->1|2->1, 1->2)"):
        ring._check_ranks(xs, 4, "ring_all_reduce")


def test_wrappers_refuse_two_ranks_on_a_card_beside_another_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: True)
    xs = [_fake("cuda:0"), _fake("cuda:0"), _fake("cuda:1")]
    with pytest.raises(ValueError, match="one a card"):
        ring._check_ranks(xs, 3, "ring_all_gather")


# -- parity with the reference's interpret-mode rings ---------------------------

REFERENCE = {"all_gather": jax_ring.ring_all_gather_sharded,
             "reduce_scatter": jax_ring.ring_reduce_scatter_sharded,
             "all_reduce": jax_ring.ring_all_reduce_sharded,
             "all_reduce_bidir": jax_ring.ring_all_reduce_bidir_sharded}


def _whole(kind, outs):
    """The reference's ``out_specs``: rank 0's result, or the scattered
    chunks in rank order."""
    return torch.cat(outs) if kind == "reduce_scatter" else outs[0]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_epoch_schedule_equals_the_reference_bit_for_bit(kind, n):
    """Two launches of one ring under the epoch protocol, staggered, on two
    of the dry run's (2n², 128) arrays, each against the reference's Pallas
    kernel in interpret mode on a 1-axis mesh of n CPU devices."""
    rng = np.random.default_rng(20 + n)
    arrays = [rng.standard_normal((2 * n * n, 128), dtype=np.float32)
              for _ in range(2)]
    mesh = JaxMesh(np.array(jax.devices()[:n]), ("ring",))
    runs = [list(torch.from_numpy(a).chunk(n)) for a in arrays]
    got = ring.launches_direct_plain(kind, runs, blocks=_blocks(kind),
                                     piece_bytes=1024, seed=n, stagger=20)
    for a, outs in zip(arrays, got):
        want = np.array(REFERENCE[kind](a, mesh, "ring", interpret=True))
        assert torch.equal(torch.from_numpy(_whole(kind, outs).numpy()),
                           torch.from_numpy(want))
