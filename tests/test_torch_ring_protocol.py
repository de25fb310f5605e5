"""The schedules of the card's ring kernels (K3–K6), on the CPU.

``ring.all_gather_direct_plain``, ``ring.reduce_scatter_direct_plain``,
``ring.all_reduce_direct_plain`` and ``ring.all_reduce_bidir_direct_plain``
run the kernels' schedule (the sender writes into its neighbour's output
or, K4's partial sums, its staging area, piece by piece, and signals one
"arrived" counter per block; K6 runs K5's rightward over the top half and
its mirror image leftward over the bottom half) with one
coroutine per (rank, block), blocking on the same counters the kernels wait
on; a seeded scheduler picks which runnable block steps next. Whatever the
interleaving, the result must equal the slot schedule's plain version (which
equals the reference's kernels, ``tests/test_torch_ring.py``) bit for bit,
no partial sum may be overwritten before its owner read it, the
all-gather must write every output location exactly once, and the
reduce-scatter every staging and output piece exactly once before its owner
reads it. The kernels are
held to these plain versions on the card (``tests/test_torch_cuda.py``).
"""

import collections

import numpy as np
import pytest
import torch

from tpu_operator_torch.parallel import ring


def _ranks(n, rows, cols, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((rows, cols),
                                                 dtype=np.float32))
            for _ in range(n)]


def _violations(trace):
    """What the trace of one run breaks: a read of a location that holds
    nothing yet, a write over a partial sum its owner has not read, or a
    write over a final value (the location was written twice)."""
    held = {}      # location → "partial" / "final"
    unread = set()
    found = []
    for event in trace:
        op, loc = event[0], event[1:4]
        if op == "read":
            if loc not in held:
                found.append(("read before arrival", loc))
            unread.discard(loc)
            continue
        kind = event[4]
        if loc in unread:
            found.append(("partial overwritten before its owner read it",
                          loc))
        if held.get(loc) == "final":
            found.append(("written twice", loc))
        held[loc] = kind
        if kind == "partial":
            unread.add(loc)
    return found


def _locations(n, chunk4, blocks, piece4):
    return {(r, c, s) for r in range(n) for c in range(n)
            for b in range(blocks)
            for s, _ in ring.pieces(chunk4, blocks, piece4, b)}


def _for_150_schedules(check):
    """Run ``check(case)`` on 150 schedules that hypothesis draws (the test
    skips where hypothesis is not installed)."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st
    schedules = st.fixed_dictionaries({
        "n": st.sampled_from([1, 2, 3, 4, 8]),
        "blocks": st.integers(1, 4),
        "piece4": st.integers(1, 6),
        "rows_per_rank": st.integers(1, 3),
        "cols4": st.integers(1, 5),
        "seed": st.integers(0, 2**32 - 1),
    })
    settings(max_examples=150, deadline=None)(given(case=schedules)(check))()


def test_direct_all_gather_follows_the_protocol():
    _for_150_schedules(_check_all_gather)


def test_direct_reduce_scatter_follows_the_protocol():
    _for_150_schedules(_check_reduce_scatter)


def test_direct_all_reduce_follows_the_protocol():
    _for_150_schedules(_check_all_reduce)


def test_direct_all_reduce_bidir_follows_the_protocol():
    _for_150_schedules(_check_all_reduce_bidir)


def _check_all_gather(case):
    n, blocks, piece4 = case["n"], case["blocks"], case["piece4"]
    rows, cols = case["rows_per_rank"] * n, 4 * case["cols4"]
    xs = _ranks(n, rows, cols, case["seed"] % 1000)
    trace = []
    got = ring.all_gather_direct_plain(xs, blocks=blocks,
                                       piece_bytes=16 * piece4,
                                       seed=case["seed"], trace=trace)
    for g, w in zip(got, ring.all_gather_plain(xs)):
        assert g.shape == w.shape and torch.equal(g, w)
    assert _violations(trace) == []
    writes = collections.Counter(e[1:4] for e in trace if e[0] == "write")
    assert all(e[4] == "final" for e in trace if e[0] == "write")
    if n > 1:
        chunk4 = rows * cols // 4
        assert set(writes) == _locations(n, chunk4, blocks, piece4)
        assert set(writes.values()) == {1}


def _check_reduce_scatter(case):
    n, blocks, piece4 = case["n"], case["blocks"], case["piece4"]
    rows, cols = case["rows_per_rank"] * n, 4 * case["cols4"]
    xs = _ranks(n, rows, cols, case["seed"] % 1000)
    trace = []
    got = ring.reduce_scatter_direct_plain(xs, blocks=blocks,
                                           piece_bytes=16 * piece4,
                                           seed=case["seed"], trace=trace)
    for g, w in zip(got, ring.reduce_scatter_plain(xs)):
        assert g.shape == w.shape and torch.equal(g, w)
    assert _violations(trace) == []
    if n == 1:
        return
    # every staging piece (what hops 0 to n - 3 delivered) and every output
    # piece is written once by the left neighbour, then read once by its
    # owner; the owner alone rewrites its output, once, after that read
    chunk4 = rows // n * cols // 4
    places = {(r, where, s) for r in range(n)
              for where in (*range(n - 2), "out") for b in range(blocks)
              for s, _ in ring.pieces(chunk4, blocks, piece4, b)}
    events = collections.defaultdict(list)
    for e in trace:
        events[e[1:4]].append(e[0] if e[0] == "read" else e[4])
    assert set(events) == places
    for place, seen in events.items():
        assert seen == (["partial", "read", "final"] if place[1] == "out"
                        else ["partial", "read"]), (place, seen)


def _check_all_reduce(case):
    _check_reduce(case, bidir=False)


def _check_all_reduce_bidir(case):
    _check_reduce(case, bidir=True)


def _check_reduce(case, bidir):
    n, blocks, piece4 = case["n"], case["blocks"], case["piece4"]
    directions = 2 if bidir else 1
    rows = case["rows_per_rank"] * n * directions
    cols = 4 * case["cols4"]
    xs = _ranks(n, rows, cols, case["seed"] % 1000)
    trace = []
    fn, plain = ((ring.all_reduce_bidir_direct_plain,
                  ring.all_reduce_bidir_plain) if bidir else
                 (ring.all_reduce_direct_plain, ring.all_reduce_plain))
    got = fn(xs, blocks=directions * blocks, piece_bytes=16 * piece4,
             seed=case["seed"], trace=trace)
    for g, w in zip(got, plain(xs)):
        assert torch.equal(g, w)
    assert _violations(trace) == []
    if n > 1:
        # every location ends with the sum; every chunk but the one a rank
        # completes itself held one partial first (rightward chunk d is
        # completed by rank d - 1; leftward, chunk n + d by rank d + 1)
        chunk4 = rows * cols // (n * directions) // 4
        finals = {e[1:4] for e in trace if e[0] == "write"
                  and e[4] == "final"}
        assert finals == {(r, half * n + c, s)
                          for half in range(directions)
                          for r, c, s in _locations(n, chunk4, blocks,
                                                    piece4)}
        partials = collections.Counter(e[1:4] for e in trace
                                       if e[0] == "write"
                                       and e[4] == "partial")
        assert set(partials.values()) == {1}
        assert set(partials) == {(r, c, s) for r, c, s in finals
                                 if r != c % n}


@pytest.mark.parametrize("fn", [ring.all_gather_direct_plain,
                                ring.reduce_scatter_direct_plain,
                                ring.all_reduce_direct_plain,
                                ring.all_reduce_bidir_direct_plain])
def test_a_wait_one_arrival_short_is_caught(fn, monkeypatch):
    """The checks have teeth: let every block go on one arrival early
    and some interleaving reads a piece before it arrived, or the result
    differs."""
    real = ring._Scheduler.ready
    monkeypatch.setattr(
        ring._Scheduler, "ready",
        lambda self, key, target: real(self, key, target
                                       - (key[0] == "arrived")))
    n = 4
    xs = _ranks(n, 2 * n, 8, 0)
    exact = {ring.all_gather_direct_plain: ring.all_gather_plain,
             ring.reduce_scatter_direct_plain: ring.reduce_scatter_plain,
             ring.all_reduce_direct_plain: ring.all_reduce_plain,
             ring.all_reduce_bidir_direct_plain:
                 ring.all_reduce_bidir_plain}[fn](xs)
    caught = 0
    for seed in range(20):
        trace = []
        got = fn(xs, blocks=2, piece_bytes=32, seed=seed, trace=trace)
        caught += bool(_violations(trace)) or not all(
            torch.equal(g, w) for g, w in zip(got, exact))
    assert caught > 0


def test_a_ring_that_never_signals_is_a_deadlock(monkeypatch):
    monkeypatch.setattr(ring._Scheduler, "signal", lambda self, key: None)
    with pytest.raises(ring.ProtocolError, match="deadlock"):
        ring.all_reduce_direct_plain(_ranks(3, 3, 4, 0))


def test_pieces_cover_each_slice_in_order():
    for chunk4, blocks, piece4 in ((10, 3, 4), (7, 4, 1), (3, 5, 2),
                                   (100, 1, 1000)):
        spans = [p for b in range(blocks)
                 for p in ring.pieces(chunk4, blocks, piece4, b)]
        assert [s for s, _ in spans] == sorted(s for s, _ in spans)
        covered = [i for s, e in spans for i in range(s, e)]
        assert covered == list(range(chunk4))
        assert all(0 < e - s <= piece4 for s, e in spans)


def test_cpu_wrappers_keep_the_slot_schedule():
    """On the CPU the wrappers run the slot schedule's plain versions, and
    the direct schedules agree with them."""
    xs = _ranks(4, 8, 16, 1)
    for wrapper, slots, direct, blocks in (
            (ring.ring_all_gather, ring.all_gather_plain,
             ring.all_gather_direct_plain, 3),
            (ring.ring_reduce_scatter, ring.reduce_scatter_plain,
             ring.reduce_scatter_direct_plain, 3),
            (ring.ring_all_reduce, ring.all_reduce_plain,
             ring.all_reduce_direct_plain, 3),
            (ring.ring_all_reduce_bidir, ring.all_reduce_bidir_plain,
             ring.all_reduce_bidir_direct_plain, 6)):
        got = wrapper(xs)
        for g, s, d in zip(got, slots(xs), direct(xs, blocks=blocks)):
            assert torch.equal(g, s) and torch.equal(g, d)
