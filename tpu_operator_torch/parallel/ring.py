"""Hand-scheduled ring collectives (K3–K6) in CUDA, over virtual ranks of
one card or over ranks on distinct cards.

The port of ``tpu_operator/parallel/ring.py``: an all-gather, a
reduce-scatter, an all-reduce and a bidirectional all-reduce whose schedule
is pinned hop by hop, so that their rate can be set against the library
collectives'. Each wrapper takes one tensor per rank, in ring order (rank r
sends to rank r + 1), and returns one per rank. f32 only.

For CUDA tensors the ranks lie in one of two placements (see
``parallel/mesh.py``), and ``csrc/ring.cu``, which says how a rank reaches
its neighbours and what bounds it, runs the same code in both:

- virtual ranks, every rank on one card: one cooperative launch holds them
  all (or, with ``per_rank``, a launch a rank on streams of their own, which
  is how one card runs the cross-card protocol);
- ranks on distinct cards, one a card, each card peer-reachable from its
  neighbours: one launch a card on its current stream, the neighbours'
  memory reached by peer pointers. Nothing is staged through the host or
  another card.

Every launch of a ring waits for counters that only grow (epochs), so
launches on different cards need no zeroing between them (``RingLaunch``).
For CPU tensors the wrapper runs the plain version: a hop-by-hop simulation
of the TPU kernels' schedule (the same slots, the same chunk arithmetic, the
same ``received + local`` adds) that also keeps a ledger of the credits. On
the card all four follow another schedule, in which the sender writes
straight into its neighbour's memory, piece by piece: into the neighbour's
output, and for K4's partial sums, which its one-chunk output has no room
for, into a staging area that is written once per launch.
``launches_direct_plain`` runs that schedule for consecutive launches of one
ring, with one coroutine per (rank, block) and a stream per rank under a
seeded scheduler, blocking on the kernels' own counters and epochs;
``all_gather_direct_plain``, ``reduce_scatter_direct_plain``,
``all_reduce_direct_plain`` and ``all_reduce_bidir_direct_plain`` are its
single launches. All of them give the same bits, and the same bits as the
TPU kernels.

The ``*_sharded`` functions split a whole array over a mesh axis and
assemble the result as the reference's ``shard_map`` in/out specs do, so the
tests compare like with like.
"""

from __future__ import annotations

import collections
import ctypes
import math
import random

import torch

from tpu_operator_torch import _native
from tpu_operator_torch.parallel.mesh import Mesh

THREADS = 256          # threads per block of the kernel (kThreads)
SIG_WORDS = 16         # signal words per block (kSigWords)
STATUS_WORD = 15       # a non-zero status means a wait timed out (kStatus)
TIMEOUT_NS = 5_000_000_000
_STALLS = {1: "entry barrier", 2: "arrival"}
# K3, K4 and K5 move each block's slice in pieces of this many bytes, K6 in
# pieces of BIDIR_PIECE_BYTES, each chosen by chip_smoke.py's sweep (PERF.md)
PIECE_BYTES = 16 << 10
BIDIR_PIECE_BYTES = 32 << 10


class CreditError(RuntimeError):
    """A slot was written before its credit, or a credit was never used."""


class RingStall(RuntimeError):
    """A rank of a ring kernel waited past its timeout."""


class ProtocolError(RuntimeError):
    """A schedule deadlocked: every block waits for an arrival that no
    block will send."""


class _Ledger:
    """Credits granted and writes made, per rank and receive slot."""

    def __init__(self, n: int):
        self.granted = [[0, 0] for _ in range(n)]
        self.written = [[0, 0] for _ in range(n)]

    def grant(self, rank: int, slot: int) -> None:
        self.granted[rank][slot] += 1

    def write(self, rank: int, slot: int) -> None:
        if self.written[rank][slot] >= self.granted[rank][slot]:
            raise CreditError(f"slot {slot} of rank {rank} written before "
                              "its credit")
        self.written[rank][slot] += 1

    def open(self, hops: int) -> None:
        """Both slots of every rank start free: the first two hops'
        targets are granted at entry."""
        for rank in range(len(self.granted)):
            if hops >= 1:
                self.grant(rank, 1)
            if hops >= 2:
                self.grant(rank, 0)

    def close(self) -> None:
        if self.granted != self.written:
            raise CreditError(f"credits granted {self.granted} but used "
                              f"{self.written}")


class _Slots:
    """Every rank's two receive slots, with the credit ledger."""

    def __init__(self, like: list[torch.Tensor], ledger: _Ledger):
        self.bufs = [[torch.empty_like(x) for _ in range(2)] for x in like]
        self.ledger = ledger

    def store(self, rank: int, slot: int, payload: torch.Tensor) -> None:
        self.ledger.write(rank, slot)
        self.bufs[rank][slot].copy_(payload)

    def __getitem__(self, key):
        rank, slot = key
        return self.bufs[rank][slot]


# -- plain versions ---------------------------------------------------------

def all_gather_plain(xs, ledger: _Ledger | None = None):
    """K3's schedule: n - 1 hops; after hop t rank d holds the chunk that
    started at rank d - t - 1 and forwards it at hop t + 1."""
    n = len(xs)
    rows = xs[0].shape[0]
    ledger = ledger or _Ledger(n)
    outs = [x.new_empty((n * rows, *x.shape[1:])) for x in xs]
    for d, x in enumerate(xs):
        outs[d][d * rows:(d + 1) * rows] = x
    slots = _Slots(xs, ledger)
    hops = n - 1
    ledger.open(hops)
    for t in range(hops):
        s = (t + 1) % 2
        for d in range(n):
            src = (d - t) % n
            slots.store((d + 1) % n, s, outs[d][src * rows:(src + 1) * rows])
        for d in range(n):
            src = (d - t - 1) % n
            outs[d][src * rows:(src + 1) * rows] = slots[d, s]
            if t + 2 < hops:
                ledger.grant(d, s)
    ledger.close()
    return outs


def reduce_scatter_plain(xs, ledger: _Ledger | None = None):
    """K4's schedule: at hop t rank d sends the running sum of chunk
    d - t - 1 (its own copy at hop 0; what arrived at hop t - 1 plus its
    copy after that); after n - 1 hops what arrives plus its own copy is
    chunk d, fully summed. The input is never written."""
    n = len(xs)
    chunk = xs[0].shape[0] // n
    if n == 1:
        return [xs[0].clone()]
    ledger = ledger or _Ledger(n)

    def local(d, c):
        return xs[d][c * chunk:(c + 1) * chunk]

    slots = _Slots([local(d, 0) for d in range(n)], ledger)
    hops = n - 1
    ledger.open(hops)
    for t in range(hops):
        s = (t + 1) % 2
        payloads = [local(d, (d - t - 1) % n) if t == 0
                    else slots[d, t % 2] + local(d, (d - t - 1) % n)
                    for d in range(n)]
        for d in range(n):
            slots.store((d + 1) % n, s, payloads[d])
            if 1 <= t < hops - 1:
                ledger.grant(d, t % 2)
    ledger.close()
    return [slots[d, hops % 2] + local(d, d) for d in range(n)]


def _all_reduce_ring(outs, chunk: int, reverse: bool, ledger: _Ledger):
    """The TPU all-reduce's 2(n - 1) hops over ``outs`` (one tensor per
    rank), in place: rightward with ``ring.py``'s forward chunk arithmetic,
    or leftward with its reverse arithmetic."""
    n = len(outs)
    hops = 2 * (n - 1)

    def rows(c):
        return slice(c * chunk, (c + 1) * chunk)

    def indices(d, t):
        if t < n - 1:       # reduce-scatter hop i
            i = t
            return ((d + i, d + i + 1) if reverse else (d - i, d - i - 1))
        i = t - (n - 1)     # all-gather hop i
        return ((d - 1 + i, d + i) if reverse else (d + 1 - i, d - i))

    slots = _Slots([o[rows(0)] for o in outs], ledger)
    ledger.open(hops)
    for t in range(hops):
        s = (t + 1) % 2
        for d in range(n):
            send_c = indices(d, t)[0] % n
            slots.store((d + (-1 if reverse else 1)) % n, s,
                        outs[d][rows(send_c)])
        for d in range(n):
            recv_c = indices(d, t)[1] % n
            got = slots[d, s]
            if t < n - 1:
                got = got + outs[d][rows(recv_c)]   # received + local
            outs[d][rows(recv_c)] = got
            if t + 2 < hops:
                ledger.grant(d, s)
    ledger.close()


def all_reduce_plain(xs, ledger: _Ledger | None = None):
    """K5's schedule: reduce-scatter then all-gather, 2(n - 1) hops, in
    place in a copy of each input; chunk c finishes on rank c - 1."""
    n = len(xs)
    outs = [x.clone() for x in xs]
    _all_reduce_ring(outs, xs[0].shape[0] // n, False, ledger or _Ledger(n))
    return outs


def all_reduce_bidir_plain(xs, ledgers: tuple[_Ledger, _Ledger] | None = None):
    """K6's schedule: K5's rightward ring over the top half of each tensor
    and its mirror image, leftward, over the bottom half, each with its own
    slots and credits."""
    n = len(xs)
    half = xs[0].shape[0] // 2
    fwd, rev = ledgers or (_Ledger(n), _Ledger(n))
    outs = [x.clone() for x in xs]
    _all_reduce_ring([o[:half] for o in outs], half // n, False, fwd)
    _all_reduce_ring([o[half:] for o in outs], half // n, True, rev)
    return outs


# -- plain versions of the schedules on the card ---------------------------

def pieces(chunk4: int, blocks: int, piece4: int, b: int):
    """Block b's pieces as the kernels cut them: [s, e) in 16-byte
    vectors of a chunk of ``chunk4`` vectors, split over ``blocks`` blocks
    (K6: the blocks of one direction)."""
    lo, hi = chunk4 * b // blocks, chunk4 * (b + 1) // blocks
    return [(s, min(s + piece4, hi)) for s in range(lo, hi, piece4)]


class _Scheduler:
    """Runs coroutines to their end, picking at random (from ``seed``)
    which runnable one takes its next step. A coroutine yields the counter
    and target it waits for before a step, as a block's thread 0 spins on an
    acquire load, or None for a step that waits for nothing; the step itself
    (its reads, writes and signal) runs whole."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)
        self.counters = collections.Counter()

    def signal(self, key) -> None:
        self.counters[key] += 1

    def ready(self, key, target: int) -> bool:
        return self.counters[key] >= target

    def run(self, coroutines) -> None:
        waits = {}
        for co in coroutines:
            waits[co] = next(co, StopIteration)
        waits = {co: w for co, w in waits.items() if w is not StopIteration}
        while waits:
            runnable = [co for co, w in waits.items()
                        if w is None or self.ready(*w)]
            if not runnable:
                raise ProtocolError("deadlock: every block waits, on "
                                    f"{sorted(set(waits.values()))}")
            co = self.rng.choice(runnable)
            w = next(co, StopIteration)
            if w is StopIteration:
                del waits[co]
            else:
                waits[co] = w


def _arrival_base(epoch: int, per_launch: int) -> int:
    """The arrivals a block has counted when launch ``epoch`` of its ring
    starts (the kernels' ``Direct::awaited``): every earlier launch brought
    ``per_launch``, the block's pieces times the arrivals a piece brings.
    The signal words are zeroed once, before launch 0."""
    return epoch * per_launch


def _entry(sched: _Scheduler, n: int, d: int, b: int, epoch: int):
    """The kernels' entry barrier of launch ``epoch``, for block b of rank
    d: one signal to each neighbour's word for this side, then a wait until
    each neighbour has signalled launch ``epoch``, which it does only once
    it ended launch ``epoch - 1``."""
    sched.signal(("from left", (d + 1) % n, b))
    sched.signal(("from right", (d - 1) % n, b))
    yield ("from left", d, b), epoch + 1
    yield ("from right", d, b), epoch + 1


def _launches(runs, outs, blocks: int, seed: int, stagger: int,
              launch_block):
    """Launches of one ring, one after another, on the same outputs
    (``outs``, one flat tensor per rank) and signal counters, each launch
    k on its own inputs ``runs[k]``. Every rank runs on a stream of its
    own: once all its blocks ended launch k - 1, a seeded delay of up to
    ``stagger`` scheduler steps passes, its outputs are read (as a caller
    reads them on the rank's stream, late or early, before the next
    launch), and its launch k starts. ``launch_block(sched, d, b, epoch,
    xs)`` is the coroutine of block b of rank d in one launch, entry
    barrier included. Returns each launch's outputs."""
    n = len(outs)
    sched = _Scheduler(seed)
    got = [[None] * n for _ in runs]

    def stream(d):
        for k in range(len(runs) + 1):
            yield ("done", d), blocks * k
            for _ in range(sched.rng.randrange(stagger + 1)):
                yield None
            if k:
                got[k - 1][d] = outs[d].clone()
            if k < len(runs):
                sched.signal(("launched", d))

    def block(d, b):
        for k, xs in enumerate(runs):
            yield ("launched", d), k + 1
            yield from launch_block(sched, d, b, k, xs)
            sched.signal(("done", d))

    sched.run([stream(d) for d in range(n)]
              + [block(d, b) for d in range(n) for b in range(blocks)])
    return got


def _flat(runs, chunks_of_input: int, piece_bytes: int):
    """Each launch's inputs as flat views, and the elements of a chunk."""
    flat = [[x.reshape(-1) for x in xs] for xs in runs]
    chunk = flat[0][0].numel() // chunks_of_input
    if chunk % 4 or piece_bytes <= 0 or piece_bytes % 16:
        raise ValueError("chunks and pieces are whole 16-byte vectors")
    return flat, chunk


def _direct(runs, gather: bool, blocks: int, piece_bytes: int, seed: int,
            trace: list | None, directions: int = 1, stagger: int = 0):
    """K3's (``gather``), K5's or, with two ``directions``, K6's schedule
    on the card, on flat views of the ranks' tensors, for each launch's
    inputs in ``runs``. K6's blocks [0, blocks/2) run K5's schedule
    rightward over the top half, the others its mirror image leftward over
    the bottom half. ``trace``, if given, receives every access to an
    output piece in the order it ran: ("write", rank, chunk, s, kind) with
    kind "partial" or "final", and ("read", rank, chunk, s); K6's
    bottom-half chunks are numbered n to 2n - 1."""
    n = len(runs[0])
    flat, chunk = _flat(runs, 1 if gather else n * directions, piece_bytes)
    if blocks % directions:
        raise ValueError(f"blocks {blocks} must be even: half per direction")
    chunk4, piece4 = chunk // 4, piece_bytes // 16
    rings = blocks // directions
    x0 = flat[0][0]
    outs = [torch.full((directions * n * chunk,), float("nan"),
                       dtype=x0.dtype, device=x0.device) for _ in range(n)]
    if n == 1:
        return [[xs[0].clone()] for xs in flat]
    log = trace if trace is not None else []
    # a piece brings n - 1 arrivals to a block of K3, 2(n - 1) of K5, K6
    per_piece = n - 1 if gather else 2 * (n - 1)

    def rows(c, s, e):
        return slice(c * chunk + 4 * s, c * chunk + 4 * e)

    def read(rank, c, s, e):
        log.append(("read", rank, c, s))
        return outs[rank][rows(c, s, e)].clone()

    def write(rank, c, s, e, value, kind):
        log.append(("write", rank, c, s, kind))
        outs[rank][rows(c, s, e)] = value

    def launch_block(sched, d, b, epoch, xs):
        leftward, slice_ = divmod(b, rings)
        to = (d - 1 if leftward else d + 1) % n
        # the rank's position along the ring, and the chunk that the ring's
        # chunk label c names (the leftward ring's labels are mirrored)
        pos = -d % n if leftward else d
        label = ((lambda c: n + -c % n) if leftward else (lambda c: c % n))
        arrived = ("arrived", d, b)
        spans = pieces(chunk4, rings, piece4, slice_)
        yield from _entry(sched, n, d, b, epoch)
        awaited = _arrival_base(epoch, len(spans) * per_piece)

        def local(c, s, e):
            return xs[d][rows(c, s, e)]

        def send(c, s, e, value, kind):
            write(to, c, s, e, value, kind)
            sched.signal(("arrived", to, b))

        for s, e in spans:
            if gather:
                yield None
                mine = local(0, s, e)
                write(d, d, s, e, mine, "final")
                send(d, s, e, mine, "final")
                for t in range(1, n - 1):
                    awaited += 1
                    yield arrived, awaited
                    c = (d - t) % n
                    send(c, s, e, read(d, c, s, e), "final")
                awaited += 1
                continue
            yield None
            c = label(pos)
            send(c, s, e, local(c, s, e), "partial")
            for i in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                c = label(pos - i)
                send(c, s, e, read(d, c, s, e) + local(c, s, e), "partial")
            awaited += 1
            yield arrived, awaited
            f = label(pos + 1)
            total = read(d, f, s, e) + local(f, s, e)
            write(d, f, s, e, total, "final")
            send(f, s, e, total, "final")
            for i in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                c = label(pos + 1 - i)
                send(c, s, e, read(d, c, s, e), "final")
            awaited += 1
        yield arrived, awaited

    return _launches(flat, outs, blocks, seed, stagger, launch_block)


def _reduce_scatter_direct(runs, blocks: int, piece_bytes: int, seed: int,
                           trace: list | None, stagger: int = 0):
    """K4's schedule on the card, on flat views of the ranks' tensors, for
    each launch's inputs in ``runs``: the outputs (one chunk per rank).
    ``trace``, if given, receives every access to a staging or output
    piece in the order it ran: ("write", rank, where, s, kind) and
    ("read", rank, where, s), where ``where`` is the staging chunk's index
    t (what hop t delivered) or "out", and kind is "partial" for what the
    left neighbour wrote and "final" for the owner's own write of its
    output."""
    n = len(runs[0])
    flat, chunk = _flat(runs, n, piece_bytes)
    chunk4, piece4 = chunk // 4, piece_bytes // 16
    x0 = flat[0][0]

    def empty(chunks):
        return [torch.full((chunks * chunk,), float("nan"), dtype=x0.dtype,
                           device=x0.device) for _ in range(n)]

    outs, stages = empty(1), empty(max(n - 2, 0))
    if n == 1:
        return [[xs[0].clone()] for xs in flat]
    log = trace if trace is not None else []

    def place(rank, where, s, e):
        if where == "out":
            return outs[rank][4 * s:4 * e]
        return stages[rank][where * chunk + 4 * s:where * chunk + 4 * e]

    def read(rank, where, s, e):
        log.append(("read", rank, where, s))
        return place(rank, where, s, e).clone()

    def write(rank, where, s, e, value, kind):
        log.append(("write", rank, where, s, kind))
        place(rank, where, s, e).copy_(value)

    def launch_block(sched, d, b, epoch, xs):
        to = (d + 1) % n
        arrived = ("arrived", d, b)
        spans = pieces(chunk4, blocks, piece4, b)
        yield from _entry(sched, n, d, b, epoch)
        # a piece brings n - 1 arrivals: n - 2 into staging, one into the
        # output
        awaited = _arrival_base(epoch, len(spans) * (n - 1))

        def local(c, s, e):
            c %= n
            return xs[d][c * chunk + 4 * s:c * chunk + 4 * e]

        def send(t, s, e, value):
            # hop t delivers into staging chunk t; the last hop, n - 2,
            # into the output of the rank that owns the chunk
            write(to, "out" if t == n - 2 else t, s, e, value, "partial")
            sched.signal(("arrived", to, b))

        for s, e in spans:
            yield None
            send(0, s, e, local(d - 1, s, e))
            for t in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                send(t, s, e, read(d, t - 1, s, e) + local(d - t - 1, s, e))
            awaited += 1
            yield arrived, awaited
            write(d, "out", s, e, read(d, "out", s, e) + local(d, s, e),
                  "final")

    return _launches(flat, outs, blocks, seed, stagger, launch_block)


def _check_rows(xs, step: int) -> None:
    if xs[0].shape[0] % step:
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by "
                         + (f"2*{len(xs)}" if step == 2 * len(xs)
                            else f"{len(xs)}"))


def launches_direct_plain(kind: str, runs, *, blocks: int | None = None,
                          piece_bytes: int | None = None, seed: int = 0,
                          stagger: int = 0, trace: list | None = None):
    """Consecutive launches of one ring of the card's kernel ``kind``
    (``"all_gather"``, ``"reduce_scatter"``, ``"all_reduce"`` or
    ``"all_reduce_bidir"``), launch k on the ranks' inputs ``runs[k]``:
    the epoch protocol of ``csrc/ring.cu`` with one coroutine per (rank,
    block) and one stream per rank, each rank entering each launch after a
    seeded delay of up to ``stagger`` steps. Returns each launch's outputs,
    shaped as the wrapper's. ``blocks`` defaults to one (two for K6), and
    ``piece_bytes`` to the kernels' own."""
    directions = 2 if kind == "all_reduce_bidir" else 1
    blocks = blocks or directions
    if piece_bytes is None:
        piece_bytes = BIDIR_PIECE_BYTES if directions == 2 else PIECE_BYTES
    xs = runs[0]
    n, rows, tail = len(xs), xs[0].shape[0], xs[0].shape[1:]
    if kind == "all_gather":
        got = _direct(runs, True, blocks, piece_bytes, seed, trace,
                      stagger=stagger)
        return [[o.view(n * rows, *tail) for o in outs] for outs in got]
    _check_rows(xs, directions * n)
    if kind == "reduce_scatter":
        got = _reduce_scatter_direct(runs, blocks, piece_bytes, seed, trace,
                                     stagger)
        return [[o.view(rows // n, *tail) for o in outs] for outs in got]
    got = _direct(runs, False, blocks, piece_bytes, seed, trace, directions,
                  stagger)
    return [[o.view(xs[0].shape) for o in outs] for outs in got]


def all_gather_direct_plain(xs, *, blocks: int = 1,
                            piece_bytes: int = PIECE_BYTES, seed: int = 0,
                            trace: list | None = None):
    """K3's schedule on the card: per block and piece, hop 0 writes my
    input into my output and my right neighbour's; hop t forwards the
    chunk that arrived at hop t - 1 into the right neighbour's output.
    Every rank's (block, piece) steps interleave as ``seed`` picks."""
    return launches_direct_plain("all_gather", [xs], blocks=blocks,
                                 piece_bytes=piece_bytes, seed=seed,
                                 trace=trace)[0]


def reduce_scatter_direct_plain(xs, *, blocks: int = 1,
                                piece_bytes: int = PIECE_BYTES,
                                seed: int = 0, trace: list | None = None):
    """K4's schedule on the card: per block and piece, hop 0 writes my
    addend of chunk d - 1 into my right neighbour's staging chunk 0; hop t
    adds my addend to what hop t - 1 delivered (received + local) and
    writes the sum into the neighbour's staging chunk t, the last hop into
    its output; then my own addend of chunk d is added to my output in
    place. Every staging and output piece is written once by the left
    neighbour before its owner reads it."""
    return launches_direct_plain("reduce_scatter", [xs], blocks=blocks,
                                 piece_bytes=piece_bytes, seed=seed,
                                 trace=trace)[0]


def all_reduce_direct_plain(xs, *, blocks: int = 1,
                            piece_bytes: int = PIECE_BYTES, seed: int = 0,
                            trace: list | None = None):
    """K5's schedule on the card: the reduce-scatter passes partial sums
    from each rank's output into its right neighbour's, adding the local
    addend on the way; the all-gather's first hop adds the last addend and
    every later hop forwards the sum over the partial it replaces."""
    return launches_direct_plain("all_reduce", [xs], blocks=blocks,
                                 piece_bytes=piece_bytes, seed=seed,
                                 trace=trace)[0]


def all_reduce_bidir_direct_plain(xs, *, blocks: int = 2,
                                  piece_bytes: int = BIDIR_PIECE_BYTES,
                                  seed: int = 0, trace: list | None = None):
    """K6's schedule on the card: K5's schedule on the card over the top
    half of each tensor, rightward, on the first half of the (even)
    ``blocks``, and its mirror image leftward over the bottom half on the
    rest, each block writing into its neighbour's output."""
    return launches_direct_plain("all_reduce_bidir", [xs], blocks=blocks,
                                 piece_bytes=piece_bytes, seed=seed,
                                 trace=trace)[0]


# -- kernel wrappers --------------------------------------------------------

def _check_ranks(xs, step_rows: int, what: str) -> torch.device:
    """The first rank's device, once the ranks' tensors pass what every
    version needs: one shape and dtype, rows that the chunks divide, and
    one device for all ranks or, on the card, one card a rank with peer
    access between neighbours. Raises on anything else."""
    if not xs:
        raise ValueError("no ranks")
    n = len(xs)
    shape, dtype = xs[0].shape, xs[0].dtype
    if xs[0].dim() < 1:
        raise ValueError("each rank needs a tensor of at least one axis")
    if any(x.shape != shape or x.dtype != dtype for x in xs):
        raise ValueError(f"{what}: the ranks' tensors differ in shape or "
                         "dtype")
    devices = [x.device for x in xs]
    if len(set(devices)) > 1:
        if {d.type for d in devices} != {"cuda"}:
            raise ValueError(f"{what}: the ranks' tensors lie on several "
                             f"devices {sorted(set(map(str, devices)))}, "
                             "not all of them cards")
        cards = [d.index for d in devices]
        if len(set(cards)) != n:
            raise ValueError(f"{what}: ranks on several cards must be one "
                             f"a card, got cards {cards}")
        no_peer = [(a, b) for i, a in enumerate(cards)
                   for b in {cards[(i + 1) % n], cards[(i - 1) % n]}
                   if not torch.cuda.can_device_access_peer(a, b)]
        if no_peer:
            raise ValueError(
                f"{what}: no peer access between cards "
                + ", ".join(f"{a}->{b}" for a, b in no_peer)
                + ": each rank writes into its neighbours' memory")
    if shape[0] % step_rows:
        raise ValueError(f"rows {shape[0]} not divisible by "
                         + (f"2*{n}" if step_rows == 2 * n else f"{n}"))
    dev = devices[0]
    if dev.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"{what}: the ring kernels take float32, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def pointer_rows(ins, outs, stages, sigs, ranks) -> list[list[int]]:
    """``csrc/ring.cu``'s RankPtrs for each rank in ``ranks``, from the
    addresses of every rank's input, output, staging area and signal words
    (in ring order): the rank's own, its right neighbour's output, staging
    area and signal words, and its left neighbour's output and signal
    words. Across cards the neighbours' are peer pointers."""
    n = len(ins)
    return [[ins[d], outs[d], outs[(d + 1) % n], outs[(d - 1) % n],
             stages[d], stages[(d + 1) % n], sigs[d], sigs[(d + 1) % n],
             sigs[(d - 1) % n]] for d in ranks]


_resident: dict[tuple, int] = {}
_peers: set[tuple] = set()


def resident_blocks(device: torch.device, kind: str) -> int:
    """Blocks of the ring kernel behind wrapper ``kind`` that fit on the
    card at once."""
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    key = (index, RingLaunch._KERNELS[kind][2])
    if key not in _resident:
        out = ctypes.c_int(0)
        with torch.cuda.device(index):
            _native.check(_native.library().ring_resident_blocks(
                key[1], ctypes.byref(out)), "ring_resident_blocks")
        _resident[key] = out.value
    return _resident[key]


def enable_peers(cards: list[int]) -> None:
    """Peer access from each card of a ring to its neighbours, enabled
    once per ring of cards (``ring_enable_peers``): PyTorch enables it only
    inside its own copies, and a kernel that dereferences a peer pointer
    without it faults."""
    key = tuple(cards)
    if key not in _peers:
        arr = (ctypes.c_int * len(cards))(*cards)
        _native.check(_native.library().ring_enable_peers(arr, len(cards)),
                      f"ring_enable_peers({list(cards)})")
        _peers.add(key)


class RingLaunch:
    """One ring kernel over fixed ranks, set up once: the outputs, each
    rank's staging area (K4: n - 2 chunks for the partial sums on their
    way) and signal words, and a pointer table for each launch on that
    launch's card.

    Placement. Ranks on distinct cards take one launch a card, on the
    card's current stream, their neighbours' memory reached by peer
    pointers. Virtual ranks of one card take one cooperative launch that
    holds them all; with ``per_rank`` they take one launch each instead, on
    streams of their own, so that one card runs the protocol that ranks
    across cards run. Every launch must then be resident at once: by
    default each takes its share of the card's resident blocks.

    The signal words are zeroed here, once. :meth:`launch` queues every
    launch, with its epoch (the launches made before it), before it
    returns, and does not synchronise; :meth:`raise_on_stall` synchronises
    and raises if a rank timed out, after which the ring is spent. The
    wrappers do both for every call; a timing loop can repeat
    :meth:`launch` alone, and a caller may write new inputs in place
    between launches on the inputs' streams.

    ``piece_bytes`` (for the tests and ``chip_smoke.py``'s sweep) overrides
    :data:`PIECE_BYTES` (K6: :data:`BIDIR_PIECE_BYTES`)."""

    # wrapper → (C entry point, directions, kernel id of
    # ring_resident_blocks)
    _KERNELS = {
        "all_gather": ("ring_all_gather_f32", 1, 0),
        "reduce_scatter": ("ring_reduce_scatter_f32", 1, 1),
        "all_reduce": ("ring_all_reduce_f32", 1, 2),
        "all_reduce_bidir": ("ring_all_reduce_bidir_f32", 2, 3),
    }

    def __init__(self, kind: str, xs, blocks: int | None = None,
                 piece_bytes: int | None = None, per_rank: bool = False):
        self.name, directions, _ = self._KERNELS[kind]
        n = len(xs)
        devices = [x.device for x in xs]
        across = len(set(devices)) > 1
        stage_chunks = 0
        if kind == "all_gather":
            self.outs = [x.new_empty((n * x.shape[0], *x.shape[1:]))
                         for x in xs]
            chunk_elems = xs[0].numel()
        elif kind == "reduce_scatter":
            self.outs = [x.new_empty((x.shape[0] // n, *x.shape[1:]))
                         for x in xs]
            chunk_elems = xs[0].numel() // n
            stage_chunks = max(n - 2, 0)
        else:
            self.outs = [torch.empty_like(x) for x in xs]
            chunk_elems = xs[0].numel() // (n * directions)
        if chunk_elems % 4:
            raise ValueError(f"the ring kernels move 16-byte vectors: a chunk "
                             f"of {chunk_elems} floats is not a multiple of 4")
        if any(t.data_ptr() % 16 or not t.is_contiguous()
               for t in (*xs, *self.outs)):
            raise ValueError("the ring kernels take contiguous 16-byte "
                             "aligned tensors")
        self.chunk4 = chunk_elems // 4
        if piece_bytes is None:
            piece_bytes = (BIDIR_PIECE_BYTES if kind == "all_reduce_bidir"
                           else PIECE_BYTES)
        if piece_bytes <= 0 or piece_bytes % 16:
            raise ValueError(f"a piece of {piece_bytes} bytes is not a whole "
                             "number of 16-byte vectors")
        piece4 = min(piece_bytes // 16, max(1, self.chunk4))
        if blocks is not None and blocks % directions:
            raise ValueError(f"blocks {blocks} must be even: half per "
                             "direction")
        # (first rank, ranks, device, stream or None for the current one)
        if across:
            self.launches = [(d, 1, dev, None) for d, dev in enumerate(devices)]
        elif per_rank:
            self.launches = [(d, 1, devices[0],
                              torch.cuda.Stream(devices[0]))
                             for d in range(n)]
        else:
            self.launches = [(0, n, devices[0], None)]
        if blocks is None:
            # every launch resident at once: the ranks that share a card
            # share its blocks
            sharing = 1 if across else n
            fit = min(resident_blocks(dev, kind) for dev in set(devices))
            per_dir = max(1, min(fit // (sharing * directions),
                                 math.ceil(self.chunk4 / THREADS)))
            blocks = per_dir * directions
        self.n, self.blocks, self.devices = n, blocks, devices
        self.epoch = 0
        # no piece is longer than a block's slice
        self.piece4 = min(piece4, math.ceil(
            self.chunk4 * directions / blocks))
        stages = [torch.empty(stage_chunks * chunk_elems, dtype=torch.float32,
                              device=dev) for dev in devices]
        # separate allocations, zeroed once: the epochs count on from 0
        self.sigs = [torch.zeros(blocks * SIG_WORDS, dtype=torch.int32,
                                 device=dev) for dev in devices]
        self.status = [s.view(blocks, SIG_WORDS)[:, STATUS_WORD]
                       for s in self.sigs]
        rows = pointer_rows(*([t.data_ptr() for t in ts] for ts in (
            xs, self.outs, stages, self.sigs)), range(n))
        # from pinned memory, so the copy does not wait for the card
        self.tables = [torch.tensor(rows[first:first + count],
                                    dtype=torch.int64).pin_memory().to(
                                        dev, non_blocking=True)
                       for first, count, dev, _ in self.launches]
        self.held = (list(xs), stages)   # what the tables point at
        if across:
            enable_peers([dev.index for dev in devices])
            # nothing orders one card's zeroing and table copy with a
            # neighbour card's kernel but this
            for dev in set(devices):
                torch.cuda.synchronize(dev)

    def launch(self) -> None:
        """Queue this ring's launches: every card's (or stream's) launch
        before the host waits on any."""
        lib = _native.library()
        for (first, count, dev, stream), table in zip(self.launches,
                                                      self.tables):
            with torch.cuda.device(dev):
                current = torch.cuda.current_stream()
                if stream is not None:
                    # after what the caller queued (inputs, earlier reads)
                    stream.wait_stream(current)
                err = getattr(lib, self.name)(
                    table.data_ptr(), self.n, first, count, self.chunk4,
                    self.blocks, self.piece4, TIMEOUT_NS, self.epoch,
                    (stream or current).cuda_stream)
            _native.check(err, f"{self.name} (n={self.n}, ranks {first}.."
                               f"{first + count - 1}, blocks={self.blocks}, "
                               f"epoch {self.epoch})")
        for _, _, dev, stream in self.launches:
            if stream is not None:
                torch.cuda.current_stream(dev).wait_stream(stream)
        self.epoch += 1

    def raise_on_stall(self) -> None:
        """Waits for every card and raises if any rank timed out: the
        status words are gathered on the first rank's card (after each
        card's launches) and read in one copy."""
        first = self.devices[0]
        status = torch.stack([s.to(first, non_blocking=True)
                              for s in self.status]).cpu()
        if bool(status.any()):
            rank, block = (int(i) for i in status.nonzero()[0])
            what = _STALLS.get(int(status[rank, block]), "?")
            raise RingStall(f"{self.name}: rank {rank} block {block} timed "
                            f"out waiting for its {what}")


def _run(kind: str, xs, blocks: int | None, per_rank: bool):
    ring = RingLaunch(kind, xs, blocks, per_rank=per_rank)
    ring.launch()
    ring.raise_on_stall()
    return ring.outs


def ring_all_gather(xs, *, blocks: int | None = None, per_rank: bool = False):
    """All-gather (K3): every rank gets the ranks' tensors concatenated on
    axis 0, in ring order. ``per_rank``: virtual ranks of one card take a
    launch each (:class:`RingLaunch`)."""
    dev = _check_ranks(xs, 1, "ring_all_gather")
    if dev.type == "cpu":
        return all_gather_plain(xs)
    outs = _run("all_gather", xs, blocks, per_rank)
    ring_all_gather.launches += 1
    return outs


def ring_reduce_scatter(xs, *, blocks: int | None = None,
                        per_rank: bool = False):
    """Reduce-scatter (K4): rank d gets chunk d (axis 0) of the sum, the
    ``lax.psum_scatter(tiled=True)`` convention. Axis 0 must be divisible
    by the number of ranks."""
    dev = _check_ranks(xs, len(xs), "ring_reduce_scatter")
    if dev.type == "cpu":
        return reduce_scatter_plain(xs)
    outs = _run("reduce_scatter", xs, blocks, per_rank)
    ring_reduce_scatter.launches += 1
    return outs


def ring_all_reduce(xs, *, blocks: int | None = None, per_rank: bool = False):
    """All-reduce (K5): every rank gets the sum. Axis 0 must be divisible
    by the number of ranks."""
    dev = _check_ranks(xs, len(xs), "ring_all_reduce")
    if dev.type == "cpu":
        return all_reduce_plain(xs)
    outs = _run("all_reduce", xs, blocks, per_rank)
    ring_all_reduce.launches += 1
    return outs


def ring_all_reduce_bidir(xs, *, blocks: int | None = None,
                          per_rank: bool = False):
    """Bidirectional all-reduce (K6): the top half circulates rightward and
    the bottom half leftward, at once. Axis 0 must be divisible by twice
    the number of ranks; ``blocks``, if given, must be even."""
    dev = _check_ranks(xs, 2 * len(xs), "ring_all_reduce_bidir")
    if dev.type == "cpu":
        return all_reduce_bidir_plain(xs)
    outs = _run("all_reduce_bidir", xs, blocks, per_rank)
    ring_all_reduce_bidir.launches += 1
    return outs


ring_all_gather.launches = 0
ring_reduce_scatter.launches = 0
ring_all_reduce.launches = 0
ring_all_reduce_bidir.launches = 0


# -- over a mesh axis, as the reference's shard_map wrappers -----------------

def _shards(arr: torch.Tensor, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Rank r's block of ``arr`` (axis 0 split over ``axis``, replicated
    over the others), on its device: ``in_specs=P(axis, None)``."""
    n = mesh.shape[axis]
    if arr.shape[0] % n:
        raise ValueError(f"rows {arr.shape[0]} not divisible by {n}")
    parts = arr.chunk(n)
    return [parts[mesh.coords(r)[axis]].to(mesh.device(r), copy=True)
            for r in range(mesh.size)]


def _over_groups(fn, arr, mesh: Mesh, axis: str):
    """Run ``fn`` over each ring (group) of ``axis``; the first group's
    outputs, in ring order, each on its rank's device."""
    xs = _shards(arr, mesh, axis)
    return [fn([xs[r] for r in group]) for group in mesh.groups(axis)][0]


def ring_all_gather_sharded(arr, mesh: Mesh, axis: str):
    """``arr`` sharded on axis 0 over ``axis`` → the gathered whole
    (``out_specs=P(None, None)``)."""
    return _over_groups(ring_all_gather, arr, mesh, axis)[0].to(arr.device)


def ring_reduce_scatter_sharded(arr, mesh: Mesh, axis: str):
    """Each rank's shard is its addend; the sum comes back sharded over
    ``axis``, chunk d on rank d (``out_specs=P(axis, None)``)."""
    return torch.cat([o.to(arr.device) for o in
                      _over_groups(ring_reduce_scatter, arr, mesh, axis)])


def ring_all_reduce_sharded(arr, mesh: Mesh, axis: str):
    """Each rank's shard is its addend; the replicated sum."""
    return _over_groups(ring_all_reduce, arr, mesh, axis)[0].to(arr.device)


def ring_all_reduce_bidir_sharded(arr, mesh: Mesh, axis: str):
    """As :func:`ring_all_reduce_sharded`, through the bidirectional ring."""
    return _over_groups(ring_all_reduce_bidir, arr, mesh,
                        axis)[0].to(arr.device)
