"""Hand-scheduled ring collectives (K3–K6) over virtual ranks, in CUDA.

The port of ``tpu_operator/parallel/ring.py``: an all-gather, a
reduce-scatter, an all-reduce and a bidirectional all-reduce whose schedule
is pinned hop by hop, so that their rate can be set against the library
collectives'. Each wrapper takes one tensor per rank, in ring order (rank r
sends to rank r + 1), and returns one per rank.

For CUDA tensors, all ranks lie on one card as virtual ranks (see
``parallel/mesh.py``) and one cooperative launch of ``csrc/ring.cu`` holds
them all; the source says how a rank reaches its neighbours and what bounds
it. f32 only. For CPU tensors the wrapper runs the plain version: a hop-by-hop
simulation of the TPU kernels' schedule (the same slots, the same chunk
arithmetic, the same ``received + local`` adds) that also keeps a ledger of
the credits. On the card all four follow another schedule, in which the
sender writes straight into its neighbour's memory, piece by piece: into the
neighbour's output, and for K4's partial sums, which its one-chunk output
has no room for, into a staging area that is written once per launch.
``all_gather_direct_plain``, ``reduce_scatter_direct_plain``,
``all_reduce_direct_plain`` and ``all_reduce_bidir_direct_plain`` run that
schedule with one coroutine per (rank, block) under a seeded scheduler,
blocking on the kernel's own counters. All of them give the same bits, and
the same bits as the TPU kernels.

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
    """Runs one coroutine per (rank, block) to its end, picking at random
    (from ``seed``) which runnable one takes its next step. A coroutine
    yields the counter and target it waits for before a step, as a block's
    thread 0 spins on an acquire load, or None for a step that waits for
    nothing; the step itself (its reads, writes and signal) runs whole."""

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


def _direct(xs, gather: bool, blocks: int, piece_bytes: int, seed: int,
            trace: list | None, directions: int = 1):
    """K3's (``gather``), K5's or, with two ``directions``, K6's schedule
    on the card, on flat views of the ranks' tensors. K6's blocks
    [0, blocks/2) run K5's schedule rightward over the top half, the others
    its mirror image leftward over the bottom half. ``trace``, if given,
    receives every access to an output piece in the order it ran:
    ("write", rank, chunk, s, kind) with kind "partial" or "final", and
    ("read", rank, chunk, s); K6's bottom-half chunks are numbered n to
    2n - 1."""
    n = len(xs)
    flat = [x.reshape(-1) for x in xs]
    chunk = flat[0].numel() // (1 if gather else n * directions)
    if chunk % 4 or piece_bytes <= 0 or piece_bytes % 16:
        raise ValueError("chunks and pieces are whole 16-byte vectors")
    if blocks % directions:
        raise ValueError(f"blocks {blocks} must be even: half per direction")
    chunk4, piece4 = chunk // 4, piece_bytes // 16
    rings = blocks // directions
    outs = [torch.full((directions * n * chunk,), float("nan"),
                       dtype=x.dtype, device=x.device) for x in flat]
    if n == 1:
        outs[0].copy_(flat[0])
        return outs
    sched = _Scheduler(seed)
    log = trace if trace is not None else []

    def rows(c, s, e):
        return slice(c * chunk + 4 * s, c * chunk + 4 * e)

    def read(rank, c, s, e):
        log.append(("read", rank, c, s))
        return outs[rank][rows(c, s, e)].clone()

    def write(rank, c, s, e, value, kind):
        log.append(("write", rank, c, s, kind))
        outs[rank][rows(c, s, e)] = value

    def local(d, c, s, e):
        return flat[d][rows(c, s, e)]

    def block(d, b):
        leftward, slice_ = divmod(b, rings)
        to = (d - 1 if leftward else d + 1) % n
        # the rank's position along the ring, and the chunk that the ring's
        # chunk label c names (the leftward ring's labels are mirrored)
        pos = -d % n if leftward else d
        label = ((lambda c: n + -c % n) if leftward else (lambda c: c % n))
        arrived = ("arrived", d, b)
        sched.signal(("barrier", (d + 1) % n, b))
        sched.signal(("barrier", (d - 1) % n, b))
        yield ("barrier", d, b), 2
        awaited = 0

        def send(c, s, e, value, kind):
            write(to, c, s, e, value, kind)
            sched.signal(("arrived", to, b))

        for s, e in pieces(chunk4, rings, piece4, slice_):
            if gather:
                yield None
                mine = local(d, 0, s, e)
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
            send(c, s, e, local(d, c, s, e), "partial")
            for i in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                c = label(pos - i)
                send(c, s, e, read(d, c, s, e) + local(d, c, s, e),
                     "partial")
            awaited += 1
            yield arrived, awaited
            f = label(pos + 1)
            total = read(d, f, s, e) + local(d, f, s, e)
            write(d, f, s, e, total, "final")
            send(f, s, e, total, "final")
            for i in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                c = label(pos + 1 - i)
                send(c, s, e, read(d, c, s, e), "final")
            awaited += 1
        yield arrived, awaited

    sched.run([block(d, b) for d in range(n) for b in range(blocks)])
    return outs


def _reduce_scatter_direct(xs, blocks: int, piece_bytes: int, seed: int,
                           trace: list | None):
    """K4's schedule on the card, on flat views of the ranks' tensors: the
    outputs (one chunk per rank). ``trace``, if given, receives every
    access to a staging or output piece in the order it ran:
    ("write", rank, where, s, kind) and ("read", rank, where, s), where
    ``where`` is the staging chunk's index t (what hop t delivered) or
    "out", and kind is "partial" for what the left neighbour wrote and
    "final" for the owner's own write of its output."""
    n = len(xs)
    flat = [x.reshape(-1) for x in xs]
    chunk = flat[0].numel() // n
    if chunk % 4 or piece_bytes <= 0 or piece_bytes % 16:
        raise ValueError("chunks and pieces are whole 16-byte vectors")
    chunk4, piece4 = chunk // 4, piece_bytes // 16

    def empty(chunks):
        return [torch.full((chunks * chunk,), float("nan"), dtype=x.dtype,
                           device=x.device) for x in flat]

    outs, stages = empty(1), empty(max(n - 2, 0))
    if n == 1:
        outs[0].copy_(flat[0])
        return outs
    sched = _Scheduler(seed)
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

    def local(d, c, s, e):
        c %= n
        return flat[d][c * chunk + 4 * s:c * chunk + 4 * e]

    def block(d, b):
        to = (d + 1) % n
        arrived = ("arrived", d, b)
        sched.signal(("barrier", (d + 1) % n, b))
        sched.signal(("barrier", (d - 1) % n, b))
        yield ("barrier", d, b), 2
        awaited = 0

        def send(t, s, e, value):
            # hop t delivers into staging chunk t; the last hop, n - 2,
            # into the output of the rank that owns the chunk
            write(to, "out" if t == n - 2 else t, s, e, value, "partial")
            sched.signal(("arrived", to, b))

        for s, e in pieces(chunk4, blocks, piece4, b):
            yield None
            send(0, s, e, local(d, d - 1, s, e))
            for t in range(1, n - 1):
                awaited += 1
                yield arrived, awaited
                send(t, s, e,
                     read(d, t - 1, s, e) + local(d, d - t - 1, s, e))
            awaited += 1
            yield arrived, awaited
            write(d, "out", s, e,
                  read(d, "out", s, e) + local(d, d, s, e), "final")

    sched.run([block(d, b) for d in range(n) for b in range(blocks)])
    return outs


def all_gather_direct_plain(xs, *, blocks: int = 1,
                            piece_bytes: int = PIECE_BYTES, seed: int = 0,
                            trace: list | None = None):
    """K3's schedule on the card: per block and piece, hop 0 writes my
    input into my output and my right neighbour's; hop t forwards the
    chunk that arrived at hop t - 1 into the right neighbour's output.
    Every rank's (block, piece) steps interleave as ``seed`` picks."""
    n, rows = len(xs), xs[0].shape[0]
    outs = _direct(xs, True, blocks, piece_bytes, seed, trace)
    return [o.view(n * rows, *xs[0].shape[1:]) for o in outs]


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
    n = len(xs)
    if xs[0].shape[0] % n:
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by {n}")
    outs = _reduce_scatter_direct(xs, blocks, piece_bytes, seed, trace)
    return [o.view(xs[0].shape[0] // n, *xs[0].shape[1:]) for o in outs]


def all_reduce_direct_plain(xs, *, blocks: int = 1,
                            piece_bytes: int = PIECE_BYTES, seed: int = 0,
                            trace: list | None = None):
    """K5's schedule on the card: the reduce-scatter passes partial sums
    from each rank's output into its right neighbour's, adding the local
    addend on the way; the all-gather's first hop adds the last addend and
    every later hop forwards the sum over the partial it replaces."""
    if xs[0].shape[0] % len(xs):
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by {len(xs)}")
    outs = _direct(xs, False, blocks, piece_bytes, seed, trace)
    return [o.view(xs[0].shape) for o in outs]


def all_reduce_bidir_direct_plain(xs, *, blocks: int = 2,
                                  piece_bytes: int = BIDIR_PIECE_BYTES,
                                  seed: int = 0, trace: list | None = None):
    """K6's schedule on the card: K5's schedule on the card over the top
    half of each tensor, rightward, on the first half of the (even)
    ``blocks``, and its mirror image leftward over the bottom half on the
    rest, each block writing into its neighbour's output."""
    if xs[0].shape[0] % (2 * len(xs)):
        raise ValueError(f"rows {xs[0].shape[0]} not divisible by "
                         f"2*{len(xs)}")
    outs = _direct(xs, False, blocks, piece_bytes, seed, trace, 2)
    return [o.view(xs[0].shape) for o in outs]


# -- kernel wrappers --------------------------------------------------------

def _check_ranks(xs, step_rows: int, what: str) -> torch.device:
    """The device all ranks' tensors lie on; raises on what no version
    takes."""
    if not xs:
        raise ValueError("no ranks")
    n = len(xs)
    shape, dtype = xs[0].shape, xs[0].dtype
    if xs[0].dim() < 1:
        raise ValueError("each rank needs a tensor of at least one axis")
    if any(x.shape != shape or x.dtype != dtype for x in xs):
        raise ValueError(f"{what}: the ranks' tensors differ in shape or "
                         "dtype")
    devices = {x.device for x in xs}
    if len(devices) != 1:
        raise ValueError(f"{what}: the ranks' tensors lie on several devices "
                         f"{sorted(map(str, devices))}; the kernel holds "
                         "virtual ranks on one card")
    if shape[0] % step_rows:
        raise ValueError(f"rows {shape[0]} not divisible by "
                         + (f"2*{n}" if step_rows == 2 * n else f"{n}"))
    dev = devices.pop()
    if dev.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"{what}: the ring kernels take float32, got {dtype}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


_resident: dict[tuple, int] = {}


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


class RingLaunch:
    """One ring kernel over fixed ranks, set up once: the outputs, each
    rank's staging area (K4: n - 2 chunks for the partial sums on their
    way) and signal words, and the pointer table on the card.

    :meth:`launch` zeroes the signal words and launches the kernel, both on
    the current stream, and does not synchronise; :meth:`raise_on_stall`
    synchronises and raises if a rank timed out. The wrappers do both for
    every call; a timing loop can repeat :meth:`launch` alone.

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
                 piece_bytes: int | None = None):
        self.name, directions, _ = self._KERNELS[kind]
        n = len(xs)
        dev = xs[0].device
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
        if blocks is None:
            fit = resident_blocks(dev, kind)
            per_dir = max(1, min(fit // (n * directions),
                                 math.ceil(self.chunk4 / THREADS)))
            blocks = per_dir * directions
        self.n, self.blocks, self.device = n, blocks, dev
        # no piece is longer than a block's slice
        self.piece4 = min(piece4, math.ceil(
            self.chunk4 * directions / blocks))
        stages = [torch.empty(stage_chunks * chunk_elems, dtype=torch.float32,
                              device=dev) for _ in range(n)]
        # separate allocations, as the ranks' would be on separate cards
        self.sigs = [torch.empty(blocks * SIG_WORDS, dtype=torch.int32,
                                 device=dev) for _ in range(n)]
        self.status = [s.view(blocks, SIG_WORDS)[:, STATUS_WORD]
                       for s in self.sigs]
        # csrc/ring.cu's RankPtrs
        rows = [[xs[d].data_ptr(), self.outs[d].data_ptr(),
                 self.outs[(d + 1) % n].data_ptr(),
                 self.outs[(d - 1) % n].data_ptr(),
                 stages[d].data_ptr(), stages[(d + 1) % n].data_ptr(),
                 self.sigs[d].data_ptr(),
                 self.sigs[(d + 1) % n].data_ptr(),
                 self.sigs[(d - 1) % n].data_ptr()] for d in range(n)]
        # from pinned memory, so the copy does not wait for the card
        self.table = torch.tensor(rows, dtype=torch.int64).pin_memory().to(
            dev, non_blocking=True)
        self.held = (list(xs), stages)   # what the table points at

    def launch(self) -> None:
        torch._foreach_zero_(self.sigs)
        with torch.cuda.device(self.device):
            err = getattr(_native.library(), self.name)(
                self.table.data_ptr(), self.n, self.chunk4, self.blocks,
                self.piece4, TIMEOUT_NS,
                torch.cuda.current_stream().cuda_stream)
        _native.check(err, f"{self.name} (n={self.n}, blocks={self.blocks})")

    def raise_on_stall(self) -> None:
        status = torch.stack(self.status).cpu()   # waits for the launches
        if bool(status.any()):
            rank, block = (int(i) for i in status.nonzero()[0])
            what = _STALLS.get(int(status[rank, block]), "?")
            raise RingStall(f"{self.name}: rank {rank} block {block} timed "
                            f"out waiting for its {what}")


def _run(kind: str, xs, blocks: int | None):
    ring = RingLaunch(kind, xs, blocks)
    ring.launch()
    ring.raise_on_stall()
    return ring.outs


def ring_all_gather(xs, *, blocks: int | None = None):
    """All-gather (K3): every rank gets the ranks' tensors concatenated on
    axis 0, in ring order."""
    dev = _check_ranks(xs, 1, "ring_all_gather")
    if dev.type == "cpu":
        return all_gather_plain(xs)
    outs = _run("all_gather", xs, blocks)
    ring_all_gather.launches += 1
    return outs


def ring_reduce_scatter(xs, *, blocks: int | None = None):
    """Reduce-scatter (K4): rank d gets chunk d (axis 0) of the sum, the
    ``lax.psum_scatter(tiled=True)`` convention. Axis 0 must be divisible
    by the number of ranks."""
    dev = _check_ranks(xs, len(xs), "ring_reduce_scatter")
    if dev.type == "cpu":
        return reduce_scatter_plain(xs)
    outs = _run("reduce_scatter", xs, blocks)
    ring_reduce_scatter.launches += 1
    return outs


def ring_all_reduce(xs, *, blocks: int | None = None):
    """All-reduce (K5): every rank gets the sum. Axis 0 must be divisible
    by the number of ranks."""
    dev = _check_ranks(xs, len(xs), "ring_all_reduce")
    if dev.type == "cpu":
        return all_reduce_plain(xs)
    outs = _run("all_reduce", xs, blocks)
    ring_all_reduce.launches += 1
    return outs


def ring_all_reduce_bidir(xs, *, blocks: int | None = None):
    """Bidirectional all-reduce (K6): the top half circulates rightward and
    the bottom half leftward, at once. Axis 0 must be divisible by twice
    the number of ranks; ``blocks``, if given, must be even."""
    dev = _check_ranks(xs, 2 * len(xs), "ring_all_reduce_bidir")
    if dev.type == "cpu":
        return all_reduce_bidir_plain(xs)
    outs = _run("all_reduce_bidir", xs, blocks)
    ring_all_reduce_bidir.launches += 1
    return outs


ring_all_gather.launches = 0
ring_reduce_scatter.launches = 0
ring_all_reduce.launches = 0
ring_all_reduce_bidir.launches = 0


# -- over a mesh axis, as the reference's shard_map wrappers -----------------

def _shards(arr: torch.Tensor, mesh: Mesh, axis: str) -> list[torch.Tensor]:
    """Rank r's block of ``arr`` (axis 0 split over ``axis``, replicated
    over the others): ``in_specs=P(axis, None)``."""
    n = mesh.shape[axis]
    if arr.shape[0] % n:
        raise ValueError(f"rows {arr.shape[0]} not divisible by {n}")
    parts = arr.chunk(n)
    return [parts[mesh.coords(r)[axis]].to(mesh.device(r), copy=True)
            for r in range(mesh.size)]


def _over_groups(fn, arr, mesh: Mesh, axis: str):
    """Run ``fn`` over each ring (group) of ``axis``; the first group's
    outputs, in ring order."""
    xs = _shards(arr, mesh, axis)
    return [fn([xs[r] for r in group]) for group in mesh.groups(axis)][0]


def ring_all_gather_sharded(arr, mesh: Mesh, axis: str):
    """``arr`` sharded on axis 0 over ``axis`` → the gathered whole
    (``out_specs=P(None, None)``)."""
    return _over_groups(ring_all_gather, arr, mesh, axis)[0]


def ring_reduce_scatter_sharded(arr, mesh: Mesh, axis: str):
    """Each rank's shard is its addend; the sum comes back sharded over
    ``axis``, chunk d on rank d (``out_specs=P(axis, None)``)."""
    return torch.cat(_over_groups(ring_reduce_scatter, arr, mesh, axis))


def ring_all_reduce_sharded(arr, mesh: Mesh, axis: str):
    """Each rank's shard is its addend; the replicated sum."""
    return _over_groups(ring_all_reduce, arr, mesh, axis)[0]


def ring_all_reduce_bidir_sharded(arr, mesh: Mesh, axis: str):
    """As :func:`ring_all_reduce_sharded`, through the bidirectional ring."""
    return _over_groups(ring_all_reduce_bidir, arr, mesh, axis)[0]
