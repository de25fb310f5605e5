"""Consistent-hash shard ownership over node names.

The port's copy of ``tpu_operator/controllers/sharding.py`` (device-free;
``GPU_OPERATOR_SHARDS`` takes ``GPU_OPERATOR_SHARDS``'s place).

The fleet-scale data plane splits every per-node hot path (the label walk,
remediation stage derivation) across N worker shards. Ownership must be

- deterministic across processes and restarts (``hashlib``, never Python's
  ``hash()`` — that is randomized per process by PYTHONHASHSEED);
- stable under shard-count changes: a consistent-hash ring with virtual
  nodes remaps only ~K/N keys when a shard joins or leaves, so the
  shard-local memos survive a resize mostly intact instead of a full
  cold restart (the property test in tests/test_fleet_scale.py pins this).

Reference shape: many cheap per-node workers feeding a small number of
aggregators (Podracer-style fan-in, PAPERS.md); the ring itself is the
textbook Karger construction — ``vnodes`` points per shard on a sorted
ring, a key owned by the first point clockwise from its hash.

The relay tier (relay/router.py) reuses the same ring with *named*
members (replica ids instead of dense shard ints), a tunable ``vnodes``
count, and an injectable ``hash_fn`` — the routed key population is
bucketed executable keys, whose cardinality is far below node names, so
the router wants more virtual nodes per member to keep balance within 2x
(tests/test_router.py pins this with a seeded property test). ``add()``
/ ``remove()`` give it live membership: a joining or leaving replica
remaps only ~K/N keys, and ``owners()`` walks the ring clockwise for the
second-choice replica that saturation spillover falls back to.
"""

from __future__ import annotations

import bisect
import hashlib
import os

# 64 virtual nodes per shard keeps the worst shard within a few percent of
# the mean at 10k keys while the ring stays small enough (16*64 points) that
# building it is microseconds
DEFAULT_VNODES = 64

# fleets below this stay on the historical serial walk: the thread-pool
# fan-out costs more than it buys, and keeping the small-cluster path
# byte-identical to the pre-sharding code is a test-pinned guarantee
SERIAL_BELOW = 256

MAX_SHARDS = 16


def _hash64(data: str) -> int:
    """Deterministic 64-bit hash (blake2b is the fastest keyed hash in the
    stdlib at this digest size)."""
    return int.from_bytes(
        hashlib.blake2b(data.encode(), digest_size=8).digest(), "big")


class HashRing:
    """Consistent-hash ring mapping string keys to members.

    Two construction styles share one implementation:

    - ``HashRing(n_shards)`` — the historical fleet-scale form: members
      are the dense ints 0..n-1 and the vnode point labels
      (``shard-{i}/vnode-{v}``) are byte-identical to the pre-members
      code, so sharded-walk ownership never moved when this grew.
    - ``HashRing(members=["relay-0", "relay-1"], vnodes=128)`` — the
      relay-router form: named members, live ``add()``/``remove()``, and
      an ``owners()`` walk for spillover second choices.
    """

    def __init__(self, n_shards: int | None = None,
                 vnodes: int = DEFAULT_VNODES, *, members=None,
                 hash_fn=None):
        if members is None:
            if n_shards is None or n_shards < 1:
                raise ValueError(f"n_shards must be >= 1, got {n_shards}")
            members = list(range(n_shards))
        else:
            members = list(members)
            if not members:
                raise ValueError("members must be non-empty")
            if len(set(members)) != len(members):
                raise ValueError("members must be unique")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.members = members
        self.vnodes = vnodes
        self._hash = hash_fn or _hash64
        self._rebuild()

    @property
    def n_shards(self) -> int:
        return len(self.members)

    def _rebuild(self):
        points: list[tuple[int, object]] = []
        for member in self.members:
            for v in range(self.vnodes):
                points.append((self._hash(f"shard-{member}/vnode-{v}"),
                               member))
        points.sort(key=lambda p: p[0])
        self._points = [p for p, _ in points]
        self._owners = [s for _, s in points]

    # -- live membership (relay tier) ---------------------------------------
    def add(self, member):
        """Join one member; only ~K/N keys remap onto it (property-pinned
        in tests/test_router.py)."""
        if member in self.members:
            raise ValueError(f"member {member!r} already on the ring")
        self.members.append(member)
        self._rebuild()

    def remove(self, member):
        """Leave one member; only its ~K/N keys remap, onto the next
        point clockwise — every other key keeps its owner."""
        if member not in self.members:
            raise ValueError(f"member {member!r} not on the ring")
        if len(self.members) == 1:
            raise ValueError("cannot remove the last ring member")
        self.members.remove(member)
        self._rebuild()

    # -- lookup -------------------------------------------------------------
    def owner(self, key: str):
        """The member owning ``key`` — first ring point clockwise from the
        key's hash (wrapping to the start past the last point)."""
        if len(self.members) == 1:
            return self.members[0]
        i = bisect.bisect_right(self._points, self._hash(key))
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def owners(self, key: str, n: int = 2) -> list:
        """The first ``n`` *distinct* members clockwise from the key's
        hash: ``owners(key)[0] == owner(key)``, ``[1]`` is the spillover
        second choice, and so on — the classic bounded-loads fallback
        order, deterministic per key."""
        n = min(max(1, n), len(self.members))
        if len(self.members) == 1 or n == 1:
            return [self.owner(key)]
        out: list = []
        start = bisect.bisect_right(self._points, self._hash(key))
        for step in range(len(self._points)):
            m = self._owners[(start + step) % len(self._points)]
            if m not in out:
                out.append(m)
                if len(out) == n:
                    break
        return out

    def partition(self, keys) -> list[list]:
        """Split ``keys`` into per-member lists (ordered as
        ``self.members``), preserving input order within each member (the
        walk's in-order determinism depends on it). Accepts any iterable
        of (key, payload) pairs or bare strings."""
        index = {m: i for i, m in enumerate(self.members)}
        out: list[list] = [[] for _ in self.members]
        for item in keys:
            key = item[0] if isinstance(item, tuple) else item
            out[index[self.owner(key)]].append(item)
        return out


def pick_shard_count(n_nodes: int, max_workers: int | None = None,
                     serial_below: int = SERIAL_BELOW) -> int:
    """Shard-count autotuning from fleet size.

    - below ``serial_below`` nodes: 1 (the exact serial path — small
      clusters keep today's byte-identical behavior);
    - large fleets: one shard per ~64 nodes, capped by ``max_workers``
      and MAX_SHARDS. Deliberately NOT capped by cpu core count: the
      per-node hot path is apiserver-round-trip bound (threads overlap
      write latency while the GIL is released), so shards scale like
      HTTP connections, not like compute threads;
    - ``GPU_OPERATOR_SHARDS`` env overrides everything (0/1 forces serial).
    """
    env = os.environ.get("GPU_OPERATOR_SHARDS", "")
    if env:
        try:
            return max(1, min(MAX_SHARDS, int(env)))
        except ValueError:
            pass
    if n_nodes < serial_below:
        return 1
    n = min(MAX_SHARDS, max(2, n_nodes // 64))
    if max_workers is not None:
        n = min(n, max(1, max_workers))
    return max(2, n)
