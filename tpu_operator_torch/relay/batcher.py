"""Dynamic batcher: coalesce compatible small requests under a latency cap.

The Podracer-style fan-in (PAPERS.md): many small actor requests against a
fixed chip fleet amortize per-dispatch overhead (relay RTT, program launch)
when coalesced. Requests are compatible when they share a ``BatchKey`` —
(op, shape, dtype) — because only those can be stacked into one batched
dispatch without recompilation. A batch flushes when it reaches
``max_batch`` or when its oldest member has waited ``window_s`` (the
latency budget); requests at or above ``bypass_bytes`` skip coalescing
entirely — they are already big enough to saturate the link, and holding
them to collect peers would only add latency.

Clock-driven, no background thread: the owner calls ``flush_due(now)``
from its pump loop, which keeps every test and the e2e harness hermetic on
virtual time.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

# bounded occupancy window: last_sizes once grew one entry per batch for
# the life of the process; a ring buffer keeps the
# recent-occupancy gauge cheap and the memory flat
OCCUPANCY_WINDOW = 256


@dataclass(frozen=True)
class BatchKey:
    op: str
    shape: tuple
    dtype: str


@dataclass
class RelayRequest:
    """One admitted relay dispatch. ``id`` is client-assigned and globally
    unique — the exactly-once replay key after a torn stream.

    ``payload`` is the request's input buffer: a ``BufferLease`` (or any
    releasable buffer) when ``donate=True`` — the caller relinquishes it
    and the service returns it to the arena exactly once, at terminal
    completion — or a plain bytes-like object on the copying baseline.
    ``copied_bytes`` records staging copies paid at batch formation (0 on
    the donated path), which is what the simulated wire charges for.
    """
    id: int
    tenant: str
    op: str
    shape: tuple
    dtype: str
    size_bytes: int = 0
    enqueued_at: float = 0.0
    payload: object = None
    donate: bool = False
    copied_bytes: int = 0
    # resolved QoS class; "" on the classless path. Stamped at
    # admission so the class travels with the request through formation,
    # preemption, spillover, and tracing without re-resolution
    qos_class: str = ""
    # owning session; "" for one-shot requests. Travels with
    # the request so the router's kill-resubmit ledger can restore the
    # session's KV cache on a survivor before the step re-routes
    session_id: str = ""

    def __post_init__(self):
        # a caller that omits size_bytes but carries a payload must not
        # silently skip bypass-lane and admission accounting — derive the
        # size from the buffer itself
        if self.size_bytes <= 0 and self.payload is not None:
            self.size_bytes = self.payload_nbytes()

    def key(self) -> BatchKey:
        return BatchKey(self.op, tuple(self.shape), self.dtype)

    def payload_nbytes(self) -> int:
        if self.payload is None:
            return 0
        size = getattr(self.payload, "size", None)
        if size is not None:
            return int(size)
        return len(self.payload)

    def payload_view(self) -> memoryview | None:
        """The payload as a zero-copy ``memoryview`` segment."""
        if self.payload is None:
            return None
        view = getattr(self.payload, "view", None)
        if callable(view):
            return view()          # BufferLease window
        return memoryview(self.payload)

    def release_payload(self):
        """Return a donated buffer to its arena. The owner (the relay
        service) calls this exactly once per request, at terminal
        completion; an extra call surfaces as BufferLifecycleError from
        the lease refcount — never as silent corruption."""
        if self.donate and self.payload is not None:
            release = getattr(self.payload, "release", None)
            if release is not None:
                release()


class FormedBatch(list):
    """A formed batch: the member requests plus the scatter-gather segment
    list assembled over their payload buffers at formation time.
    Subclasses ``list`` so every existing dispatch path (service, tests,
    transports) keeps treating a batch as its member list."""

    __slots__ = ("segments", "copied_bytes")

    def __init__(self, requests, segments=(), copied_bytes: int = 0):
        super().__init__(requests)
        self.segments = list(segments)
        self.copied_bytes = int(copied_bytes)


def form_batch(requests: list) -> FormedBatch:
    """Assemble one dispatchable batch as memoryview segments — the
    scatter-gather formation path. Donated buffers contribute zero-copy
    windows; non-donated payloads pay a staging copy (the baseline the
    arena exists to remove), accounted per member in ``copied_bytes`` so
    the simulated wire can charge for it."""
    segments, copied = [], 0
    for req in requests:
        view = req.payload_view()
        if view is None:
            continue
        if req.donate:
            req.copied_bytes = 0
            segments.append(view)
        else:
            staged = bytes(view)  # gpucheck: ignore[payload-copy] -- sanctioned staging copy: the non-donated baseline path the e2e harness A/Bs against
            req.copied_bytes = len(staged)
            copied += len(staged)
            segments.append(memoryview(staged))
    return FormedBatch(requests, segments, copied)


@dataclass
class _Pending:
    requests: list = field(default_factory=list)
    oldest: float = 0.0


class DynamicBatcher:
    """Groups requests; ``dispatch(list[RelayRequest])`` does the work.

    ``dispatch`` is called synchronously from submit()/flush paths with
    the full batch; the bypass lane calls it with a single-element list.
    """

    def __init__(self, dispatch, *, max_batch: int = 8,
                 window_s: float = 0.005, bypass_bytes: int = 1 << 20,
                 clock=time.monotonic,
                 occupancy_window: int = OCCUPANCY_WINDOW):
        self._dispatch = dispatch
        self.max_batch = max(1, int(max_batch))
        self.window_s = float(window_s)
        self.bypass_bytes = int(bypass_bytes)
        self._clock = clock
        self._pending: dict[BatchKey, _Pending] = {}
        # occupancy accounting (batch_occupancy histogram upstream)
        self.batches_total = 0
        self.batched_requests_total = 0
        self.bypass_total = 0
        self.last_sizes: deque[int] = deque(
            maxlen=max(1, int(occupancy_window)))

    def pending_count(self) -> int:
        return sum(len(p.requests) for p in self._pending.values())

    def submit(self, req: RelayRequest, now: float | None = None):
        """Queue (or bypass-dispatch) one admitted request. A caller-set
        ``enqueued_at`` (the admission timestamp) is preserved so the
        latency window is measured from admission, not batcher entry.
        ``now`` threads the owner's single submit-path clock read."""
        if now is None:
            now = self._clock()
        if req.enqueued_at <= 0.0:
            req.enqueued_at = now
        if req.size_bytes >= self.bypass_bytes:
            self.bypass_total += 1
            self._flush([req])
            return
        key = req.key()
        p = self._pending.get(key)
        if p is None:
            p = self._pending[key] = _Pending(oldest=req.enqueued_at)
        elif not p.requests:
            p.oldest = req.enqueued_at
        else:
            p.oldest = min(p.oldest, req.enqueued_at)
        p.requests.append(req)
        if len(p.requests) >= self.max_batch:
            self._flush_key(key)

    def flush_due(self, now: float | None = None):
        """Flush every batch whose oldest request exceeded the latency
        budget — the pump-loop entry point."""
        now = self._clock() if now is None else now
        for key in [k for k, p in self._pending.items()
                    if p.requests and (now - p.oldest) >= self.window_s]:
            self._flush_key(key)

    def flush_all(self):
        for key in [k for k, p in self._pending.items() if p.requests]:
            self._flush_key(key)

    def _flush_key(self, key: BatchKey):
        p = self._pending.pop(key)
        self._flush(p.requests)

    def _flush(self, batch: list):
        self.batches_total += 1
        self.batched_requests_total += len(batch)
        self.last_sizes.append(len(batch))
        # scatter-gather formation: the dispatch callback receives the
        # member list plus the segment views — no concatenation here
        self._dispatch(form_batch(batch))
