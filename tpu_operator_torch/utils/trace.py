"""Reconcile tracing: thread-safe span trees + Chrome trace-event export.

The port's copy of ``tpu_operator/utils/trace.py``, which uses no device:
the port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

The reconcile loop is concurrent (a DAG walk over a thread pool), so
time-to-ready is an emergent property of overlapping spans — a per-state
gauge can say *how long* each apply took but not *where the wall clock
went* (gate wait vs apply vs API round trip). This module is the operator's
answer: one root span per reconcile pass, a child span per state, sub-spans
for gate-waits and for every live API request, exported as Chrome
trace-event JSON (``chrome://tracing`` / Perfetto load it directly) via the
``--trace-out`` operator flag and the ``/debug/traces`` metrics endpoint.

Thread-hop design: the active span is a *thread-local stack* shared by all
Tracer instances, and every Span carries a reference to its tracer. Code
that crosses an executor boundary re-activates the parent span in the
worker with ``use(span)``; instrumentation points (kube/cache.py,
kube/incluster.py) call the module-level ``span()`` helper, which attaches
to whatever span is active on the calling thread — and degrades to a no-op
when none is (background watch threads, unit tests without tracing), so an
instrumented call can never create an orphan.

Per-request serving traces (relay/tracing.py) extend the model three ways:

* an injectable ``clock`` so request spans ride the same virtual time as
  the relay's hermetic harnesses (defaults to ``time.monotonic``);
* **span links** — a batch span *links* the N request spans it coalesced
  (OpenTelemetry span-link semantics: causality across trace boundaries
  without pretending fan-in is nesting); ``verify_nesting`` validates
  them — no dangling link ids, no request span claimed by two batches;
* loud ring-buffer eviction: filing a trace into a full ring counts the
  evicted one in ``dropped_total`` and fires ``on_drop`` so the owner can
  export ``*_traces_dropped_total`` instead of losing traces silently.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time
from collections import deque

# thread-local active-span stack, shared across Tracer instances so a span
# started by one component is the parent of spans from any other
_ctx = threading.local()

DEFAULT_KEEP = 32


def _stack() -> list:
    st = getattr(_ctx, "stack", None)
    if st is None:
        st = _ctx.stack = []
    return st


def current() -> "Span | None":
    """The span active on THIS thread, or None."""
    st = _stack()
    return st[-1] if st else None


class Span:
    """One timed operation. start()/finish() may run on different threads;
    the span list is owned (and locked) by its tracer."""

    __slots__ = ("tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end", "attrs", "tid", "links")

    def __init__(self, tracer: "Tracer", trace_id: int, span_id: int,
                 parent_id: int | None, name: str, attrs: dict):
        self.tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = tracer._clock()
        self.end: float | None = None
        self.attrs = attrs
        self.tid = threading.get_ident()
        self.links: list[tuple[int, int]] | None = None

    def set(self, **attrs):
        self.attrs.update(attrs)
        return self

    def add_link(self, trace_id: int, span_id: int):
        """Record a causal link to a span in ANOTHER trace (OpenTelemetry
        span-link semantics). Used by batch spans to claim the request
        spans they coalesced without pretending fan-in is nesting."""
        if self.links is None:
            self.links = []
        self.links.append((trace_id, span_id))
        return self

    def finish(self):
        if self.end is None:
            self.end = self.tracer._clock()

    @property
    def duration_s(self) -> float:
        return (self.end if self.end is not None
                else self.tracer._clock()) - self.start

    # -- context-manager protocol: activate on this thread ---------------
    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:  # defensive: unbalanced exit must not corrupt the stack
            try:
                st.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.attrs.setdefault("error", f"{exc_type.__name__}: {exc}")
        self.finish()
        return False


class _NullSpan:
    """No active trace on this thread: instrumentation points still work,
    nothing is recorded."""

    trace_id = span_id = parent_id = None
    attrs: dict = {}
    links = None

    def set(self, **attrs):
        return self

    def add_link(self, trace_id, span_id):
        return self

    def finish(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


NULL_SPAN = _NullSpan()


class use:
    """Re-activate an existing span on the current thread — the executor
    thread-hop bridge: capture the span before submit(), ``with use(span):``
    inside the worker, and everything the worker records nests under it."""

    def __init__(self, span: Span | _NullSpan):
        self.span = span

    def __enter__(self):
        if self.span is not NULL_SPAN:
            _stack().append(self.span)
        return self.span

    def __exit__(self, *a):
        if self.span is not NULL_SPAN:
            st = _stack()
            if st and st[-1] is self.span:
                st.pop()
            else:
                try:
                    st.remove(self.span)
                except ValueError:
                    pass
        return False


def span(name: str, **attrs) -> Span | _NullSpan:
    """Child span of whatever is active on this thread (no-op when nothing
    is). The ONE call instrumentation sites need — they never see a Tracer."""
    parent = current()
    if parent is None or parent is NULL_SPAN:
        return NULL_SPAN
    return parent.tracer.child_of(parent, name, **attrs)


class Tracer:
    """Collects spans into traces; retains the last ``keep`` finished
    traces as a ring buffer for /debug/traces and --trace-out.

    ``clock`` is injectable so serving traces ride the harness's virtual
    time; ``on_drop(n)`` fires (outside the lock) whenever filing a trace
    evicts an older one from the full ring, and ``dropped_total`` counts
    evictions for the ``*_traces_dropped_total`` metric families."""

    def __init__(self, keep: int = DEFAULT_KEEP, *,
                 clock=time.monotonic, on_drop=None):
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._clock = clock
        self._on_drop = on_drop
        self._traces: deque[list[Span]] = deque(maxlen=keep)
        self._open: dict[int, list[Span]] = {}  # trace_id -> spans
        self.dropped_total = 0

    # -- span creation ----------------------------------------------------
    def start_trace(self, name: str, **attrs) -> Span:
        """New root span (use as a context manager: activates on this
        thread, finishes and files the trace on exit)."""
        with self._lock:
            trace_id = next(self._ids)
            root = Span(self, trace_id, next(self._ids), None, name, attrs)
            self._open[trace_id] = [root]

        # filing happens when the ROOT exits: wrap its __exit__ once
        tracer = self

        class _Root(Span):
            __slots__ = ()

        root.__class__ = _Root

        def _exit(exc_type, exc, tb, _orig=Span.__exit__):
            out = _orig(root, exc_type, exc, tb)
            tracer._file(trace_id)
            return out

        _Root.__exit__ = lambda self_, et, e, tb: _exit(et, e, tb)
        return root

    def child_of(self, parent: Span, name: str, **attrs) -> Span:
        with self._lock:
            sp = Span(self, parent.trace_id, next(self._ids),
                      parent.span_id, name, attrs)
            spans = self._open.get(parent.trace_id)
            if spans is not None:
                spans.append(sp)
            # parent's trace already filed (late child from a straggling
            # thread): drop silently — an orphan must never be exported
        return sp

    def end_trace(self, root: Span):
        """Finish and file a trace whose root is NOT context-managed — the
        per-request path, where submit() opens the span and a completion
        callback (possibly on another thread) closes it."""
        root.finish()
        self._file(root.trace_id)

    def _file(self, trace_id: int):
        evicted = 0
        with self._lock:
            spans = self._open.pop(trace_id, None)
            if spans:
                for sp in spans:
                    sp.finish()   # stragglers get closed at the root's end
                if self._traces.maxlen is not None and \
                        len(self._traces) == self._traces.maxlen:
                    evicted = 1
                self._traces.append(spans)
        if evicted:
            self.dropped_total += evicted
            if self._on_drop is not None:
                self._on_drop(evicted)

    # -- export -----------------------------------------------------------
    def traces(self) -> list[list[Span]]:
        with self._lock:
            return [list(t) for t in self._traces]

    def chrome_events(self) -> list[dict]:
        """All retained traces as Chrome trace-event 'X' (complete) events.
        ``ts``/``dur`` are microseconds; args carry the span tree (trace/
        span/parent ids) so nesting is machine-checkable independent of the
        tid-based visual nesting chrome://tracing infers."""
        events = []
        for spans in self.traces():
            for sp in spans:
                args = {"trace_id": sp.trace_id, "span_id": sp.span_id}
                if sp.parent_id is not None:
                    args["parent_id"] = sp.parent_id
                if sp.links:
                    args["links"] = [list(pair) for pair in sp.links]
                args.update(sp.attrs)
                events.append({
                    "name": sp.name, "ph": "X", "pid": os.getpid(),
                    "tid": sp.tid,
                    "ts": round(sp.start * 1e6, 1),
                    "dur": round(sp.duration_s * 1e6, 1),
                    "args": args,
                })
        return events

    def chrome_json(self) -> str:
        return json.dumps({"traceEvents": self.chrome_events(),
                           "displayTimeUnit": "ms"})

    def write_chrome(self, path: str):
        """Atomic write so a reader (or a crash) never sees a torn file."""
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(self.chrome_json())
        os.replace(tmp, path)


def verify_nesting(events: list[dict]) -> list[str]:
    """Structural check used by tests and the e2e harnesses: every non-root
    event's parent exists in the same trace, every span fits inside its
    parent's time window, and every span *link* (batch → member request)
    resolves to a real span with no request span claimed by two batches.
    Returns human-readable problems (empty = sound)."""
    by_trace: dict = {}
    all_ids: set[tuple] = set()
    for ev in events:
        a = ev.get("args", {})
        by_trace.setdefault(a.get("trace_id"), {})[a.get("span_id")] = ev
        all_ids.add((a.get("trace_id"), a.get("span_id")))
    problems = []
    claimed: dict[tuple, tuple] = {}  # linked (trace, span) -> linking span
    for tid, spans in by_trace.items():
        for sid, ev in spans.items():
            pid = ev["args"].get("parent_id")
            if pid is not None:
                parent = spans.get(pid)
                if parent is None:
                    problems.append(
                        f"trace {tid}: span {sid} ({ev['name']}) "
                        f"orphaned (parent {pid} missing)")
                elif ev["ts"] + 1000 < parent["ts"] or \
                        ev["ts"] + ev["dur"] > \
                        parent["ts"] + parent["dur"] + 1000:
                    # 1ms slack: start/end come from separate clock reads
                    problems.append(
                        f"trace {tid}: span {sid} ({ev['name']}) escapes "
                        f"its parent {pid} ({parent['name']}) time window")
            for pair in ev["args"].get("links") or []:
                target = (pair[0], pair[1])
                if target not in all_ids:
                    problems.append(
                        f"trace {tid}: span {sid} ({ev['name']}) links "
                        f"dangling span {target[1]} in trace {target[0]}")
                    continue
                prev = claimed.get(target)
                if prev is not None and prev != (tid, sid):
                    problems.append(
                        f"span {target[1]} (trace {target[0]}) claimed by "
                        f"two linking spans: {prev[1]} and {sid}")
                else:
                    claimed[target] = (tid, sid)
    return problems
