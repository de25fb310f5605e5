"""Fault injection for the kube client stack — chaos engineering in-repo.

The port of ``tpu_operator/kube/chaos.py``, which uses no device: the port
imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_cache.py`` holds the two equal on the same inputs.
The wire apiserver below is not ported yet; the client-side wrapper is.

Basiri et al.'s chaos principle applied at the layer this operator can
control: every API round-trip and watch stream is a place the control plane
can fail, so both are made to fail ON DEMAND, deterministically (seeded
RNG), at configurable rates, scoped by verb and kind. Two injection points
share one ``FaultInjector``:

- ``ChaosKubeClient`` wraps any ``KubeClient`` and injects faults
  client-side (no server needed — unit tests and the ``--chaos-*`` CLI
  flags use this);
- the wire apiserver (``kube/apiserver.py``) consults an attached injector
  server-side and answers real HTTP 429/500/503 (with ``Retry-After``),
  delays responses, tears watch streams mid-flight, and serves 410 Gone
  storms — so the client's full honor-path (header parsing, taxonomy
  mapping, backoff, relist) is exercised over the actual wire.

Faults come from one seeded ``random.Random`` behind a lock: two runs with
the same seed and the same request sequence inject the same faults, which
is what makes "converges at 30% fault rate" a reproducible assertion
rather than a flaky one.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from random import Random

from .client import (KubeClient, ServerUnavailableError, ThrottledError)
from .objects import Obj

# the fault menu: HTTP-shaped errors a hostile control plane actually emits
FAULT_CODES = (429, 500, 503)


@dataclass
class Fault:
    """One injection decision. ``kind`` is "http" (code + retry_after),
    "latency" (seconds), "drop" (tear the watch stream), or "gone"
    (410 the watch so the client must relist)."""
    kind: str
    code: int = 0
    retry_after: float | None = None
    latency_s: float = 0.0


@dataclass
class ChaosRules:
    """Per-verb/per-kind injection policy. ``rate`` is the probability a
    unary request gets an HTTP fault; ``latency_rate``/``latency_s`` add
    delay; ``watch_drop_rate`` tears watch streams after a few events;
    ``gone_rate`` answers watches with 410 Gone. ``verbs``/``kinds`` of
    None match everything (watch faults are scoped by ``kinds`` only)."""
    rate: float = 0.0
    faults: tuple = FAULT_CODES
    verbs: frozenset | None = None
    kinds: frozenset | None = None
    retry_after_s: float = 0.05
    latency_rate: float = 0.0
    latency_s: float = 0.0
    watch_drop_rate: float = 0.0
    gone_rate: float = 0.0

    def matches(self, verb: str, kind: str | None) -> bool:
        if self.verbs is not None and verb not in self.verbs:
            return False
        if self.kinds is not None and kind is not None \
                and kind not in self.kinds:
            return False
        return True


class FaultInjector:
    """Seeded fault source shared by the client wrapper and the apiserver.
    Thread-safe: the RNG and the injection counters sit behind one lock
    (watch streams and unary verbs consult it from many threads)."""

    def __init__(self, rules: ChaosRules | None = None, seed: int = 0):
        self.rules = rules or ChaosRules()
        self._rng = Random(seed)
        self._lock = threading.Lock()
        self.injected: dict[str, int] = {}   # fault kind/code -> count

    def _count(self, what: str):
        self.injected[what] = self.injected.get(what, 0) + 1

    def injected_total(self) -> int:
        with self._lock:
            return sum(self.injected.values())

    def decide(self, verb: str, kind: str | None) -> Fault | None:
        """Injection decision for one unary request (None = serve it)."""
        r = self.rules
        if not r.matches(verb, kind):
            return None
        with self._lock:
            if r.latency_rate and self._rng.random() < r.latency_rate:
                self._count("latency")
                return Fault("latency", latency_s=r.latency_s)
            if r.rate and self._rng.random() < r.rate:
                code = r.faults[self._rng.randrange(len(r.faults))]
                self._count(str(code))
                return Fault("http", code=code,
                             retry_after=r.retry_after_s
                             if code in (429, 503) else None)
        return None

    def decide_watch(self, kind: str | None) -> Fault | None:
        """Injection decision for one watch stream: "gone" answers it 410
        up front, "drop" tears it after a few events."""
        r = self.rules
        if not r.matches("watch", kind):
            return None
        with self._lock:
            if r.gone_rate and self._rng.random() < r.gone_rate:
                self._count("gone")
                return Fault("gone", code=410)
            if r.watch_drop_rate and self._rng.random() < r.watch_drop_rate:
                self._count("drop")
                return Fault("drop")
        return None


def _raise_http(fault: Fault, verb: str, kind: str | None):
    msg = f"chaos: injected HTTP {fault.code} on {verb} {kind or ''}"
    if fault.code == 429:
        raise ThrottledError(msg, retry_after=fault.retry_after)
    raise ServerUnavailableError(msg, retry_after=fault.retry_after)


class ChaosKubeClient(KubeClient):
    """Client-side injection: every verb consults the injector before
    reaching ``inner``. Faults surface as the SAME typed errors the wire
    client maps real HTTP failures to, so the retry layer above cannot
    tell chaos from a genuinely hostile apiserver (the point)."""

    def __init__(self, inner: KubeClient, injector: FaultInjector,
                 metrics=None, sleep=time.sleep):
        self.inner = inner
        self.injector = injector
        self.metrics = metrics
        self._sleep = sleep

    def _maybe_fail(self, verb: str, kind: str | None):
        fault = self.injector.decide(verb, kind)
        if fault is None:
            return
        if self.metrics is not None:
            what = str(fault.code) if fault.kind == "http" else fault.kind
            self.metrics.chaos_injected_total.labels(what).inc()
        if fault.kind == "latency":
            self._sleep(fault.latency_s)
            return
        _raise_http(fault, verb, kind)

    # -- KubeClient -------------------------------------------------------
    def get(self, kind, name, namespace=None) -> Obj:
        self._maybe_fail("get", kind)
        return self.inner.get(kind, name, namespace)

    def list(self, kind, namespace=None, label_selector=None) -> list[Obj]:
        self._maybe_fail("list", kind)
        return self.inner.list(kind, namespace, label_selector)

    def create(self, obj: Obj) -> Obj:
        self._maybe_fail("create", obj.kind)
        return self.inner.create(obj)

    def update(self, obj: Obj) -> Obj:
        self._maybe_fail("update", obj.kind)
        return self.inner.update(obj)

    def update_status(self, obj: Obj) -> Obj:
        self._maybe_fail("update_status", obj.kind)
        return self.inner.update_status(obj)

    def delete(self, kind, name, namespace=None, ignore_missing=True):
        self._maybe_fail("delete", kind)
        return self.inner.delete(kind, name, namespace,
                                 ignore_missing=ignore_missing)

    def server_version(self) -> dict | None:
        self._maybe_fail("server_version", None)
        return self.inner.server_version()

    def watch(self, kind, namespace=None, label_selector=None,
              timeout_s=300.0, resource_version=None):
        from .incluster import GoneError
        fault = self.injector.decide_watch(kind)
        if fault is not None and fault.kind == "gone":
            raise GoneError(f"chaos: injected 410 Gone on watch {kind}")
        stream = self.inner.watch(kind, namespace, label_selector,
                                  timeout_s, resource_version)
        if fault is None:
            return stream
        return self._dropping_stream(stream, kind)

    @staticmethod
    def _dropping_stream(stream, kind):
        """Yield a few events, then tear the stream the way a restarted
        apiserver does: an abrupt typed NetworkError, not a clean return
        (a clean return is indistinguishable from a healthy timeout)."""
        from .client import NetworkError
        for i, evt in enumerate(stream):
            if i >= 2:
                raise NetworkError(
                    f"chaos: injected watch stream drop on {kind}")
            yield evt
        raise NetworkError(f"chaos: injected watch stream drop on {kind}")

    def patch(self, kind, name, namespace=None, patch=None,
              subresource=None) -> Obj:
        inner_patch = getattr(self.inner, "patch", None)
        if inner_patch is None:
            raise NotImplementedError
        self._maybe_fail("patch", kind)
        return inner_patch(kind, name, namespace, patch, subresource)


def rules_from_flags(rate: float, seed: int, latency_s: float = 0.0,
                     latency_rate: float = 0.0, verbs: str = "",
                     kinds: str = "", watch_drop_rate: float = 0.0,
                     gone_rate: float = 0.0) -> FaultInjector | None:
    """CLI adapter for the ``--chaos-*`` flags: returns a ready injector,
    or None when every knob is off (the operator then skips the wrapper
    entirely — zero overhead on the hot path)."""
    if not (rate or latency_rate or watch_drop_rate or gone_rate):
        return None
    rules = ChaosRules(
        rate=rate,
        verbs=frozenset(v for v in verbs.split(",") if v) or None,
        kinds=frozenset(k for k in kinds.split(",") if k) or None,
        latency_rate=latency_rate, latency_s=latency_s,
        watch_drop_rate=watch_drop_rate, gone_rate=gone_rate)
    return FaultInjector(rules, seed=seed)
