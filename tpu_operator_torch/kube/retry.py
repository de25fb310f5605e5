"""Retrying kube client: backoff + jitter, deadlines, circuit breaker.

The port of ``tpu_operator/kube/retry.py``, which uses no device: the port
imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_cache.py`` holds the two equal on the same inputs.

client-go analogue: the rate-limiting/retry machinery every controller gets
for free (client-go's retry.OnError + flowcontrol backoff) — here as a
wrapper over any ``KubeClient``, so the reconcile code stays oblivious:

- only the ``TransientError`` subtree is retried (429/5xx/wire failures);
  NotFound/AlreadyExists/Conflict are control flow the caller owns;
- exponential backoff with FULL jitter (sleep ~ U(0, min(cap, base·2^n)) —
  the AWS-architecture-blog variant that de-synchronizes a fleet of
  clients hammering a recovering apiserver);
- a server-sent ``Retry-After`` is honored as a FLOOR on the sleep: the
  server's explicit flow-control signal outranks our local guess;
- per-verb deadline budgets: a read that can be re-driven next reconcile
  pass gives up sooner than a write whose loss costs a whole pass;
- a circuit breaker trips OPEN after ``breaker_threshold`` consecutive
  transient failures — further calls fast-fail with ``CircuitOpenError``
  (no sleeps, no wire traffic: a dead apiserver shouldn't also cost every
  caller its full backoff schedule) — then HALF-OPEN after
  ``breaker_cooldown_s`` lets exactly one probe through; a probe success
  closes the circuit, a failure re-opens it.

The RNG is injectable (seeded in tests/chaos harness) so every retry
schedule is reproducible.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from .client import KubeClient, TransientError
from .objects import Obj

log = logging.getLogger("gpu-operator")

# verb → seconds of total retry budget (first attempt included). Reads are
# cheap to re-drive from the next reconcile pass; writes losing their slot
# costs a full requeue interval, so they get a longer leash.
DEFAULT_DEADLINES_S = {
    "get": 10.0, "list": 15.0,
    "create": 30.0, "update": 30.0, "update_status": 30.0,
    "delete": 30.0, "server_version": 5.0,
}
DEFAULT_DEADLINE_S = 30.0


class CircuitOpenError(TransientError):
    """Fast-fail: the breaker is open, no request was attempted."""


class RetryPolicy:
    """Tunables for one RetryingKubeClient (one instance is shared by all
    verbs; thread-safe — it holds no mutable state)."""

    def __init__(self, max_attempts: int = 5, base_s: float = 0.1,
                 cap_s: float = 5.0,
                 deadlines_s: dict[str, float] | None = None,
                 breaker_threshold: int = 5,
                 breaker_cooldown_s: float = 10.0):
        self.max_attempts = max(1, int(max_attempts))
        self.base_s = base_s
        self.cap_s = cap_s
        self.deadlines_s = dict(DEFAULT_DEADLINES_S)
        if deadlines_s:
            self.deadlines_s.update(deadlines_s)
        self.breaker_threshold = max(1, int(breaker_threshold))
        self.breaker_cooldown_s = breaker_cooldown_s

    def deadline_for(self, verb: str) -> float:
        return self.deadlines_s.get(verb, DEFAULT_DEADLINE_S)

    def backoff_s(self, attempt: int, rng: random.Random,
                  retry_after: float | None = None) -> float:
        """Sleep before retry number ``attempt`` (1-based): full jitter
        over the exponential envelope, floored by the server's
        Retry-After when it sent one."""
        envelope = min(self.cap_s, self.base_s * (2 ** (attempt - 1)))
        sleep = rng.uniform(0.0, envelope)
        if retry_after is not None:
            sleep = max(sleep, min(retry_after, self.cap_s))
        return sleep


class _Breaker:
    """Consecutive-failure circuit breaker, shared across verbs: the
    failing resource is the apiserver itself, not any one endpoint."""

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half-open"

    def __init__(self, threshold: int, cooldown_s: float):
        self.threshold = threshold
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self.state = self.CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.open_total = 0
        self._probe_in_flight = False

    def allow(self) -> bool:
        """May a request go out right now? Transitions OPEN → HALF_OPEN
        after the cooldown and claims the single probe slot."""
        with self._lock:
            if self.state == self.CLOSED:
                return True
            if self.state == self.OPEN:
                if time.monotonic() - self.opened_at < self.cooldown_s:
                    return False
                self.state = self.HALF_OPEN
                self._probe_in_flight = False
            # HALF_OPEN: exactly one probe at a time
            if self._probe_in_flight:
                return False
            self._probe_in_flight = True
            return True

    def record_success(self):
        with self._lock:
            self.state = self.CLOSED
            self.failures = 0
            self._probe_in_flight = False

    def record_failure(self) -> bool:
        """One transient failure (an exhausted retry loop counts once per
        attempt, so a single slow call can trip the breaker — that is the
        point: N wire-confirmed failures, not N callers). Returns True
        when this failure TRANSITIONED the breaker to open."""
        with self._lock:
            self.failures += 1
            self._probe_in_flight = False
            if self.state == self.HALF_OPEN or \
                    self.failures >= self.threshold:
                tripped = self.state != self.OPEN
                if tripped:
                    self.open_total += 1
                self.state = self.OPEN
                self.opened_at = time.monotonic()
                return tripped
            return False


class RetryingKubeClient(KubeClient):
    """Wrap ``inner`` with the retry/breaker policy above. Thread-safe:
    the DAG scheduler drives concurrent states through one instance."""

    def __init__(self, inner: KubeClient, policy: RetryPolicy | None = None,
                 metrics=None, rng: random.Random | None = None,
                 sleep=time.sleep):
        self.inner = inner
        self.policy = policy or RetryPolicy()
        self.metrics = metrics
        self._rng = rng or random.Random()
        self._rng_lock = threading.Lock()
        self._sleep = sleep
        self.breaker = _Breaker(self.policy.breaker_threshold,
                                self.policy.breaker_cooldown_s)
        self.retries = 0                    # total retry attempts issued
        self.retries_by: dict[tuple, int] = {}   # (verb, kind) -> count

    # -- plumbing ---------------------------------------------------------
    def _uniform_backoff(self, attempt: int, retry_after) -> float:
        with self._rng_lock:
            return self.policy.backoff_s(attempt, self._rng, retry_after)

    def _count_retry(self, verb: str, kind: str):
        with self._rng_lock:
            self.retries += 1
            k = (verb, kind)
            self.retries_by[k] = self.retries_by.get(k, 0) + 1
        if self.metrics is not None:
            self.metrics.api_retries_total.labels(verb, kind).inc()

    def _set_breaker_gauge(self):
        if self.metrics is not None:
            self.metrics.circuit_state.set(
                {self.breaker.CLOSED: 0, self.breaker.OPEN: 1,
                 self.breaker.HALF_OPEN: 2}[self.breaker.state])

    def _call(self, verb: str, kind: str, fn):
        """The retry loop every verb funnels through."""
        deadline = time.monotonic() + self.policy.deadline_for(verb)
        attempt = 0
        while True:
            attempt += 1
            if not self.breaker.allow():
                self._set_breaker_gauge()
                raise CircuitOpenError(
                    f"{verb} {kind}: circuit open after "
                    f"{self.breaker.failures} consecutive failures")
            try:
                result = fn()
            except TransientError as e:
                tripped = self.breaker.record_failure()
                if tripped and self.metrics is not None:
                    self.metrics.circuit_open_total.inc()
                self._set_breaker_gauge()
                if attempt >= self.policy.max_attempts or \
                        self.breaker.state == self.breaker.OPEN:
                    raise
                sleep = self._uniform_backoff(attempt,
                                              getattr(e, "retry_after", None))
                if time.monotonic() + sleep > deadline:
                    # the budget is spent: surfacing the real error beats
                    # sleeping past the verb's deadline to fail anyway
                    raise
                log.debug("%s %s attempt %d/%d failed (%s); retrying in "
                          "%.3fs", verb, kind, attempt,
                          self.policy.max_attempts, e, sleep)
                self._count_retry(verb, kind)
                self._sleep(sleep)
            else:
                self.breaker.record_success()
                self._set_breaker_gauge()
                return result

    # -- KubeClient -------------------------------------------------------
    def get(self, kind, name, namespace=None) -> Obj:
        return self._call("get", kind,
                          lambda: self.inner.get(kind, name, namespace))

    def list(self, kind, namespace=None, label_selector=None) -> list[Obj]:
        return self._call("list", kind, lambda: self.inner.list(
            kind, namespace, label_selector))

    def create(self, obj: Obj) -> Obj:
        # NOTE: create is retried on transient errors even though the first
        # attempt may have landed server-side before the reply was lost; a
        # duplicate create surfaces as AlreadyExistsError, which apply()
        # already resolves to an update — the idempotent-apply pattern makes
        # the retry safe.
        return self._call("create", obj.kind, lambda: self.inner.create(obj))

    def update(self, obj: Obj) -> Obj:
        return self._call("update", obj.kind, lambda: self.inner.update(obj))

    def update_status(self, obj: Obj) -> Obj:
        return self._call("update_status", obj.kind,
                          lambda: self.inner.update_status(obj))

    def delete(self, kind, name, namespace=None, ignore_missing=True):
        return self._call("delete", kind, lambda: self.inner.delete(
            kind, name, namespace, ignore_missing=ignore_missing))

    def server_version(self) -> dict | None:
        return self._call("server_version", "none",
                          lambda: self.inner.server_version())

    def watch(self, kind, namespace=None, label_selector=None,
              timeout_s=300.0, resource_version=None):
        # watches are long-lived streams with their own reconnect loops in
        # every caller (WatchTrigger, CachedKubeClient) — wrapping them in
        # the unary retry loop would turn one torn stream into max_attempts
        # torn streams; pass through untouched
        return self.inner.watch(kind, namespace, label_selector,
                                timeout_s, resource_version)

    def patch(self, kind, name, namespace=None, patch=None,
              subresource=None) -> Obj:
        # optional capability (InClusterClient has it; fakes don't)
        inner_patch = getattr(self.inner, "patch", None)
        if inner_patch is None:
            raise NotImplementedError
        return self._call("patch", kind, lambda: inner_patch(
            kind, name, namespace, patch, subresource))
