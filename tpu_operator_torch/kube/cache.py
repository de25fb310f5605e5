"""Informer-lite read-through cache over any KubeClient.

The port of ``tpu_operator/kube/cache.py``, which uses no device: the port
imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_cache.py`` holds the two equal on the same inputs.

The converged reconcile loop is read-dominated: every 5 s requeue pays a
live GET per managed object (``apply_idempotent``) plus full Node LISTs
(labeling, runtime detection) even though nothing changed. Real operators
solve this with client-go informers — LIST once, WATCH for invalidation,
serve reads from local store. This is that machinery reduced to what the
reconciler needs (~250 lines):

- ``list()`` primes a per-(kind, namespace) store from one full LIST and
  answers later lists (including label-selected ones) locally.
- ``get()`` serves primed kinds authoritatively — including authoritative
  NotFound — and caches per-object reads (with NotFound tombstones) for
  unprimed kinds.
- All writes go through to the API and the response is written through to
  the store, resourceVersion-monotonically, so the cache can never regress
  an object it wrote itself.
- A lazy per-(kind, namespace) daemon watch thread keeps primed stores
  fresh against external writers. When the client has no ``watch()``
  (NotImplementedError) the store falls back to TTL-on-poll: a primed
  store older than ``ttl_s`` re-LISTs on the next read.
- ``ConflictError`` on update invalidates the entry before re-raising:
  somebody else wrote the object, our copy is provably stale.

Every inner API call is counted in ``api_requests`` (by verb and kind) and
every cache decision in ``hits``/``misses`` — mirrored into
``OperatorMetrics`` (``gpu_operator_api_requests_total``,
``gpu_operator_cache_{hits,misses}_total``) when one is attached, which is
how the e2e harness proves a converged pass issues zero API reads.
"""

from __future__ import annotations

import logging
import threading
import time
from contextlib import contextmanager

from ..utils import trace
from .client import ConflictError, KubeClient, KubeError, NotFoundError
from .objects import Obj, gvr_for
from .selectors import match_labels

log = logging.getLogger("gpu-operator")

DEFAULT_TTL_S = 30.0

# sentinel distinguishing "cached NotFound" from "never looked"
_TOMBSTONE = None


def _rv_int(raw: dict | None) -> int:
    try:
        return int((raw or {}).get("metadata", {}).get("resourceVersion", "0"))
    except (TypeError, ValueError):
        return 0


class CachedKubeClient(KubeClient):
    """Wrap ``inner`` with a read-through object cache. Thread-safe: the
    DAG scheduler drives several states' reads/writes through one instance
    concurrently."""

    def __init__(self, inner: KubeClient, metrics=None,
                 ttl_s: float = DEFAULT_TTL_S, watch: bool = True):
        self.inner = inner
        self.metrics = metrics
        self.ttl_s = ttl_s
        self._watch_enabled = watch
        self._lock = threading.RLock()
        # (kind, ns, name) -> raw dict, or _TOMBSTONE for a cached NotFound
        self._objects: dict[tuple, dict | None] = {}
        # (kind, ns-or-None) -> monotonic prime time of the full LIST
        self._primed: dict[tuple, float] = {}
        # per-object read time for TTL freshness of unprimed-kind gets
        self._read_at: dict[tuple, float] = {}
        # (kind, ns-or-None) -> "ok" | "retry" | "unavailable"
        self._watch_state: dict[tuple, str] = {}
        self._watch_threads: dict[tuple, threading.Thread] = {}
        self.hits = 0
        self.misses = 0
        self.api_requests: dict[tuple, int] = {}  # (verb, kind) -> count

    # -- accounting -------------------------------------------------------
    def _count_api(self, verb: str, kind: str):
        with self._lock:
            k = (verb, kind)
            self.api_requests[k] = self.api_requests.get(k, 0) + 1
        if self.metrics is not None:
            self.metrics.api_requests_total.labels(verb, kind).inc()

    @contextmanager
    def _api_call(self, verb: str, kind: str):
        """Every live call the cache actually issues goes through here:
        counted by (verb, kind), wrapped in an ``api:<verb>`` trace span
        (child of whatever state span is active on this thread; no-op from
        the watch threads), and its latency observed into the
        ``api_request_duration_seconds`` histogram."""
        self._count_api(verb, kind)
        t0 = time.monotonic()
        with trace.span(f"api:{verb}", verb=verb, kind=kind):
            try:
                yield
            finally:
                if self.metrics is not None:
                    self.metrics.api_request_seconds.labels(
                        verb, kind).observe(time.monotonic() - t0)

    def _observe_lookup(self, op: str, t0: float):
        if self.metrics is not None:
            self.metrics.cache_lookup_seconds.labels(op).observe(
                time.monotonic() - t0)

    def _hit(self):
        with self._lock:
            self.hits += 1
        if self.metrics is not None:
            self.metrics.cache_hits_total.inc()

    def _miss(self):
        with self._lock:
            self.misses += 1
        if self.metrics is not None:
            self.metrics.cache_misses_total.inc()

    def hit_ratio(self) -> float:
        with self._lock:
            total = self.hits + self.misses
            return self.hits / total if total else 0.0

    def api_reads(self, verb: str | None = None,
                  kind: str | None = None) -> int:
        """Total inner API calls, filterable by verb and/or kind — the
        counter the converged-pass zero-read assertion reads."""
        with self._lock:
            return sum(n for (v, k), n in self.api_requests.items()
                       if (verb is None or v == verb)
                       and (kind is None or k == kind))

    # -- internals --------------------------------------------------------
    def _key(self, kind, name, namespace) -> tuple:
        if not gvr_for(kind).namespaced:
            namespace = None
        return (kind, namespace or "", name)

    def _store_raw(self, raw: dict):
        """resourceVersion-monotonic upsert: a stale watch replay must not
        clobber a newer write-through."""
        meta = raw.get("metadata", {})
        key = self._key(raw.get("kind"), meta.get("name"),
                        meta.get("namespace"))
        with self._lock:
            cur = self._objects.get(key)
            if cur is not _TOMBSTONE and key in self._objects and \
                    _rv_int(cur) > _rv_int(raw):
                return
            self._objects[key] = raw
            self._read_at[key] = time.monotonic()

    def _drop(self, key: tuple, tombstone: bool = False):
        with self._lock:
            if tombstone:
                self._objects[key] = _TOMBSTONE
                self._read_at[key] = time.monotonic()
            else:
                self._objects.pop(key, None)
                self._read_at.pop(key, None)
                # a non-tombstone drop means "our view is provably stale",
                # not "the object is gone": a still-primed scope would keep
                # answering lists/gets authoritatively WITHOUT the object
                # until the next watch replay — demote the prime so the
                # next read re-LISTs live
                self._primed.pop((key[0], key[1] or None), None)
                self._primed.pop((key[0], None), None)

    def invalidate(self, kind: str | None = None):
        """Drop cached state (all of it, or one kind) — forces live reads."""
        with self._lock:
            if kind is None:
                self._objects.clear()
                self._primed.clear()
                self._read_at.clear()
            else:
                for k in [k for k in self._objects if k[0] == kind]:
                    del self._objects[k]
                    self._read_at.pop(k, None)
                for p in [p for p in self._primed if p[0] == kind]:
                    del self._primed[p]

    def _watch_fresh(self, kind: str, ns) -> bool:
        return self._watch_state.get((kind, ns)) == "ok"

    def _primed_scope(self, kind: str, namespace) -> tuple | None:
        """The primed scope covering (kind, namespace), if fresh. A
        cluster-wide prime (ns None) covers every namespace of the kind."""
        ns = namespace if gvr_for(kind).namespaced else None
        with self._lock:
            for scope in ((kind, ns), (kind, None)):
                t = self._primed.get(scope)
                if t is None:
                    continue
                if self._watch_fresh(*scope) or \
                        time.monotonic() - t < self.ttl_s:
                    return scope
                del self._primed[scope]  # TTL expired without watch
        return None

    # -- watch invalidation -----------------------------------------------
    def _ensure_watch(self, kind: str, ns):
        if not self._watch_enabled:
            return
        key = (kind, ns)
        with self._lock:
            if self._watch_state.get(key) == "unavailable" or \
                    key in self._watch_threads:
                return
            t = threading.Thread(target=self._watch_loop, args=(kind, ns),
                                 daemon=True, name=f"cache-watch-{kind}")
            self._watch_threads[key] = t
            self._watch_state[key] = "ok"
        t.start()

    def _watch_loop(self, kind: str, ns):
        key = (kind, ns)
        while True:
            try:
                # no resumption rv: the full ADDED replay after each
                # (re)connect is an idempotent refresh of the store
                for etype, obj in self.inner.watch(kind, ns,
                                                   timeout_s=300.0):
                    if etype == "BOOKMARK":
                        continue
                    if etype == "DELETED":
                        self._drop(self._key(kind, obj.name, obj.namespace),
                                   tombstone=True)
                    else:
                        raw = obj.raw
                        raw.setdefault("kind", kind)
                        self._store_raw(raw)
                with self._lock:
                    self._watch_state[key] = "ok"  # clean timeout = healthy
            except NotImplementedError:
                with self._lock:
                    self._watch_state[key] = "unavailable"
                log.debug("cache: %s has no watch; TTL fallback (%.0fs)",
                          kind, self.ttl_s)
                return
            except KubeError as e:
                # stream broke: events may have been missed — demote the
                # prime so the next read re-LISTs, then retry the watch
                with self._lock:
                    self._watch_state[key] = "retry"
                    self._primed.pop(key, None)
                log.debug("cache: watch %s broke (%s); re-listing", kind, e)
                time.sleep(1.0)
            except Exception:
                with self._lock:
                    self._watch_state[key] = "retry"
                    self._primed.pop(key, None)
                log.exception("cache: watch %s failed unexpectedly", kind)
                time.sleep(1.0)

    # -- KubeClient: reads ------------------------------------------------
    def get(self, kind, name, namespace=None) -> Obj:
        t_lookup = time.monotonic()
        key = self._key(kind, name, namespace)
        with self._lock:
            known = key in self._objects
            raw = self._objects.get(key)
            fresh = (self._primed_scope(kind, namespace) is not None
                     or self._watch_fresh(kind, key[1] or None)
                     or (known and time.monotonic()
                         - self._read_at.get(key, 0.0) < self.ttl_s))
        if known and fresh:
            self._hit()
            self._observe_lookup("get", t_lookup)
            if raw is _TOMBSTONE:
                raise NotFoundError(
                    f"{kind} {namespace or ''}/{name} not found (cached)")
            return Obj(raw).deepcopy()
        if not known and self._primed_scope(kind, namespace) is not None:
            # the full LIST is authoritative for the scope: absent = absent
            self._hit()
            self._observe_lookup("get", t_lookup)
            raise NotFoundError(
                f"{kind} {namespace or ''}/{name} not found (cached list)")
        self._miss()
        self._observe_lookup("get", t_lookup)
        try:
            with self._api_call("get", kind):
                obj = self.inner.get(kind, name, namespace)
        except NotFoundError:
            self._drop(key, tombstone=True)
            raise
        raw = obj.raw
        raw.setdefault("kind", kind)
        self._store_raw(raw)
        return obj

    def get_readonly(self, kind, name, namespace=None) -> dict | None:
        """Zero-copy fast path for the converged reconcile: the cached raw
        dict itself (shared — callers MUST NOT mutate it, not even via Obj
        accessors, which setdefault into it), or None when the object is
        not cache-resident-and-fresh. None means "fall back to get()";
        a cached NotFound also returns None (the caller's fallback read
        re-establishes it cheaply). Store raws are only ever replaced
        wholesale, never edited in place, so a handed-out raw stays
        internally consistent."""
        t_lookup = time.monotonic()
        key = self._key(kind, name, namespace)
        with self._lock:
            known = key in self._objects
            raw = self._objects.get(key)
            # cheapest freshness signal first: the steady-state hot path is
            # a watch-fresh hit, which needs only a dict lookup
            fresh = (self._watch_fresh(kind, key[1] or None)
                     or self._primed_scope(kind, namespace) is not None
                     or (known and time.monotonic()
                         - self._read_at.get(key, 0.0) < self.ttl_s))
        if known and fresh and raw is not _TOMBSTONE:
            self._hit()
            self._observe_lookup("get", t_lookup)
            return raw
        return None

    def list_readonly(self, kind, namespace=None,
                      label_selector=None) -> list[Obj] | None:
        """Zero-copy list: Obj wrappers over the shared cached raws when the
        scope is primed-and-fresh, else None (caller falls back to list(),
        which primes). Same no-mutation contract as get_readonly()."""
        t_lookup = time.monotonic()
        if self._primed_scope(kind, namespace) is None:
            return None
        self._hit()
        ns = namespace if gvr_for(kind).namespaced else None
        with self._lock:
            # insertion order (not sorted): this is the per-pass hot walk,
            # and its callers are order-insensitive node scans
            out = []
            for (k, kns, _), raw in self._objects.items():
                if k != kind or raw is _TOMBSTONE:
                    continue
                if ns and kns != ns:
                    continue
                if label_selector and not match_labels(
                        raw.get("metadata", {}).get("labels"),
                        label_selector):
                    continue
                out.append(Obj(raw))
        self._observe_lookup("list", t_lookup)
        return out

    def list(self, kind, namespace=None, label_selector=None) -> list[Obj]:
        t_lookup = time.monotonic()
        scope = self._primed_scope(kind, namespace)
        if scope is not None:
            self._hit()
            out = self._local_list(kind, namespace, label_selector)
            self._observe_lookup("list", t_lookup)
            return out
        # prime with a FULL list of the scope (selector applied locally),
        # informer-style, so every later selected list is a local filter
        ns = namespace if gvr_for(kind).namespaced else None
        self._miss()
        self._observe_lookup("list", t_lookup)
        with self._api_call("list", kind):
            objs = self.inner.list(kind, namespace)
        with self._lock:
            # replace the scope wholesale: deletes-while-stale must go
            for k in [k for k in self._objects
                      if k[0] == kind and (ns is None or k[1] == ns)
                      and self._objects[k] is not _TOMBSTONE]:
                del self._objects[k]
        for o in objs:
            raw = o.raw
            raw.setdefault("kind", kind)
            self._store_raw(raw)
        with self._lock:
            self._primed[(kind, ns)] = time.monotonic()
        self._ensure_watch(kind, ns)
        return [o.deepcopy() for o in objs
                if match_labels(o.labels, label_selector)]

    def _local_list(self, kind, namespace, label_selector) -> list[Obj]:
        ns = namespace if gvr_for(kind).namespaced else None
        with self._lock:
            out = []
            for (k, kns, _), raw in sorted(self._objects.items(),
                                           key=lambda kv: kv[0]):
                if k != kind or raw is _TOMBSTONE:
                    continue
                if ns and kns != ns:
                    continue
                if match_labels(raw.get("metadata", {}).get("labels"),
                                label_selector):
                    out.append(Obj(raw).deepcopy())
            return out

    # -- KubeClient: writes (write-through) -------------------------------
    def create(self, obj: Obj) -> Obj:
        try:
            with self._api_call("create", obj.kind):
                created = self.inner.create(obj)
        except KubeError:
            # e.g. AlreadyExists against a tombstone: our negative entry is
            # provably stale
            self._drop(self._key(obj.kind, obj.name, obj.namespace))
            raise
        self._store_raw(dict(created.raw, kind=created.kind))
        return created

    def update(self, obj: Obj) -> Obj:
        try:
            with self._api_call("update", obj.kind):
                updated = self.inner.update(obj)
        except ConflictError:
            # a concurrent writer owns the newer version: invalidate so the
            # caller's retry re-reads live
            self._drop(self._key(obj.kind, obj.name, obj.namespace))
            raise
        self._store_raw(dict(updated.raw, kind=updated.kind))
        return updated

    def update_status(self, obj: Obj) -> Obj:
        try:
            with self._api_call("update_status", obj.kind):
                updated = self.inner.update_status(obj)
        except ConflictError:
            self._drop(self._key(obj.kind, obj.name, obj.namespace))
            raise
        self._store_raw(dict(updated.raw, kind=updated.kind))
        return updated

    def patch(self, kind, name, namespace=None, patch=None, subresource=None):
        key = self._key(kind, name, namespace)
        try:
            with self._api_call("patch", kind):
                patched = self.inner.patch(kind, name, namespace,
                                           patch=patch, subresource=subresource)
        except (ConflictError, NotFoundError):
            # either way our cached view is provably stale
            self._drop(key)
            raise
        self._store_raw(dict(patched.raw, kind=patched.kind))
        return patched

    def delete(self, kind, name, namespace=None, ignore_missing=True):
        key = self._key(kind, name, namespace)
        if ignore_missing:
            with self._lock:
                raw = self._objects.get(key)
                known_absent = (
                    (key in self._objects and raw is _TOMBSTONE
                     and time.monotonic() - self._read_at.get(key, 0.0)
                     < self.ttl_s)
                    or (key not in self._objects
                        and self._primed_scope(kind, namespace) is not None))
            if known_absent:
                # disabled states delete their objects every pass; a
                # known-absent target needs no API round-trip
                self._hit()
                return
        try:
            with self._api_call("delete", kind):
                self.inner.delete(kind, name, namespace,
                                  ignore_missing=ignore_missing)
        finally:
            self._drop(key, tombstone=True)

    # -- passthrough ------------------------------------------------------
    def server_version(self) -> dict | None:
        return self.inner.server_version()

    def watch(self, kind, namespace=None, label_selector=None,
              timeout_s=300.0, resource_version=None):
        return self.inner.watch(kind, namespace, label_selector,
                                timeout_s, resource_version)
