"""Stdlib-only REST client for running inside a cluster.

The port's copy of ``tpu_operator/kube/incluster.py``, which uses no device:
the port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Replaces the reference's client-go dependency with ~200 lines against the
Kubernetes REST API: bearer token + cluster CA from the service-account mount,
JSON bodies, the five verbs plus watch. The reconciler stays level-triggered
(5 s requeue until ready, reference clusterpolicy_controller.go:140,167);
watch events only wake it early, exactly the role controller-runtime watches
play over the same Reconcile (clusterpolicy_controller.go:316-347).
"""

from __future__ import annotations

import http.client
import json
import logging
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request

from ..utils import trace
from .client import (AlreadyExistsError, ConflictError, KubeClient,
                     KubeError, NetworkError, NotFoundError,
                     ServerUnavailableError, ThrottledError)
from .objects import Obj, gvr_for

log = logging.getLogger("gpu-operator")

SA_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class GoneError(KubeError):
    """Watch resourceVersion expired (HTTP 410 / 'too old')."""


def _retry_after(headers) -> float | None:
    """Parse a Retry-After header (seconds form only — the HTTP-date form
    is never emitted by an apiserver) into seconds, None when absent or
    unparseable."""
    raw = headers.get("Retry-After") if headers is not None else None
    if raw is None:
        return None
    try:
        val = float(raw)
    except (TypeError, ValueError):
        return None
    return val if val >= 0 else None


def _map_status(method: str, path: str, status: int, headers,
                detail: str) -> KubeError:
    """HTTP status → typed error, so retry policy can tell a throttled or
    dying apiserver (retryable, with its Retry-After hint honored) from a
    request that will never succeed (flat KubeError)."""
    if status == 404:
        return NotFoundError(detail)
    if status == 409:
        # both AlreadyExists (create) and Conflict (update) are 409;
        # disambiguate by reason in the status body
        if '"reason":"AlreadyExists"' in detail.replace(" ", ""):
            return AlreadyExistsError(detail)
        return ConflictError(detail)
    msg = f"{method} {path}: HTTP {status}: {detail}"
    if status == 429:
        return ThrottledError(msg, retry_after=_retry_after(headers))
    if status in (500, 502, 503, 504):
        return ServerUnavailableError(msg, retry_after=_retry_after(headers))
    return KubeError(msg)


def _map_http_error(method: str, path: str,
                    e: urllib.error.HTTPError) -> KubeError:
    """urllib adapter over _map_status — the watch path still streams
    through urllib (chunked reads) while the request path pools."""
    detail = e.read().decode(errors="replace")[:500]
    return _map_status(method, path, e.code, e.headers, detail)


class _ConnectionPool:
    """One persistent HTTP/1.1 keep-alive connection per (thread, host).

    urllib tears down the TCP+TLS session after every request; each request
    a reconcile pass makes then pays a fresh handshake. http.client keeps
    the socket open across requests as long as both sides speak keep-alive
    (the apiserver does). Thread-local because http.client connections are
    not thread-safe and the DAG walk issues requests from several workers
    at once. ``opens``/``reuses`` feed the steady-state benchmark."""

    def __init__(self, base: str, ssl_ctx, timeout: float):
        u = urllib.parse.urlsplit(base)
        self.scheme = u.scheme or "https"
        self.host = u.hostname or "localhost"
        self.port = u.port or (443 if self.scheme == "https" else 80)
        self.ssl_ctx = ssl_ctx
        self.timeout = timeout
        self._local = threading.local()
        self._lock = threading.Lock()
        self.opens = 0
        self.reuses = 0
        self.evictions = 0
        self.in_flight = 0

    def _new_conn(self):
        if self.scheme == "https":
            conn = http.client.HTTPSConnection(
                self.host, self.port, timeout=self.timeout,
                context=self.ssl_ctx)
        else:
            conn = http.client.HTTPConnection(
                self.host, self.port, timeout=self.timeout)
        with self._lock:
            self.opens += 1
        return conn

    def acquire(self) -> tuple:
        """(conn, reused) — ``reused`` tells the caller whether a socket
        failure may be a stale keep-alive (retryable once) rather than a
        live network problem."""
        conn = getattr(self._local, "conn", None)
        if conn is not None:
            with self._lock:
                self.reuses += 1
            return conn, True
        conn = self._new_conn()
        self._local.conn = conn
        return conn, False

    def discard(self):
        conn = getattr(self._local, "conn", None)
        self._local.conn = None
        if conn is not None:
            with self._lock:
                self.evictions += 1
            try:
                conn.close()
            except Exception as e:
                # the socket is being thrown away either way; log so a
                # systematically failing close still leaves a trail
                log.debug("discarding apiserver conn: close failed: %s", e)

    def replace(self):
        """Fresh connection after a reused socket died."""
        self.discard()
        conn = self._new_conn()
        self._local.conn = conn
        return conn

    def request_started(self):
        with self._lock:
            self.in_flight += 1

    def request_finished(self):
        with self._lock:
            if self.in_flight > 0:
                self.in_flight -= 1

    def stats(self) -> dict:
        """Counters for the shared /debug/pools endpoint — same shape as
        relay.pool.RelayConnectionPool.stats()."""
        with self._lock:
            return {"opens": self.opens, "reuses": self.reuses,
                    "evictions": self.evictions, "in_flight": self.in_flight}


# methods safe to replay on a fresh socket when a reused keep-alive
# connection turns out to be dead: everything the operator sends except
# POST (a create may have been applied before the socket died)
_IDEMPOTENT = frozenset({"GET", "PUT", "DELETE", "HEAD", "PATCH"})


def _selector_str(label_selector) -> str:
    if isinstance(label_selector, dict):
        return ",".join(f"{k}={v}" for k, v in label_selector.items())
    return label_selector


class InClusterClient(KubeClient):
    def __init__(self, host: str | None = None, token: str | None = None,
                 ca_file: str | None = None, timeout: float = 30.0):
        if host is None:
            h = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default")
            p = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            host = f"https://{h}:{p}"
        self.base = host.rstrip("/")
        if token is None:
            token_path = os.path.join(SA_DIR, "token")
            if not os.path.exists(token_path):
                raise KubeError(
                    "no service-account token at "
                    f"{token_path}: not running inside a cluster "
                    "(pass host/token explicitly, or use the fake client)")
            with open(token_path) as f:
                token = f.read().strip()
        self.token = token
        self.timeout = timeout
        ca = ca_file or os.path.join(SA_DIR, "ca.crt")
        self.ctx = ssl.create_default_context(cafile=ca) \
            if os.path.exists(ca) else ssl.create_default_context()
        self.pool = _ConnectionPool(self.base, self.ctx, timeout)

    # -- plumbing ---------------------------------------------------------
    def _path(self, kind: str, namespace: str | None, name: str | None,
              subresource: str | None = None, query: dict | None = None) -> str:
        info = gvr_for(kind)
        if "/" in info.api_version:
            group, version = info.api_version.split("/", 1)
            root = f"/apis/{group}/{version}"
        else:
            root = f"/api/{info.api_version}"
        parts = [root]
        if info.namespaced:
            if not namespace:
                raise ValueError(f"{kind} requires a namespace")
            parts.append(f"namespaces/{namespace}")
        parts.append(info.plural)
        if name:
            parts.append(name)
        if subresource:
            parts.append(subresource)
        url = "/".join(parts)
        if query:
            url += "?" + urllib.parse.urlencode(query)
        return url

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json") -> dict:
        # the single wire chokepoint: one span per HTTP round-trip, nesting
        # under whatever state/api span is active (no-op when untraced)
        with trace.span("http:request", method=method, path=path):
            return self._request_inner(method, path, body, content_type)

    def _request_inner(self, method: str, path: str, body: dict | None,
                       content_type: str) -> dict:
        data = json.dumps(body).encode() if body is not None else None
        headers = {
            "Authorization": f"Bearer {self.token}",
            "Accept": "application/json",
            "Content-Type": content_type,
        }
        conn, reused = self.pool.acquire()
        self.pool.request_started()
        try:
            try:
                status, resp_headers, payload = self._roundtrip(
                    conn, method, path, data, headers)
            except (http.client.HTTPException, OSError) as e:
                if not (reused and method in _IDEMPOTENT):
                    self.pool.discard()
                    raise NetworkError(f"{method} {path}: {e}") from None
                # a reused keep-alive socket may have been closed
                # server-side between requests; replay once on a fresh
                # connection
                conn = self.pool.replace()
                try:
                    status, resp_headers, payload = self._roundtrip(
                        conn, method, path, data, headers)
                except (http.client.HTTPException, OSError) as e2:
                    self.pool.discard()
                    raise NetworkError(f"{method} {path}: {e2}") from None
        finally:
            self.pool.request_finished()
        if status >= 400:
            raise _map_status(method, path, status, resp_headers,
                              payload.decode(errors="replace")[:500])
        return json.loads(payload) if payload else {}

    def _roundtrip(self, conn, method: str, path: str, data, headers):
        conn.request(method, path, body=data, headers=headers)
        resp = conn.getresponse()
        payload = resp.read()  # full drain keeps the connection reusable
        return resp.status, resp.headers, payload

    # -- KubeClient -------------------------------------------------------
    def server_version(self) -> dict | None:
        """GET /version, cached for the client's lifetime (the apiserver
        build does not change under a running operator; an upgraded control
        plane restarts our watches anyway)."""
        if getattr(self, "_server_version", None) is None:
            try:
                self._server_version = self._request("GET", "/version")
            except KubeError as e:
                log.warning("server version probe failed: %s", e)
                return None
        return self._server_version

    def get(self, kind, name, namespace=None) -> Obj:
        raw = self._request("GET", self._path(kind, namespace, name))
        raw.setdefault("kind", kind)
        return Obj(raw)

    def list(self, kind, namespace=None, label_selector=None) -> list[Obj]:
        query = {}
        if label_selector:
            query["labelSelector"] = _selector_str(label_selector)
        path = self._collection_path(kind, namespace, query)
        body = self._request("GET", path)
        out = []
        for item in body.get("items", []):
            item.setdefault("kind", kind)
            out.append(Obj(item))
        return out

    def create(self, obj: Obj) -> Obj:
        raw = dict(obj.raw, apiVersion=obj.api_version)
        return Obj(self._request(
            "POST", self._path(obj.kind, obj.namespace, None), raw))

    def update(self, obj: Obj) -> Obj:
        raw = dict(obj.raw, apiVersion=obj.api_version)
        return Obj(self._request(
            "PUT", self._path(obj.kind, obj.namespace, obj.name), raw))

    def update_status(self, obj: Obj) -> Obj:
        raw = dict(obj.raw, apiVersion=obj.api_version)
        return Obj(self._request(
            "PUT", self._path(obj.kind, obj.namespace, obj.name, "status"), raw))

    def patch(self, kind, name, namespace=None, patch=None,
              subresource=None) -> Obj:
        """Server-side RFC 7386 JSON merge patch — no read-modify-write
        race, and the server's admission/pruning applies to the merged
        object (what a real apiserver does for kubectl patch)."""
        raw = self._request(
            "PATCH", self._path(kind, namespace, name, subresource),
            patch or {}, content_type="application/merge-patch+json")
        raw.setdefault("kind", kind)
        return Obj(raw)

    def delete(self, kind, name, namespace=None, ignore_missing=True) -> None:
        try:
            self._request("DELETE", self._path(kind, namespace, name))
        except NotFoundError:
            if not ignore_missing:
                raise

    def watch(self, kind, namespace=None, label_selector=None,
              timeout_s=300.0, resource_version=None):
        """Server-side watch: chunked stream of newline-delimited watch
        events (BOOKMARK events included so callers can resume). Returns
        when the server closes the stream (timeoutSeconds); callers loop to
        re-watch, passing the last seen resourceVersion to avoid the
        full ADDED replay. A GoneError means the version is too old —
        clear it and re-list/re-watch."""
        query = {"watch": "1", "timeoutSeconds": str(int(timeout_s)),
                 "allowWatchBookmarks": "true"}
        if label_selector:
            query["labelSelector"] = _selector_str(label_selector)
        if resource_version:
            query["resourceVersion"] = str(resource_version)
        path = self._collection_path(kind, namespace, query)
        req = urllib.request.Request(
            self.base + path,
            headers={"Authorization": f"Bearer {self.token}",
                     "Accept": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s + 30,
                                        context=self.ctx) as resp:
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    evt = json.loads(line)
                    etype = evt.get("type")
                    raw = evt.get("object") or {}
                    if etype == "ERROR" or etype is None:
                        if (raw.get("code") == 410
                                or "too old" in str(raw.get("message", ""))):
                            raise GoneError(f"watch {kind}: resourceVersion "
                                            "expired")
                        # surface as an error so callers back off — a bare
                        # return is indistinguishable from a healthy timeout
                        # and would be re-watched in a tight loop
                        raise KubeError(
                            f"watch {kind}: server error event: "
                            f"{raw.get('message', raw)}")
                    raw.setdefault("kind", kind)
                    yield etype, Obj(raw)
        except urllib.error.HTTPError as e:
            if e.code == 410:
                raise GoneError(f"watch {kind}: HTTP 410") from None
            raise _map_http_error("watch", kind, e) from None
        except GoneError:
            raise
        except KubeError:
            raise
        except Exception as e:
            # chunked streams die in many shapes (IncompleteRead, URLError,
            # decode errors on a torn line…) — all mean the same thing to the
            # caller: stream broke, re-watch; typed transient so retry
            # policy treats a torn stream like any other wire failure
            raise NetworkError(f"watch {kind}: {e}") from None

    def _collection_path(self, kind, namespace, query: dict) -> str:
        """Collection URL for list/watch; cluster-wide for namespaced kinds
        when no namespace is given."""
        info = gvr_for(kind)
        if info.namespaced and namespace is None:
            if "/" in info.api_version:
                group, version = info.api_version.split("/", 1)
                path = f"/apis/{group}/{version}/{info.plural}"
            else:
                path = f"/api/{info.api_version}/{info.plural}"
            if query:
                path += "?" + urllib.parse.urlencode(query)
            return path
        ns = namespace if info.namespaced else None
        return self._path(kind, ns, None, query=query)
