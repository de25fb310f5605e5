"""The client interface both the real and fake clusters implement.

The port's copy of ``tpu_operator/kube/client.py``, which uses no device:
the port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

The reconcile code is written against this interface only — the same split
the reference gets from controller-runtime's client.Client + fake client
(SURVEY.md §4: all reconcile logic is tested against a fake cluster).
"""

from __future__ import annotations

from typing import Iterable

from .objects import Obj, merge_patch


class KubeError(Exception):
    pass


class NotFoundError(KubeError):
    pass


class AlreadyExistsError(KubeError):
    pass


class ConflictError(KubeError):
    """resourceVersion mismatch on update."""


# -- transient/permanent taxonomy ------------------------------------------
# The retry layer (kube/retry.py) retries exactly the TransientError
# subtree; everything else — NotFound, AlreadyExists, Conflict, admission
# rejections — is control flow the caller owns and retrying it would only
# mask bugs (client-go's IsRetryableError draws the same line).

class TransientError(KubeError):
    """A failure the caller may retry: the request was valid, the server
    (or the wire) just couldn't serve it right now. ``retry_after`` carries
    the server's Retry-After hint in seconds when one was sent."""

    def __init__(self, message: str, retry_after: float | None = None):
        super().__init__(message)
        self.retry_after = retry_after


class ThrottledError(TransientError):
    """HTTP 429: client-side flow control (API priority & fairness)."""


class ServerUnavailableError(TransientError):
    """HTTP 5xx: the apiserver is present but failing (500/502/503/504)."""


class NetworkError(TransientError):
    """The wire itself failed: connect refused/reset, DNS, timeout — no
    HTTP status ever arrived."""


class KubeClient:
    def get(self, kind: str, name: str, namespace: str | None = None) -> Obj:
        raise NotImplementedError

    def list(self, kind: str, namespace: str | None = None,
             label_selector: str | dict | None = None) -> list[Obj]:
        raise NotImplementedError

    def create(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def update(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def update_status(self, obj: Obj) -> Obj:
        raise NotImplementedError

    def delete(self, kind: str, name: str, namespace: str | None = None,
               ignore_missing: bool = True) -> None:
        raise NotImplementedError

    def patch(self, kind: str, name: str, namespace: str | None = None,
              patch: dict | None = None, subresource: str | None = None) -> Obj:
        """RFC 7386 merge patch. Backends with native PATCH override this;
        the base implementation falls back to read-modify-write so every
        client supports the verb (the incremental node-label path depends
        on it)."""
        current = self.get(kind, name, namespace)
        merged = Obj(merge_patch(current.raw, patch or {}))
        if subresource == "status":
            return self.update_status(merged)
        return self.update(merged)

    def watch(self, kind: str, namespace: str | None = None,
              label_selector: str | dict | None = None,
              timeout_s: float = 300.0, resource_version: str | None = None):
        """Yield (event_type, Obj) pairs — ADDED/MODIFIED/DELETED — until
        ``timeout_s`` elapses, then return (callers re-watch). Optional
        capability: implementations without event support raise
        NotImplementedError and callers fall back to requeue polling
        (reference analogue: the controller-runtime watches of
        clusterpolicy_controller.go:316-347 layered over the same
        level-triggered Reconcile)."""
        raise NotImplementedError

    # -- conveniences shared by both implementations ----------------------
    def server_version(self) -> dict | None:
        """Raw ``/version`` payload (major/minor/gitVersion) or None when the
        backend has no server to ask (reference analogue: kube/OpenShift
        version detection, state_manager.go:169-210)."""
        return None

    def get_or_none(self, kind: str, name: str,
                    namespace: str | None = None) -> Obj | None:
        try:
            return self.get(kind, name, namespace)
        except NotFoundError:
            return None

    def apply(self, obj: Obj) -> Obj:
        """Create-or-update (reference: the Create-then-Update-on-exists
        pattern, object_controls.go:506-518). Caller decides *whether* an
        update is needed (hash annotation); this just resolves the verb."""
        existing = self.get_or_none(obj.kind, obj.name, obj.namespace)
        if existing is None:
            try:
                return self.create(obj)
            except AlreadyExistsError:
                existing = self.get(obj.kind, obj.name, obj.namespace)
        obj.metadata["resourceVersion"] = existing.resource_version
        return self.update(obj)

    def delete_all(self, objs: Iterable[Obj]) -> None:
        for o in objs:
            self.delete(o.kind, o.name, o.namespace)
