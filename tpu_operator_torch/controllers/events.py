"""Kubernetes Event recorder: the durable, kubectl-visible reconcile story.

The port of ``tpu_operator/controllers/events.py``, with the operator's
name as the events' source component.

controller-runtime analogue (the reference operator records events through
``record.EventRecorder`` for state transitions and upgrade moves). Events
are namespaced v1 objects (kind registered in kube/objects.py); repeats of
the same (object, reason, message) bump ``count``/``lastTimestamp`` on the
existing Event instead of piling up new ones — the same dedupe a real
apiserver's event aggregator performs.

Recording is strictly best-effort: an operator must never fail a reconcile
because the events API hiccupped, so every KubeError is swallowed (and
counted on ``drops``).
"""

from __future__ import annotations

import logging
import threading
import time

from ..kube.client import KubeError
from ..kube.objects import Obj

log = logging.getLogger("gpu-operator.events")

TYPE_NORMAL = "Normal"
TYPE_WARNING = "Warning"

SOURCE_COMPONENT = "gpu-operator"


def _now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class EventRecorder:
    """Writes v1 Events through any KubeClient (fake, file-backed, wire)."""

    def __init__(self, client, namespace: str):
        self.client = client
        self.namespace = namespace
        self._lock = threading.Lock()
        # dedupe key -> event name, so a repeat bumps count in place
        self._seen: dict[tuple, str] = {}
        self._serial = 0
        self.emitted = 0
        self.drops = 0

    def normal(self, involved: Obj | dict, reason: str, message: str):
        self.event(involved, TYPE_NORMAL, reason, message)

    def warning(self, involved: Obj | dict, reason: str, message: str):
        self.event(involved, TYPE_WARNING, reason, message)

    def event(self, involved: Obj | dict, type_: str, reason: str,
              message: str):
        ref = self._object_ref(involved)
        key = (ref.get("kind"), ref.get("namespace", ""), ref.get("name"),
               type_, reason, message)
        with self._lock:
            existing = self._seen.get(key)
        try:
            if existing and self._bump(existing):
                return
            self._create(key, ref, type_, reason, message)
        except KubeError as e:
            self.drops += 1
            log.debug("event drop (%s/%s): %s", reason, ref.get("name"), e)

    # -- internals --------------------------------------------------------
    def _object_ref(self, involved) -> dict:
        if isinstance(involved, Obj):
            return {"apiVersion": involved.api_version,
                    "kind": involved.kind,
                    "name": involved.name,
                    **({"namespace": involved.namespace}
                       if involved.namespace else {})}
        return dict(involved)

    def _bump(self, name: str) -> bool:
        ev = self.client.get_or_none("Event", name, self.namespace)
        if ev is None:
            return False  # GC'd or never landed: fall through to create
        ev.raw["count"] = int(ev.raw.get("count", 1)) + 1
        ev.raw["lastTimestamp"] = _now_iso()
        self.client.update(ev)
        self.emitted += 1
        return True

    def _create(self, key: tuple, ref: dict, type_: str, reason: str,
                message: str):
        with self._lock:
            self._serial += 1
            name = (f"{(ref.get('name') or 'cluster')[:40]}."
                    f"{reason.lower()[:30]}.{self._serial}")
        now = _now_iso()
        self.client.create(Obj({
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {"name": name, "namespace": self.namespace},
            "involvedObject": ref,
            "reason": reason,
            "message": message,
            "type": type_,
            "count": 1,
            "firstTimestamp": now,
            "lastTimestamp": now,
            "source": {"component": SOURCE_COMPONENT},
        }))
        with self._lock:
            self._seen[key] = name
        self.emitted += 1
