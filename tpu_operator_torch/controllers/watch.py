"""Event-driven wakeups for the level-triggered reconcile loop.

The port of ``tpu_operator/controllers/watch.py``. A node event matters
when it touches a GPU detection label, an ``nvidia.com/gpu*`` capacity or
the ``nvidia.com/gpu.product`` label the driver fans out on (the
reference's fan-out key is one of its detection labels).

Reference analogue: the controller-runtime watches wired in
SetupWithManager (clusterpolicy_controller.go:316-347) — watch the
ClusterPolicy, Node label changes (addWatchNewGPUNode predicates :220-314),
and owned DaemonSets. The reconcile itself stays level-triggered and polled;
watches only cut the latency between a cluster change and the next pass from
the requeue interval to ~instant. If the client has no watch support (or the
stream breaks), the trigger silently degrades to pure polling.
"""

from __future__ import annotations

import logging
import random
import threading
import time

from tpu_operator_torch.kube.client import KubeClient, KubeError
from tpu_operator_torch.kube.objects import Obj
from .state_manager import (DETECTION_LABELS, GPU_PRESENT_LABEL,
                            GPU_RESOURCE_PREFIXES, OPERANDS_LABEL,
                            PRODUCT_LABEL, SLICE_CONFIG_LABEL,
                            WORKLOAD_CONFIG_LABEL)

log = logging.getLogger("gpu-operator")

_RELEVANT_PREFIXES = ("nvidia.com/gpu.deploy.",)

# watch reconnect backoff envelope (decorrelated jitter, see _next_backoff)
WATCH_BACKOFF_BASE_S = 1.0
WATCH_BACKOFF_CAP_S = 30.0


def _next_backoff(rng: random.Random, prev: float,
                  base: float = WATCH_BACKOFF_BASE_S,
                  cap: float = WATCH_BACKOFF_CAP_S) -> float:
    """Decorrelated jitter (the AWS-architecture-blog variant):
    ``min(cap, U(base, prev*3))``. A bare ``backoff*2`` doubling keeps every
    watcher of a restarted apiserver in lockstep — all three streams (and
    every operator replica) reconnect in the same instant, a thundering
    herd the jitter spreads out while keeping the same exponential reach."""
    return min(cap, rng.uniform(base, max(base, prev * 3)))
_RELEVANT_LABELS = frozenset(
    (*DETECTION_LABELS, GPU_PRESENT_LABEL, WORKLOAD_CONFIG_LABEL,
     SLICE_CONFIG_LABEL, OPERANDS_LABEL, PRODUCT_LABEL))


def node_event_relevant(event_type: str, node: Obj) -> bool:
    """Mirror the reference's node predicates: only GPU-relevant node events
    wake the loop (create/delete of any node counts — a new node may be a GPU
    node the operator must label; label-only noise on CPU nodes does not)."""
    if event_type in ("ADDED", "DELETED"):
        return True
    labels = node.labels or {}
    if any(k in _RELEVANT_LABELS for k in labels):
        return True
    if any(k.startswith(p) for k in labels for p in _RELEVANT_PREFIXES):
        return True
    capacity = node.get("status", "capacity", default={}) or {}
    return any(r.startswith(p) for r in capacity
               for p in GPU_RESOURCE_PREFIXES)


class WatchTrigger:
    """Background watch streams that set an event when a reconcile-relevant
    change lands. ``wait(timeout)`` replaces the loop's sleep."""

    def __init__(self, client: KubeClient, namespace: str):
        self.client = client
        self.namespace = namespace
        self._event = threading.Event()
        self._stop = threading.Event()
        self.supported = True

    def start(self):
        targets = [
            ("GPUClusterPolicy", None, None),
            ("Node", None, None),
            ("DaemonSet", self.namespace, None),  # owned operands
        ]
        for kind, ns, selector in targets:
            threading.Thread(target=self._loop, args=(kind, ns, selector),
                             daemon=True,
                             name=f"watch-{kind.lower()}").start()
        return self

    def stop(self):
        self._stop.set()

    def wait(self, timeout: float) -> bool:
        """Block up to ``timeout`` for an event; clears it. True = woken."""
        woken = self._event.wait(timeout)
        self._event.clear()
        return woken

    def drain(self, quiet_s: float = 0.05, max_s: float = 1.0) -> None:
        """Coalesce an event burst after a wake: keep clearing the trigger
        until ``quiet_s`` passes with no new event (or ``max_s`` total).
        A single event costs one ``quiet_s`` wait instead of the old fixed
        1 s debounce sleep; a burst (node pool scale-up, rollout) still
        collapses into one reconcile pass."""
        deadline = time.monotonic() + max_s
        while time.monotonic() < deadline:
            if not self._event.wait(min(quiet_s,
                                        deadline - time.monotonic())):
                return  # quiet window elapsed — burst over
            self._event.clear()

    # -- internals --------------------------------------------------------
    def _node_signature(self, node: Obj) -> tuple:
        """The parts of a node the reconciler actually reads — label/capacity
        churn outside this set (kubelet status heartbeats, image lists) must
        not wake the loop."""
        labels = node.labels or {}
        relevant = {k: v for k, v in labels.items()
                    if k in _RELEVANT_LABELS
                    or any(k.startswith(p) for p in _RELEVANT_PREFIXES)}
        capacity = node.get("status", "capacity", default={}) or {}
        gpu_cap = {k: v for k, v in capacity.items()
                   if k.startswith(GPU_RESOURCE_PREFIXES)}
        return (tuple(sorted(relevant.items())),
                tuple(sorted(gpu_cap.items())),
                bool(node.get("spec", "unschedulable", default=False)))

    def _node_changed(self, etype: str, obj: Obj, seen: dict) -> bool:
        """Predicate + old-vs-new diff (the reference predicates compare old
        and new labels on update, clusterpolicy_controller.go:247-306; a
        watch only delivers the new object, so the old state is cached)."""
        if etype == "DELETED":
            seen.pop(obj.name, None)
            return True
        if obj.name not in seen and not node_event_relevant(etype, obj):
            return False  # untracked node, nothing GPU-shaped on it
        # tracked nodes always go through the signature diff — a MODIFIED
        # that STRIPS all GPU labels is exactly a change we must see
        sig = self._node_signature(obj)
        changed = seen.get(obj.name) != sig
        seen[obj.name] = sig
        return changed

    def _ds_changed(self, etype: str, obj: Obj, seen: dict) -> bool:
        """DaemonSet events matter when the SPEC changed (our hash
        annotation) or the object appeared/vanished — rollout status churn
        (numberReady ticking up during pod restarts) must not wake a
        converged loop. Readiness itself is re-checked by the requeue pass."""
        if etype == "DELETED":
            seen.pop(obj.name, None)
            return True
        from .object_controls import HASH_ANNOTATION
        sig = obj.annotations.get(HASH_ANNOTATION, "")
        changed = obj.name not in seen or seen[obj.name] != sig
        seen[obj.name] = sig
        return changed

    def _loop(self, kind: str, ns: str | None, selector):
        from tpu_operator_torch.kube.incluster import GoneError
        rng = random.Random()
        backoff = WATCH_BACKOFF_BASE_S
        rv = None
        seen_nodes: dict[str, tuple] = {}
        seen_ds: dict[str, str] = {}
        while not self._stop.is_set():
            try:
                for etype, obj in self.client.watch(kind, ns, selector,
                                                    timeout_s=300,
                                                    resource_version=rv):
                    backoff = WATCH_BACKOFF_BASE_S
                    rv = obj.resource_version or rv
                    if self._stop.is_set():
                        return
                    if etype == "BOOKMARK":
                        continue  # resume marker only
                    if kind == "Node" and \
                            not self._node_changed(etype, obj, seen_nodes):
                        continue
                    if kind == "DaemonSet" and \
                            not self._ds_changed(etype, obj, seen_ds):
                        continue
                    log.debug("watch: %s %s %s", etype, kind, obj.name)
                    self._event.set()
            except NotImplementedError:
                log.debug("client has no watch support; %s falls back to "
                          "polling", kind)
                self.supported = False
                return
            except GoneError:
                rv = None   # history expired: accept one replay burst
            except KubeError as e:
                log.debug("watch %s broke (%s); retrying in %.1fs",
                          kind, e, backoff)
                self._stop.wait(backoff)
                backoff = _next_backoff(rng, backoff)
            except Exception:
                # never let a watch thread die silently — degrade to retry
                log.exception("watch %s failed unexpectedly", kind)
                self._stop.wait(backoff)
                backoff = _next_backoff(rng, backoff)
