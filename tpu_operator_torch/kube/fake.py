"""In-memory fake cluster — the unit-test backbone.

The port's copy of ``tpu_operator/kube/fake.py``, which uses no device: the
port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Mirrors the role of controller-runtime's fake client in the reference
(controllers/object_controls_test.go:226-227): reconcile logic runs unmodified
against it; tests fabricate nodes with the minimum TPU labels the same way the
reference's ``newCluster()`` fabricates NFD-labeled GPU nodes
(object_controls_test.go:224-254).

Beyond plain storage it models the few API-server behaviors the operator
depends on:
- resourceVersion bump on every write + conflict detection on stale updates
- label-selector list
- DaemonSet status: new DaemonSets start NotReady; ``set_node_count`` +
  ``mark_daemonsets_ready`` (or ``auto_ready=True``) simulate rollout so the
  state machine can reach Ready in tests
- status subresource isolation (update() cannot change .status)
"""

from __future__ import annotations

import fcntl
import itertools
import json
import os
import queue
import threading
import time

from .client import (AlreadyExistsError, ConflictError, KubeClient,
                     NotFoundError)
from .objects import Obj, gvr_for, merge_patch
from .selectors import match_labels, match_node_affinity


class FakeClient(KubeClient):
    """Thread-safe: every verb takes the store RLock for its whole
    read-copy or copy-write cycle and hands out deep copies only, so the
    DAG scheduler's concurrent per-state applies serialize exactly like
    API-server writes (conflict detection included). The ``actions`` /
    ``reads`` audit trails are appended under the same lock.

    Copy-on-write store invariant (the fine-grained-lock audit for
    shard-parallel writers): a raw dict, once stored, is NEVER mutated in
    place — every write builds a fresh raw (fresh ``metadata``) and
    replaces the store entry wholesale through ``_put``. That makes object
    identity a change detector (``old_raw is new_raw`` ⇔ unchanged) and
    lets subclasses snapshot raw references under the lock and deepcopy
    them outside it without torn reads."""

    def __init__(self, auto_ready: bool = False):
        self._store: dict[tuple, dict] = {}
        self._rv = itertools.count(1)
        self._uid = itertools.count(1)
        self._lock = threading.RLock()
        self.auto_ready = auto_ready
        self.actions: list[tuple] = []  # (verb, kind, ns, name) audit trail
        self.reads: list[tuple] = []    # (verb, kind, name-or-None) trail —
        #                                 what the read-through cache saves
        self._watchers: list[dict] = []  # {q, kind, ns, selector}
        # tests override to model older/flavored control planes
        self.version = {"major": "1", "minor": "29",
                        "gitVersion": "v1.29.0-fake"}

    def server_version(self) -> dict | None:
        return self.version

    # -- internals --------------------------------------------------------
    def _key(self, kind, name, namespace):
        if gvr_for(kind).namespaced and not namespace:
            raise ValueError(f"{kind} is namespaced; namespace required")
        if not gvr_for(kind).namespaced:
            namespace = None
        return (kind, namespace or "", name)

    def _bump(self, raw: dict):
        raw.setdefault("metadata", {})["resourceVersion"] = str(next(self._rv))

    def _put(self, key: tuple, raw: dict):
        """Single store-mutation point (subclass hook: SimCluster maintains
        its Node label index here). Caller holds the lock."""
        self._store[key] = raw

    def _remove(self, key: tuple) -> dict:
        """Single store-removal point (subclass index hook)."""
        return self._store.pop(key)

    # -- KubeClient -------------------------------------------------------
    def get(self, kind, name, namespace=None) -> Obj:
        with self._lock:
            key = self._key(kind, name, namespace)
            self.reads.append(("get", kind, name))
            if key not in self._store:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            return Obj(self._store[key]).deepcopy()

    def list(self, kind, namespace=None, label_selector=None) -> list[Obj]:
        with self._lock:
            self.reads.append(("list", kind, None))
            out = []
            for (k, ns, _), raw in sorted(self._store.items()):
                if k != kind:
                    continue
                if namespace and ns != namespace:
                    continue
                if match_labels(raw.get("metadata", {}).get("labels"),
                                label_selector):
                    out.append(Obj(raw).deepcopy())
            return out

    def create(self, obj: Obj) -> Obj:
        with self._lock:
            key = self._key(obj.kind, obj.name, obj.namespace)
            if key in self._store:
                raise AlreadyExistsError(f"{obj.kind} {obj.name} exists")
            raw = obj.deepcopy().raw
            raw.setdefault("metadata", {}).setdefault(
                "uid", f"uid-{next(self._uid)}")
            self._bump(raw)
            if obj.kind == "DaemonSet":
                self._init_daemonset_status(raw)
            self._put(key, raw)
            self.actions.append(("create", obj.kind, obj.namespace, obj.name))
            self._notify("ADDED", raw)
            return Obj(raw).deepcopy()

    def update(self, obj: Obj) -> Obj:
        with self._lock:
            key = self._key(obj.kind, obj.name, obj.namespace)
            if key not in self._store:
                raise NotFoundError(f"{obj.kind} {obj.name} not found")
            current = self._store[key]
            sent_rv = obj.resource_version
            if sent_rv and sent_rv != current["metadata"].get("resourceVersion"):
                raise ConflictError(
                    f"{obj.kind} {obj.name}: stale resourceVersion")
            raw = obj.deepcopy().raw
            # status is a subresource: spec updates cannot touch it
            if "status" in current:
                raw["status"] = current["status"]
            raw["metadata"].setdefault("uid", current["metadata"].get("uid"))
            self._bump(raw)
            if obj.kind == "DaemonSet":
                self._init_daemonset_status(raw)
            self._put(key, raw)
            self.actions.append(("update", obj.kind, obj.namespace, obj.name))
            self._notify("MODIFIED", raw)
            return Obj(raw).deepcopy()

    def update_status(self, obj: Obj) -> Obj:
        with self._lock:
            key = self._key(obj.kind, obj.name, obj.namespace)
            if key not in self._store:
                raise NotFoundError(f"{obj.kind} {obj.name} not found")
            current = self._store[key]
            # same optimistic concurrency as update(): a status writer that
            # read the object must not silently clobber a concurrent
            # writer's status (the apiserver's PATCH retry relies on this)
            sent_rv = obj.resource_version
            if sent_rv and sent_rv != current["metadata"].get("resourceVersion"):
                raise ConflictError(
                    f"{obj.kind} {obj.name}: stale resourceVersion")
            # copy-on-write: the stored raw is shared (snapshot readers,
            # identity-based memos) — replace it, never edit it in place
            new = dict(current)
            new["metadata"] = dict(current.get("metadata") or {})
            new["status"] = obj.deepcopy().raw.get("status") or {}
            self._bump(new)
            self._put(key, new)
            self.actions.append(
                ("update_status", obj.kind, obj.namespace, obj.name))
            self._notify("MODIFIED", new)
            return Obj(new).deepcopy()

    def patch(self, kind, name, namespace=None, patch=None,
              subresource=None) -> Obj:
        """Server-side RFC 7386 merge patch — no resourceVersion needed,
        and the subresource isolation matches update()/update_status():
        a plain patch cannot touch .status, a status patch touches only it."""
        with self._lock:
            key = self._key(kind, name, namespace)
            if key not in self._store:
                raise NotFoundError(f"{kind} {namespace or ''}/{name} not found")
            current = self._store[key]
            merged = merge_patch(current, patch or {})
            if subresource == "status":
                # copy-on-write (see update_status): fresh raw + metadata
                new = dict(current)
                new["metadata"] = dict(current.get("metadata") or {})
                new["status"] = merged.get("status") or {}
                self._bump(new)
                self._put(key, new)
                self.actions.append(("patch", kind, namespace, name))
                self._notify("MODIFIED", new)
                return Obj(new).deepcopy()
            if "status" in current:
                merged["status"] = current["status"]
            # merge_patch shares untouched branches with `current`: a patch
            # that never touched metadata would alias the stored raw's
            # metadata dict, and _bump would then mutate it in place —
            # always give the merged raw its own metadata dict
            merged["metadata"] = dict(merged.get("metadata") or {})
            merged["metadata"].setdefault(
                "uid", current.get("metadata", {}).get("uid"))
            self._bump(merged)
            if kind == "DaemonSet":
                self._init_daemonset_status(merged)
            self._put(key, merged)
            self.actions.append(("patch", kind, namespace, name))
            self._notify("MODIFIED", merged)
            return Obj(merged).deepcopy()

    def delete(self, kind, name, namespace=None, ignore_missing=True) -> None:
        with self._lock:
            key = self._key(kind, name, namespace)
            if key not in self._store:
                if ignore_missing:
                    return
                raise NotFoundError(f"{kind} {name} not found")
            gone = self._remove(key)
            self.actions.append(("delete", kind, namespace, name))
            # a delete is a new cluster mutation: the DELETED event carries
            # a fresh resourceVersion (apiserver semantics; a watcher
            # resuming from the pre-delete rv must still see it). Bump a
            # copy — a snapshot reader may still hold the popped raw.
            event = dict(gone)
            event["metadata"] = dict(gone.get("metadata") or {})
            self._bump(event)
            self._notify("DELETED", event)

    # -- watch ------------------------------------------------------------
    def _notify(self, event_type: str, raw: dict):
        obj_kind = raw.get("kind")
        labels = raw.get("metadata", {}).get("labels")
        ns = raw.get("metadata", {}).get("namespace")
        for w in list(self._watchers):
            if w["kind"] != obj_kind:
                continue
            if w["ns"] and ns != w["ns"]:
                continue
            if not match_labels(labels, w["selector"]):
                continue
            w["q"].put((event_type, Obj(raw).deepcopy()))

    def watch(self, kind, namespace=None, label_selector=None,
              timeout_s=300.0, resource_version=None):
        """Stream mutations as they happen — the fake analogue of an API
        watch (``resource_version`` accepted for interface parity; the fake
        never replays history, so there is nothing to skip). Events fire for
        in-process writes only (the file-backed subclass's cross-process
        writers are invisible; callers keep their polling fallback)."""
        w = {"q": queue.Queue(), "kind": kind, "ns": namespace,
             "selector": label_selector}
        with self._lock:
            self._watchers.append(w)
        deadline = time.monotonic() + timeout_s
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return
                try:
                    yield w["q"].get(timeout=remaining)
                except queue.Empty:
                    return
        finally:
            with self._lock:
                if w in self._watchers:
                    self._watchers.remove(w)

    # -- test scaffolding -------------------------------------------------
    def _init_daemonset_status(self, raw: dict):
        """New/updated DaemonSets roll out across matching nodes; NotReady
        until marked (reference readiness gate: isDaemonSetReady,
        object_controls.go:2961-2976 — NumberUnavailable must be 0)."""
        tmpl_spec = raw.get("spec", {}).get("template", {}).get("spec", {})
        n = self._count_matching_nodes(tmpl_spec)
        ready = n if self.auto_ready else 0
        raw["status"] = {
            "desiredNumberScheduled": n,
            "numberReady": ready,
            "numberUnavailable": n - ready,
            "updatedNumberScheduled": n,
        }

    def _count_matching_nodes(self, tmpl_spec: dict) -> int:
        """Nodes a DaemonSet pod template schedules onto (subclass hook:
        SimCluster answers from its label specs without materializing)."""
        selector = tmpl_spec.get("nodeSelector", {})
        return len([o for o in self._iter_kind("Node")
                    if match_labels(o.get("metadata", {}).get("labels"),
                                    selector)
                    and match_node_affinity(
                        o.get("metadata", {}).get("labels"), tmpl_spec)])

    def _iter_kind(self, kind):
        return [raw for (k, _, _), raw in self._store.items() if k == kind]

    def mark_daemonsets_ready(self, *names: str):
        """Simulate successful rollout for all (or the named) DaemonSets."""
        with self._lock:
            for key in [k for k in self._store if k[0] == "DaemonSet"]:
                if names and key[2] not in names:
                    continue
                raw = self._store[key]
                # copy-on-write replacement (no rv bump — rollout progress
                # is kubelet-side scaffolding, not a spec mutation)
                st = dict(raw.get("status") or {})
                n = st.get("desiredNumberScheduled", 0)
                st.update(numberReady=n, numberUnavailable=0)
                new = dict(raw)
                new["status"] = st
                self._put(key, new)

    def add_node(self, name: str, labels: dict | None = None,
                 runtime: str = "containerd://1.7.0") -> Obj:
        """Fabricate a node (reference analogue: object_controls_test.go
        newCluster, :224-254)."""
        node = Obj({
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})},
            "status": {
                "nodeInfo": {"containerRuntimeVersion": runtime,
                             "kubeletVersion": "v1.29.0"},
                "capacity": {}, "allocatable": {},
            },
        })
        return self.create(node)


class FileBackedFakeClient(FakeClient):
    """Fake cluster persisted to a JSON file — lets separate processes (the
    operator CLI, the kubectl shim, e2e bash scripts) share one cluster, the
    way the reference's e2e harness shares a kind cluster (SURVEY.md §3.5).

    Every public operation re-reads the file under an exclusive flock and
    persists mutations before releasing it, so concurrent CLI invocations
    serialize like API-server writes.
    """

    def __init__(self, path: str, auto_ready: bool = False):
        # auto_ready defaults off: the harness observes the real notReady →
        # rollout → ready convergence, using wait-ready to play kubelet
        super().__init__(auto_ready=auto_ready)
        self.path = path
        self._lock_path = path + ".lock"

    # atomically run fn against the on-disk state
    def _with_file(self, fn, persist: bool):
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self._lock_path, "w") as lockf:
            fcntl.flock(lockf, fcntl.LOCK_EX)
            try:
                self._load()
                result = fn()
                if persist:
                    self._save()
                return result
            finally:
                fcntl.flock(lockf, fcntl.LOCK_UN)

    def _load(self):
        self._store.clear()
        if not os.path.exists(self.path):
            self._rv = itertools.count(1)
            self._uid = itertools.count(1)
            return
        with open(self.path) as f:
            state = json.load(f)
        for entry in state["objects"]:
            kind, ns, name = entry["key"]
            self._store[(kind, ns, name)] = entry["raw"]
        self._rv = itertools.count(state.get("rv", 1))
        self._uid = itertools.count(state.get("uid", 1))

    def _save(self):
        state = {
            "objects": [{"key": list(k), "raw": raw}
                        for k, raw in sorted(self._store.items())],
            "rv": next(self._rv),
            "uid": next(self._uid),
        }
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, self.path)

    # -- KubeClient over the file ----------------------------------------
    def get(self, kind, name, namespace=None):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .get(kind, name, namespace), persist=False)

    def list(self, kind, namespace=None, label_selector=None):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .list(kind, namespace, label_selector),
                               persist=False)

    def create(self, obj):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .create(obj), persist=True)

    def update(self, obj):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .update(obj), persist=True)

    def update_status(self, obj):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .update_status(obj), persist=True)

    def patch(self, kind, name, namespace=None, patch=None, subresource=None):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .patch(kind, name, namespace, patch,
                                      subresource), persist=True)

    def delete(self, kind, name, namespace=None, ignore_missing=True):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .delete(kind, name, namespace, ignore_missing),
                               persist=True)

    def mark_daemonsets_ready(self, *names):
        return self._with_file(lambda: super(FileBackedFakeClient, self)
                               .mark_daemonsets_ready(*names), persist=True)

    def add_node(self, name, labels=None, runtime="containerd://1.7.0"):
        # super().add_node calls self.create, which would deadlock on the
        # file lock; build the node here and create it once
        node = Obj({
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": {"name": name, "labels": dict(labels or {})},
            "status": {
                "nodeInfo": {"containerRuntimeVersion": runtime,
                             "kubeletVersion": "v1.29.0"},
                "capacity": {}, "allocatable": {},
            },
        })
        return self.create(node)
