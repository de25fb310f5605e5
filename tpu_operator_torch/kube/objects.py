"""Unstructured Kubernetes objects and the kind registry.

The port's copy of ``tpu_operator/kube/objects.py``, which uses no device:
the port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Design departure from the reference: the GPU operator decodes every manifest
into typed Go structs and keeps one controlFunc per concrete type
(controllers/resource_manager.go:35-53). A from-scratch Python operator gets
more leverage from the dynamic-client idiom — one ``Obj`` wrapper over the
parsed YAML dict, a kind registry for REST routing, and transforms that edit
nested fields directly. Behavior parity is preserved (same kinds supported,
same per-kind apply semantics in controllers/object_controls.py); the static
type layer is not, deliberately.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass


@dataclass(frozen=True)
class KindInfo:
    api_version: str
    plural: str
    namespaced: bool


# Every kind the operator manages (reference set: object_controls.go control
# functions; PodSecurityPolicy is intentionally absent — removed in k8s 1.25,
# replaced by Pod Security Admission namespace labels).
REGISTRY: dict[str, KindInfo] = {
    "Namespace": KindInfo("v1", "namespaces", False),
    "Node": KindInfo("v1", "nodes", False),
    "Pod": KindInfo("v1", "pods", True),
    "ConfigMap": KindInfo("v1", "configmaps", True),
    "Secret": KindInfo("v1", "secrets", True),
    "Service": KindInfo("v1", "services", True),
    "ServiceAccount": KindInfo("v1", "serviceaccounts", True),
    "Event": KindInfo("v1", "events", True),
    "DaemonSet": KindInfo("apps/v1", "daemonsets", True),
    "Deployment": KindInfo("apps/v1", "deployments", True),
    "Role": KindInfo("rbac.authorization.k8s.io/v1", "roles", True),
    "RoleBinding": KindInfo("rbac.authorization.k8s.io/v1", "rolebindings", True),
    "ClusterRole": KindInfo("rbac.authorization.k8s.io/v1", "clusterroles", False),
    "ClusterRoleBinding": KindInfo("rbac.authorization.k8s.io/v1",
                                   "clusterrolebindings", False),
    "RuntimeClass": KindInfo("node.k8s.io/v1", "runtimeclasses", False),
    "PriorityClass": KindInfo("scheduling.k8s.io/v1", "priorityclasses", False),
    "Lease": KindInfo("coordination.k8s.io/v1", "leases", True),
    "ServiceMonitor": KindInfo("monitoring.coreos.com/v1", "servicemonitors", True),
    "PrometheusRule": KindInfo("monitoring.coreos.com/v1", "prometheusrules", True),
    "TPUClusterPolicy": KindInfo("tpu.dev/v1alpha1", "tpuclusterpolicies", False),
    "CustomResourceDefinition": KindInfo("apiextensions.k8s.io/v1",
                                         "customresourcedefinitions", False),
}


def gvr_for(kind: str) -> KindInfo:
    try:
        return REGISTRY[kind]
    except KeyError:
        raise KeyError(f"unregistered kind: {kind!r}") from None


class Obj:
    """Thin wrapper over a manifest dict with path helpers.

    The raw dict stays authoritative (``obj.raw``); the wrapper only adds
    accessors, so round-tripping YAML → transform → API body is lossless.
    """

    def __init__(self, raw: dict):
        if "kind" not in raw:
            raise ValueError("object has no kind")
        self.raw = raw

    # -- identity ---------------------------------------------------------
    @property
    def kind(self) -> str:
        return self.raw["kind"]

    @property
    def api_version(self) -> str:
        return self.raw.get("apiVersion") or gvr_for(self.kind).api_version

    @property
    def name(self) -> str:
        return self.raw.get("metadata", {}).get("name", "")

    @property
    def namespace(self) -> str | None:
        return self.raw.get("metadata", {}).get("namespace")

    @property
    def key(self) -> tuple:
        return (self.kind, self.namespace or "", self.name)

    # -- metadata ---------------------------------------------------------
    @property
    def metadata(self) -> dict:
        return self.raw.setdefault("metadata", {})

    @property
    def labels(self) -> dict:
        return self.metadata.setdefault("labels", {})

    @property
    def annotations(self) -> dict:
        return self.metadata.setdefault("annotations", {})

    @property
    def resource_version(self) -> str | None:
        return self.metadata.get("resourceVersion")

    def set_namespace(self, ns: str) -> None:
        if gvr_for(self.kind).namespaced:
            self.metadata["namespace"] = ns

    def set_owner(self, owner: "Obj", controller: bool = True) -> None:
        """SetControllerReference analogue (reference: object_controls.go
        owner-ref wiring in each controlFunc)."""
        ref = {
            "apiVersion": owner.api_version,
            "kind": owner.kind,
            "name": owner.name,
            "uid": owner.metadata.get("uid", ""),
            "controller": controller,
            "blockOwnerDeletion": True,
        }
        refs = self.metadata.setdefault("ownerReferences", [])
        refs[:] = [r for r in refs if not r.get("controller")] + [ref]

    # -- nested access ----------------------------------------------------
    def get(self, *path, default=None):
        cur = self.raw
        for p in path:
            if isinstance(cur, dict):
                cur = cur.get(p)
            elif isinstance(cur, list) and isinstance(p, int) and p < len(cur):
                cur = cur[p]
            else:
                return default
            if cur is None:
                return default
        return cur

    def set(self, *path_and_value):
        *path, value = path_and_value
        cur = self.raw
        for p in path[:-1]:
            if isinstance(cur, list):
                cur = cur[p]  # int index into an existing list element
                continue
            nxt = cur.get(p)
            if nxt is None:
                nxt = cur[p] = {}
            cur = nxt
        cur[path[-1]] = value

    # -- misc -------------------------------------------------------------
    def deepcopy(self) -> "Obj":
        out = Obj(copy.deepcopy(self.raw))
        # the compile-time spec-hash memo (controllers/object_controls.py)
        # survives copies: the copy has byte-identical canonical content
        h = getattr(self, "_spec_hash", None)
        if h is not None:
            out._spec_hash = h
        return out

    def __repr__(self) -> str:
        ns = f"{self.namespace}/" if self.namespace else ""
        return f"<Obj {self.kind} {ns}{self.name}>"


def pod_template(obj: Obj) -> dict | None:
    """The pod template of a DaemonSet/Deployment/Pod — where most transforms
    operate (reference: preProcessDaemonSet, object_controls.go:639)."""
    if obj.kind in ("DaemonSet", "Deployment"):
        return obj.get("spec", "template")
    if obj.kind == "Pod":
        return obj.raw
    return None


def containers(obj: Obj, init: bool = False) -> list:
    tmpl = pod_template(obj)
    if tmpl is None:
        return []
    spec = tmpl.setdefault("spec", {})
    return spec.setdefault("initContainers" if init else "containers", [])


def find_container(obj: Obj, name: str, init: bool = False) -> dict | None:
    for c in containers(obj, init):
        if c.get("name") == name:
            return c
    return None


def set_env(container: dict, name: str, value: str) -> None:
    env = container.setdefault("env", [])
    for e in env:
        if e.get("name") == name:
            e["value"] = value
            e.pop("valueFrom", None)
            return
    env.append({"name": name, "value": value})


def get_env(container: dict, name: str):
    for e in container.get("env", []):
        if e.get("name") == name:
            return e.get("value")
    return None


def consumes_tpu(pod: Obj, resource_name: str = "tpu.dev/chip") -> bool:
    """Does any container request/limit a TPU resource? Shared by the
    upgrade drain and the slice-manager drain (reference analogue:
    gpuPodSpecFilter, main.go:161-183)."""
    for c in pod.get("spec", "containers", default=[]) or []:
        res = c.get("resources", {})
        merged = {**res.get("requests", {}), **res.get("limits", {})}
        if resource_name in merged or any(
                k.startswith("google.com/tpu") for k in merged):
            return True
    return False


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch: dicts merge recursively, null deletes,
    everything else replaces. The single implementation behind the wire
    apiserver's PATCH verb and the kubectl shim's client-side fallback."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    out = dict(target) if isinstance(target, dict) else {}
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out
