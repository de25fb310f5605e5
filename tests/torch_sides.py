"""Run one scenario on the reference and on the port, and compare.

A scenario is written once, in the reference's names: it takes a
``Side`` and builds its inputs through ``side.tr`` (identity for the
reference, ``torch_names.to_port`` with ``NODE_MAP`` for the port), calls
the side's modules (``side.mod("controllers.upgrade_controller")`` is
``tpu_operator.controllers.upgrade_controller`` or its port), and returns
a record of what it observed. ``both(scenario)`` runs it on each side and
returns the reference's record mapped onto the port's names beside the
port's own; a parity test asserts the two are equal.

``canon`` drops what no two runs share: wall-clock stamps and the
per-write serials the fake cluster hands out.
"""

from __future__ import annotations

import importlib
import json
import re

from torch_names import to_port

#: the reference's node facts → the port's, applied before the name map:
#: accelerator types are GPU products, a GKE topology is NFD's PCI label
H100 = "NVIDIA-H100-80GB-HBM3"
A100 = "NVIDIA-A100-SXM4-80GB"
NODE_MAP = ((r'-tpu-v5p-slice"', '-nvidia-h100-80gb-hbm3"'),
            (r'-tpu-v5-lite-podslice"', '-nvidia-a100-sxm4-80gb"'),
            (r"tpu-v5p-slice", H100), (r"tpu-v5-lite-podslice", A100),
            (r'"2x2x1"', '"true"'), (r'"2x4"', '"true"'))

#: annotations and fields that hold a wall-clock time
_STAMPS = ("lastTransitionTime", "firstTimestamp", "lastTimestamp",
           "creationTimestamp", "resourceVersion", "uid", "renewTime",
           "acquireTime", "nvidia.com/upgrade-drain-start",
           "tpu.dev/upgrade-drain-start")


class Side:
    def __init__(self, name: str):
        assert name in ("r", "p")
        self.name = name
        self.port = name == "p"
        self.pkg = "tpu_operator_torch" if self.port else "tpu_operator"
        self.ns = "gpu-operator" if self.port else "tpu-operator"

    def tr(self, x, extra=()):
        """A value written in the reference's names, in this side's."""
        return to_port(x, (*extra, *NODE_MAP)) if self.port else x

    def mod(self, path: str):
        return importlib.import_module(f"{self.pkg}.{path}")

    @property
    def kube(self):
        return self.mod("kube")

    @property
    def Policy(self):
        api = self.mod("api.v1alpha1")
        return api.GPUClusterPolicy if self.port else api.TPUClusterPolicy

    def policy(self, spec=None, name="p"):
        return self.Policy.from_obj(self.tr({
            "apiVersion": "tpu.dev/v1alpha1", "kind": "TPUClusterPolicy",
            "metadata": {"name": name}, "spec": spec or {}}))

    def obj(self, raw):
        return self.kube.Obj(self.tr(raw))


def canon(x):
    """``x`` (anything JSON holds) without the fields of ``_STAMPS``."""
    if isinstance(x, dict):
        return {k: canon(v) for k, v in x.items() if k not in _STAMPS}
    if isinstance(x, (list, tuple)):
        return [canon(v) for v in x]
    return x


def sort_lists(x, keys=("events", "writes")):
    """``x`` with the lists under ``keys`` sorted (records whose order
    follows names, which differ between the copies, or a concurrent
    walk)."""
    if isinstance(x, dict):
        return {k: sorted(v, key=lambda e: json.dumps(e, sort_keys=True))
                if k in keys and isinstance(v, list) else sort_lists(v, keys)
                for k, v in x.items()}
    if isinstance(x, list):
        return [sort_lists(v, keys) for v in x]
    return x


_NOT_READY = re.compile(r"(states not ready: )([\w, -]+)")


def sort_not_ready(text: str) -> str:
    """The reconciler's "states not ready: a, b" with the names sorted:
    the reference sorts its own names, which the map reorders."""
    return _NOT_READY.sub(lambda m: m.group(1) + ", ".join(
        sorted(m.group(2).split(", "))), text)


def both(scenario, *args, extra=(), **kw):
    """(the reference's record in the port's names, the port's record),
    each with its event and write lists sorted."""
    ref = scenario(Side("r"), *args, **kw)
    port = scenario(Side("p"), *args, **kw)
    ref = json.loads(sort_not_ready(json.dumps(
        to_port(canon(ref), (*extra, *NODE_MAP)))))
    port = json.loads(sort_not_ready(json.dumps(canon(port))))
    return sort_lists(ref), sort_lists(port)


#: metric families whose values are wall-clock durations or stamps
TIMED_FAMILIES = re.compile(
    r"(duration_seconds|apply_seconds|lookup_seconds|last_success_ts|"
    r"build_info|_bucket\{|_sum\b|_sum\{)")


def samples(registry, keep=None) -> dict:
    """{sample line's name and labels: value} of a Prometheus registry,
    without HELP/TYPE lines (prose differs between the copies) and without
    wall-clock families; ``keep`` (a regex) narrows to matching names."""
    out = {}
    for line in registry.render().splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        if TIMED_FAMILIES.search(key):
            continue
        if keep is not None and not re.search(keep, key):
            continue
        out[key] = float(value)
    return out


def node_view(client, name) -> dict:
    """What the controllers own on a node: its labels, annotations,
    schedulability and taints."""
    n = client.get("Node", name)
    return {"labels": dict(n.labels), "annotations": dict(n.annotations),
            "unschedulable": bool(n.get("spec", "unschedulable",
                                        default=False)),
            "taints": n.get("spec", "taints", default=[]) or []}
