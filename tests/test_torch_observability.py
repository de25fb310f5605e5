"""The operator's Events (``controllers/events.py``) and metrics
(``controllers/metrics.py``) against the reference's.

``tests/test_observability.py``'s event and metric scenarios (``:197-294``)
run on both copies (``torch_sides``): the recorder's dedupe and its
best-effort drops, the upgrade FSM's moves, the reconciler's transition
Events, and the latency histograms a reconcile fills. Every family of
``OperatorMetrics`` must be the reference's under the ``gpu_operator_``
prefix, with the same type and labels.

The wire apiserver's server-side histogram (``:296``) waits for
``kube/apiserver.py``.
"""

import os
import re

import pytest

from torch_sides import both, samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GKE = {"cloud.google.com/gke-tpu-accelerator": "tpu-v5p-slice",
       "cloud.google.com/gke-tpu-topology": "2x2x1"}


@pytest.fixture(autouse=True)
def env_images(monkeypatch):
    for env in ("LIBTPU_INSTALLER_IMAGE", "RUNTIME_HOOK_IMAGE",
                "DRIVER_IMAGE", "CONTAINER_TOOLKIT_IMAGE",
                "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                "SLICE_MANAGER_IMAGE", "METRICS_AGENT_IMAGE",
                "METRICS_EXPORTER_IMAGE", "VALIDATOR_IMAGE"):
        monkeypatch.setenv(env, "reg/operand:v1")


def events(S, c, names=True):
    """``{"events": [...]}``, which ``both`` sorts; an Event's name carries
    a creation serial, which follows the order of names where the
    reconciler records transitions sorted by state."""
    return {"events": [
        {k: e.raw[k] for k in ("reason", "type", "message", "count",
                               "involvedObject", "source")}
        | ({"name": e.name} if names else {})
        for e in c.list("Event", S.ns)]}


def reconciler(S, **kw):
    c = S.kube.FakeClient(auto_ready=True)
    c.add_node("n1", S.tr(dict(GKE)))
    c.create(S.obj({"apiVersion": "tpu.dev/v1alpha1",
                    "kind": "TPUClusterPolicy",
                    "metadata": {"name": "p"}, "spec": {}}))
    assets = os.path.join(ROOT, "tpu_operator_torch", "assets") if S.port \
        else os.path.join(ROOT, "assets")
    return c, S.mod("controllers.clusterpolicy_controller").Reconciler(
        c, S.ns, assets, **kw)


# -- scenarios -------------------------------------------------------------------

def s_event_recorder_dedupe_and_best_effort(S):
    ev = S.mod("controllers.events")
    c = S.kube.FakeClient()
    r = ev.EventRecorder(c, S.ns)
    node = S.obj({"apiVersion": "v1", "kind": "Node",
                  "metadata": {"name": "n1"}})
    failed, draining = S.tr(["libtpu upgrade on n1: failed",
                             "libtpu upgrade on n1: draining"])
    r.warning(node, "UpgradeFailed", failed)
    r.warning(node, "UpgradeFailed", failed)
    r.normal(node, "UpgradeProgress", draining)
    r.normal({"kind": "Thing", "name": "x", "namespace": "ns"}, "R", "m")
    client = S.mod("kube.client")

    class Down:
        def get_or_none(self, *a, **k):
            return None

        def create(self, *a, **k):
            raise client.KubeError("events API down")
    r2 = ev.EventRecorder(Down(), S.ns)
    r2.normal(node, "X", "y")
    return [events(S, c), r.emitted, r.drops, r2.emitted, r2.drops]


def s_upgrade_fsm_moves_record_events(S):
    c = S.kube.FakeClient()
    c.add_node("n1", S.tr(dict(GKE)))
    rec = S.mod("controllers.events").EventRecorder(c, S.ns)
    m = S.mod("controllers.upgrade_controller")
    up = m.UpgradeController(c, S.ns, recorder=rec)
    node = c.get("Node", "n1")
    up._record_move(node, m.FAILED)
    up._record_move(node, "done")
    return events(S, c)


def s_ready_transitions_emit_normal_events_once(S):
    c, rec = reconciler(S)
    rec.reconcile()
    rec.reconcile()
    evs = events(S, c, names=False)
    assert evs["events"] and all(
        e["type"] == "Normal" and e["count"] == 1
        for e in evs["events"] if e["reason"] == "StateReady")
    return evs


def s_forced_state_failure_emits_warning_event(S):
    c, rec = reconciler(S)
    client = S.mod("kube.client")

    def boom():
        raise client.KubeError("state-device-plugin: apiserver exploded")
    rec.manager.run_all = boom
    out = [rec.reconcile().ready]
    rec.reconcile()
    return out + [events(S, c), samples(rec.metrics.registry,
                                        keep="reconciliation")]


def s_reconcile_fills_the_latency_histograms(S):
    c, rec = reconciler(S, cache=True)
    out = [rec.is_ready()]
    rec.reconcile()
    rec.reconcile()
    m = rec.metrics
    out += [rec.is_ready(), m.reconcile_seconds.get()]
    assert m.state_apply_duration.quantile_all(0.5) > 0.0
    assert m.api_request_seconds.quantile_all(0.99) > 0.0
    assert m.cache_lookup_seconds.quantile_all(0.5) > 0.0
    text = m.registry.render()
    counts = {}
    for fam in ("reconciliation_duration_seconds",
                "state_apply_duration_seconds",
                "api_request_duration_seconds", "cache_lookup_seconds"):
        name = next(n for n in re.findall(r"^# TYPE (\w+) histogram$", text,
                                          re.M) if n.endswith(fam))
        rows = [ln for ln in text.splitlines()
                if ln.startswith(f"{name}_bucket")]
        by_labels = {}
        for ln in rows:       # cumulative, monotone, +Inf == _count
            key = re.sub(r',?le="[^"]+"', "", ln.split(" ")[0])
            by_labels.setdefault(key, []).append(float(ln.split(" ")[1]))
        for key, cum in by_labels.items():
            assert cum == sorted(cum)
        counts[fam] = len(by_labels)
    return out + [counts]


SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_"))


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_events_and_metrics_match_the_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


def test_every_family_is_the_references_under_the_gpu_prefix():
    """Name, type and label names of every family, after the map; the
    same attributes on the object except the node-count pair."""
    from tpu_operator.controllers.metrics import OperatorMetrics as Ref
    from tpu_operator_torch.controllers.metrics import OperatorMetrics as Port
    from torch_names import to_port

    def families(m):
        return sorted([f.name, type(f).__name__, list(f.labelnames)]
                      for f in m.registry.families())
    ref, port = Ref(), Port()
    assert families(port) == sorted(to_port(families(ref)))
    assert all(n.startswith("gpu_operator_") for n, *_ in families(port))
    renamed = {"tpu_nodes_total": "gpu_nodes_total",
               "has_tpu_labels": "has_gpu_labels"}
    assert sorted(vars(port)) == sorted(renamed.get(k, k) for k in vars(ref))


def test_observe_sets_the_state_gauges_as_the_reference():
    def scenario(S):
        m = S.mod("controllers.metrics").OperatorMetrics()
        st = S.mod("api.v1alpha1").State
        m.observe({"state-libtpu": st.READY, "state-relay-service":
                   st.DISABLED, "state-device-plugin": st.NOT_READY}
                  if not S.port else
                  {"state-driver": st.READY, "state-relay-service":
                   st.DISABLED, "state-device-plugin": st.NOT_READY},
                  3, ready=False)
        m.observe({}, 3, ready=True)
        return samples(m.registry)
    ref, port = both(scenario)
    assert port == ref
    assert port["gpu_operator_gpu_nodes_total"] == 3
