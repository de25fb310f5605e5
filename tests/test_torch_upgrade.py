"""The driver-upgrade FSM (``controllers/upgrade_controller.py``) against
the reference's libtpu-upgrade FSM.

Every scenario of ``tests/test_upgrade.py`` runs on both copies with the
same cluster, written in the reference's names and mapped onto the port's
(``torch_sides``): each pass's derived stages and counts, what each node
carries after it, and which pods are left must be equal after the name
map. An upgrade in the port is the per-product driver fan-out's pin
moving: the installer DaemonSets are ``gpu-driver-installer`` and its
``nvidia.com/driver.product`` clones, a node's own is the one of its
``nvidia.com/gpu.product``.

``test_pod_template_carries_hash`` (``object_controls.apply_idempotent``)
is held by ``test_torch_state_pipeline.py``.
"""

import time

import pytest

from torch_sides import both, node_view

OLD, NEW = "hash-old", "hash-new"
NODES = ("n1", "n2", "n3")
INSTALLER = "tpu-libtpu-installer"
VALIDATOR = "tpu-operator-validator"


def up(S):
    return S.mod("controllers.upgrade_controller")


def hash_key(S):
    return S.mod("controllers.object_controls").HASH_ANNOTATION


def policy(S, auto=True, parallel=1, max_unavailable="100%", drain=None):
    pol = S.policy({"upgradePolicy": {"autoUpgrade": auto,
                                      "maxParallelUpgrades": parallel,
                                      "maxUnavailable": max_unavailable}})
    if drain is not None:
        pol.spec.upgrade_policy.drain = drain
    return pol


def mk_pod(S, c, name, node, app=None, hash_=None, ready=True, ns=None,
           tpu_limit=None):
    ns = ns or "tpu-operator"
    raw = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns,
                        "labels": {"app": app} if app else {},
                        "annotations": {"HASH": hash_} if hash_ else {}},
           "spec": {"nodeName": node, "containers": [
               {"name": "c", "resources":
                   {"limits": {"tpu.dev/chip": tpu_limit}} if tpu_limit
                   else {}}]},
           "status": {"phase": "Running",
                      "conditions": [{"type": "Ready",
                                      "status": "True" if ready else "False"}]}}
    raw = S.tr(raw)
    anns = raw["metadata"]["annotations"]
    if "HASH" in anns:
        anns[hash_key(S)] = anns.pop("HASH")
    return c.create(S.kube.Obj(raw))


def mk_ds(S, c, name=INSTALLER, hash_=NEW, labels=None):
    raw = S.tr({"apiVersion": "apps/v1", "kind": "DaemonSet",
                "metadata": {"name": name, "namespace": "tpu-operator",
                             "labels": labels or {}, "annotations": {}},
                "spec": {"template": {"spec": {}}}})
    raw["metadata"]["annotations"][hash_key(S)] = hash_
    c.create(S.kube.Obj(raw))


def cluster(S):
    c = S.kube.FakeClient()
    mk_ds(S, c)
    for n in NODES:
        c.add_node(n, S.tr({"tpu.dev/chip.present": "true"}))
        mk_pod(S, c, f"installer-{n}", n, app=INSTALLER, hash_=OLD)
        mk_pod(S, c, f"validator-{n}", n, app=VALIDATOR)
    return c


def status(st) -> dict:
    return {"total": st.total, "done": st.done,
            "in_progress": st.in_progress, "waiting": st.waiting,
            "available": st.available, "failed": st.failed,
            "stages": dict(st.stages)}


def snapshot(S, c, nodes=NODES) -> dict:
    pods = sorted((p.namespace, p.name, p.annotations.get(hash_key(S)))
                  for p in c.list("Pod"))
    return {"nodes": {n: node_view(c, n) for n in nodes}, "pods": pods}


def cordoned(S, c):
    key = S.tr("tpu.dev/upgrade-cordoned")
    return [n.name for n in c.list("Node")
            if n.annotations.get(key) == "true"]


def crash(S, c, name, hash_=NEW):
    """The pod restarted at ``hash_`` and crash-loops."""
    p = c.get("Pod", name, S.ns)
    p.annotations[hash_key(S)] = hash_
    p = c.update(p)
    p.raw["status"]["containerStatuses"] = [
        {"name": "c", "state": {"waiting": {"reason": "CrashLoopBackOff"}}}]
    c.update_status(p)


# -- scenarios (tests/test_upgrade.py) -----------------------------------------

def s_disabled_is_noop_and_cleans_up(S):
    c = cluster(S)
    n = c.get("Node", "n1")
    n.labels[up(S).STATE_LABEL] = "validating"
    n.annotations[up(S).CORDONED_BY_US] = "true"
    n.set("spec", "unschedulable", True)
    c.update(n)
    st = up(S).UpgradeController(c, S.ns).reconcile(policy(S, auto=False))
    assert st.total == 0
    return [status(st), snapshot(S, c)]


def s_full_pipeline_single_node(S):
    m = up(S)
    c = S.kube.FakeClient()
    mk_ds(S, c)
    c.add_node("n1", S.tr({"tpu.dev/chip.present": "true"}))
    mk_pod(S, c, "installer-n1", "n1", app=INSTALLER, hash_=OLD)
    mk_pod(S, c, "validator-n1", "n1", app=VALIDATOR)
    mk_pod(S, c, "train", "n1", ns="default", tpu_limit="4")
    uc, pol = m.UpgradeController(c, S.ns), policy(S)
    rec = []
    for step in range(5):
        if step == 3:
            mk_pod(S, c, "installer-n1", "n1", app=INSTALLER, hash_=NEW)
            mk_pod(S, c, "validator-n1", "n1", app=VALIDATOR)
        st = uc.reconcile(pol)
        rec.append([status(st), snapshot(S, c, ("n1",))])
    assert rec[1][0]["stages"]["n1"] == m.POD_RESTART
    assert rec[2][0]["stages"]["n1"] == m.VALIDATING
    assert rec[4][0]["stages"]["n1"] == m.DONE
    return rec


@pytest.mark.parametrize("parallel", [1, 2])
def s_max_parallel(S, parallel):
    c = cluster(S)
    st = up(S).UpgradeController(c, S.ns).reconcile(
        policy(S, parallel=parallel))
    assert len([n for n in NODES if c.get("Node", n).get(
        "spec", "unschedulable")]) == parallel
    return [status(st), snapshot(S, c)]


def s_rolling_completes_all_nodes(S):
    c = cluster(S)
    uc, pol = up(S).UpgradeController(c, S.ns), policy(S)
    rec = []
    for _ in range(20):
        st = uc.reconcile(pol)
        rec.append(status(st))
        for n in NODES:   # kubelet: recreate the deleted operand pods
            if c.get_or_none("Pod", f"installer-{n}", S.ns) is None:
                mk_pod(S, c, f"installer-{n}", n, app=INSTALLER, hash_=NEW)
            if c.get_or_none("Pod", f"validator-{n}", S.ns) is None:
                mk_pod(S, c, f"validator-{n}", n, app=VALIDATOR)
        if st.done == 3:
            break
    assert st.done == 3
    return rec + [snapshot(S, c)]


def s_validation_gate_blocks_uncordon(S):
    c = cluster(S)
    uc, pol = up(S).UpgradeController(c, S.ns), policy(S, parallel=3)
    uc.reconcile(pol)
    uc.reconcile(pol)
    for n in NODES:
        c.delete("Pod", f"validator-{n}", S.ns)
        mk_pod(S, c, f"validator-{n}", n, app=VALIDATOR, ready=n != "n1")
        if c.get_or_none("Pod", f"installer-{n}", S.ns) is None:
            mk_pod(S, c, f"installer-{n}", n, app=INSTALLER, hash_=NEW)
    st = uc.reconcile(pol)
    assert c.get("Node", "n1").get("spec", "unschedulable") is True
    return [status(st), snapshot(S, c)]


def s_operator_restart_resumes_mid_upgrade(S):
    m = up(S)
    c = cluster(S)
    pol = policy(S)
    uc = m.UpgradeController(c, S.ns)
    uc.reconcile(pol)
    uc.reconcile(pol)
    st = m.UpgradeController(c, S.ns).reconcile(pol)
    assert len([n for n, s in st.stages.items() if s in (
        m.DRAINING, m.POD_RESTART, m.VALIDATING)]) == 1
    return [status(st), snapshot(S, c)]


def s_manual_cordon_not_adopted_over_budget(S):
    c = cluster(S)
    for n in ("n1", "n2"):
        node = c.get("Node", n)
        node.set("spec", "unschedulable", True)
        c.update(node)
    st = up(S).UpgradeController(c, S.ns).reconcile(policy(S))
    assert len(cordoned(S, c)) == 1 and st.waiting == 2
    return [status(st), snapshot(S, c)]


def s_failed_stage_holds_cordon_and_budget(S):
    c = cluster(S)
    uc, pol = up(S).UpgradeController(c, S.ns), policy(S)
    uc.reconcile(pol)
    [node] = cordoned(S, c)
    crash(S, c, f"installer-{node}")
    st = uc.reconcile(pol)
    assert st.stages[node] == "upgrade-failed" and st.failed == 1
    return [status(st), snapshot(S, c)]


def s_midflight_skew_caught_and_recovers(S):
    c = cluster(S)
    uc, pol = up(S).UpgradeController(c, S.ns), policy(S)
    uc.reconcile(pol)
    uc.reconcile(pol)
    [node] = cordoned(S, c)
    for name, app, ok in ((f"installer-{node}", INSTALLER, True),
                          (f"validator-{node}", VALIDATOR, False)):
        if c.get_or_none("Pod", name, S.ns) is not None:
            c.delete("Pod", name, S.ns)
        mk_pod(S, c, name, node, app=app, hash_=NEW, ready=ok)
        if not ok:
            p = c.get("Pod", name, S.ns)
            p.raw["status"]["containerStatuses"] = [
                {"name": "validation", "state": {"waiting": {
                    "reason": "CrashLoopBackOff"}}}]
            c.update_status(p)
    rec = [status(uc.reconcile(pol)), snapshot(S, c)]
    assert rec[0]["stages"][node] == "upgrade-failed"
    c.delete("Pod", f"validator-{node}", S.ns)
    mk_pod(S, c, f"validator-{node}", node, app=VALIDATOR, hash_=NEW)
    rec += [status(uc.reconcile(pol)), snapshot(S, c)]
    assert not c.get("Node", node).get("spec", "unschedulable",
                                       default=False)
    return rec


@pytest.mark.parametrize("straggler", [False, True])
def s_failed_node_self_heals_on_spec_correction(S, straggler):
    c = cluster(S)
    uc, pol = up(S).UpgradeController(c, S.ns), policy(S)
    uc.reconcile(pol)
    [node] = cordoned(S, c)
    crash(S, c, f"installer-{node}")
    rec = [status(uc.reconcile(pol))]
    ds = c.get("DaemonSet", S.tr(INSTALLER), S.ns)
    ds.annotations[hash_key(S)] = "v3-fixed"
    c.update(ds)
    if straggler:
        mk_pod(S, c, "straggler", node, ns="default", tpu_limit="4")
    rec += [status(uc.reconcile(pol)), snapshot(S, c)]
    assert rec[1]["stages"][node] == ("draining" if straggler
                                      else "pod-restart")
    if straggler:
        c.delete("Pod", "straggler", "default")
        rec += [status(uc.reconcile(pol)), snapshot(S, c)]
        assert rec[-2]["stages"][node] == "pod-restart"
    return rec


def s_fanout_hash_map_per_product(S):
    m = up(S)
    c = S.kube.FakeClient()
    accel = "cloud.google.com/gke-tpu-accelerator"
    for name, typ, h in (("ds-v5p", "tpu-v5p-slice", "h-v5p"),
                         ("ds-v5e", "tpu-v5e", "h-v5e")):
        mk_ds(S, c, f"{INSTALLER}-{name}", h,
              {"tpu.dev/libtpu.fanout": "true",
               "tpu.dev/libtpu.accelerator": typ})
    c.add_node("n-v5p", S.tr({"tpu.dev/chip.present": "true",
                              accel: "tpu-v5p-slice"}))
    c.add_node("n-v5e", S.tr({"tpu.dev/chip.present": "true",
                              accel: "tpu-v5e"}))
    mk_pod(S, c, "installer-n-v5p", "n-v5p", app=INSTALLER, hash_="h-v5p")
    mk_pod(S, c, "installer-n-v5e", "n-v5e", app=INSTALLER, hash_="stale")
    mk_pod(S, c, "validator-n-v5p", "n-v5p", app=VALIDATOR)
    mk_pod(S, c, "validator-n-v5e", "n-v5e", app=VALIDATOR)
    st = m.UpgradeController(c, S.ns).reconcile(policy(S, parallel=2))
    assert st.stages["n-v5p"] == m.DONE
    assert st.stages["n-v5e"] == m.UPGRADE_REQUIRED
    return [status(st), snapshot(S, c, ("n-v5p", "n-v5e"))]


def s_node_without_installer_is_done(S):
    c = S.kube.FakeClient()
    mk_ds(S, c, f"{INSTALLER}-x", NEW, {"tpu.dev/libtpu.fanout": "true",
                                        "tpu.dev/libtpu.accelerator": "x"})
    c.add_node("plain", S.tr({"tpu.dev/chip.present": "true"}))
    st = up(S).UpgradeController(c, S.ns).reconcile(policy(S))
    assert st.stages["plain"] == up(S).DONE
    return [status(st), snapshot(S, c, ("plain",))]


@pytest.mark.parametrize("parallel,max_unavailable", [(3, "25%"), (3, 0)])
def s_max_unavailable(S, parallel, max_unavailable):
    c = cluster(S)
    st = up(S).UpgradeController(c, S.ns).reconcile(
        policy(S, parallel=parallel, max_unavailable=max_unavailable))
    return [status(st), snapshot(S, c)]


def s_drain_disabled_waits_for_pods(S):
    c = cluster(S)
    mk_pod(S, c, "train-n1", "n1", ns="default", tpu_limit="4")
    uc = up(S).UpgradeController(c, S.ns)
    pol = policy(S, parallel=3, drain={"enable": False})
    rec = [status(uc.reconcile(pol)), snapshot(S, c)]
    assert c.get_or_none("Pod", "train-n1", "default") is not None
    c.delete("Pod", "train-n1", "default")
    rec += [status(uc.reconcile(pol)), snapshot(S, c)]
    assert rec[-2]["stages"]["n1"] == up(S).POD_RESTART
    return rec


def s_drain_timeout_marks_failed(S):
    m = up(S)
    c = cluster(S)
    mk_pod(S, c, "stuck", "n1", ns="default", tpu_limit="4")
    metrics = S.mod("controllers.metrics").OperatorMetrics()
    events = S.mod("controllers.events").EventRecorder(c, S.ns)
    uc = m.UpgradeController(c, S.ns, recorder=events, metrics=metrics)
    pol = policy(S, drain={"enable": False, "timeoutSeconds": 60})
    uc.reconcile(pol)
    n = c.get("Node", "n1")
    n.annotations[m.DRAIN_START] = str(int(time.time()) - 120)
    c.update(n)
    st = uc.reconcile(pol)
    assert st.stages["n1"] == m.FAILED and st.failed == 1
    evs = sorted((e.raw["reason"], e.raw["type"], e.raw["message"])
                 for e in c.list("Event", S.ns))
    return [status(st), snapshot(S, c), evs,
            metrics.drain_timeouts_total.get()]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("s_")]


def _cases():
    for fn in SCENARIOS:
        marks = getattr(fn, "pytestmark", [])
        params = [m for m in marks if m.name == "parametrize"]
        if not params:
            yield pytest.param(fn, {}, id=fn.__name__[2:])
            continue
        argnames, values = params[0].args
        names = [a.strip() for a in argnames.split(",")]
        for v in values:
            v = v if isinstance(v, tuple) else (v,)
            yield pytest.param(fn, dict(zip(names, v)),
                               id=f"{fn.__name__[2:]}-{'-'.join(map(str, v))}")


@pytest.mark.parametrize("scenario,kw", list(_cases()))
def test_upgrade_fsm_matches_the_reference(scenario, kw):
    ref, port = both(scenario, **kw)
    assert port == ref


@pytest.mark.parametrize("value,total,want", [
    ("25%", 8, 2), ("25%", 3, 1), ("50%", 3, 2), (2, 100, 2),
    ("bogus", 10, 1), (0, 10, 0), ("0", 10, 0), ("0%", 10, 0),
    (-3, 10, 1), ("-25%", 10, 1)])
def test_parse_max_unavailable(value, total, want):
    import tpu_operator.controllers.upgrade_controller as ref
    import tpu_operator_torch.controllers.upgrade_controller as port
    assert port.parse_max_unavailable(value, total) == \
        ref.parse_max_unavailable(value, total) == want


def test_a_driver_upgrade_is_the_product_pin_moving(monkeypatch):
    """The port's own end-to-end: the state pipeline fans the installer out
    per ``nvidia.com/gpu.product``; moving the product's pin in
    ``driver.versionMap`` changes that clone's hash alone, and the FSM then
    takes exactly that product's node through the pipeline."""
    from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy
    from tpu_operator_torch.controllers import upgrade_controller as m
    from tpu_operator_torch.controllers.object_controls import (
        FANOUT_LABEL, HASH_ANNOTATION)
    from tpu_operator_torch.controllers.state_manager import StateManager
    from tpu_operator_torch.kube import FakeClient, Obj
    from tpu_operator_torch.cli.operator import IMAGE_ENVS
    from torch_sides import A100, H100
    for env in IMAGE_ENVS:
        monkeypatch.setenv(env, "reg/operand:v1")
    c = FakeClient(auto_ready=True)
    for name, product in (("h", H100), ("a", A100)):
        c.add_node(name, {"feature.node.kubernetes.io/pci-10de.present":
                          "true", "nvidia.com/gpu.product": product})
    spec = {"driver": {"repository": "r", "image": "i", "version": "1",
                       "versionMap": {H100: "580.1", A100: "575.1"}},
            "upgradePolicy": {"autoUpgrade": True,
                              "maxParallelUpgrades": 2}}
    c.create(Obj({"apiVersion": "nvidia.com/v1alpha1",
                  "kind": "GPUClusterPolicy",
                  "metadata": {"name": "p"}, "spec": spec}))
    sm = StateManager(c, "gpu-operator")

    def render():
        live = c.get("GPUClusterPolicy", "p")
        pol = GPUClusterPolicy.from_obj(live.raw)
        sm.init(pol, live)
        sm.run_all()
        return pol, {d.name: d.annotations[HASH_ANNOTATION] for d in c.list(
            "DaemonSet", "gpu-operator",
            label_selector={FANOUT_LABEL: "true"})}

    pol, hashes = render()
    assert len(hashes) == 2
    for node in ("h", "a"):     # kubelet: each node runs its clone's pod
        ds = next(d for d in c.list("DaemonSet", "gpu-operator",
                                    label_selector={FANOUT_LABEL: "true"})
                  if d.name.endswith("h100-80gb-hbm3") == (node == "h"))
        for app, h in ((m.INSTALLER_APP, ds.annotations[HASH_ANNOTATION]),
                       (m.VALIDATOR_APP, None)):
            c.create(Obj({"apiVersion": "v1", "kind": "Pod", "metadata": {
                "name": f"{app}-{node}", "namespace": "gpu-operator",
                "labels": {"app": app},
                "annotations": {HASH_ANNOTATION: h} if h else {}},
                "spec": {"nodeName": node, "containers": []},
                "status": {"phase": "Running", "conditions": [
                    {"type": "Ready", "status": "True"}]}}))
    uc = m.UpgradeController(c, "gpu-operator")
    assert set(uc.reconcile(pol).stages.values()) == {m.DONE}
    live = c.get("GPUClusterPolicy", "p")
    live.raw["spec"]["driver"]["versionMap"][H100] = "580.2"
    c.update(live)
    pol, moved = render()
    assert [k for k in moved if moved[k] != hashes[k]] == [
        "gpu-driver-installer-nvidia-h100-80gb-hbm3"]
    st = uc.reconcile(pol)
    assert st.stages == {"h": m.UPGRADE_REQUIRED, "a": m.DONE}
    assert c.get("Node", "h").get("spec", "unschedulable") is True
