"""The remediation FSM (``controllers/remediation_controller.py``) against
the reference's.

The remediation scenarios of ``tests/test_health.py:418-753`` run on both
copies on a virtual clock, written in the reference's names and mapped
onto the port's (``torch_sides``): every pass's derived stages and counts,
what each node carries, the pods left, the Events recorded and the
operator's remediation families must be equal after the name map. The
slice guard and the MTTR span's ``slice`` tag key on
``nvidia.com/gpu.product`` where the reference keys them on the TPU
accelerator type (``cloud.google.com/gke-tpu-accelerator``), which the
name map carries onto it.

The health monitor's own scenarios (``test_health.py:99-416``) are held by
``test_torch_health.py``; the drain-timeout scenario (``:710``) by
``test_torch_upgrade.py``; the slice manager's invalidation (``:755-802``)
by ``test_torch_slice_manager.py``; the MTTR harness (``:804-822``) waits
for the simulated cluster.
"""

import random

import pytest

from torch_sides import both, node_view, samples

GROUP = "tpu-v5p-slice"


class Clock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def rc(S):
    return S.mod("controllers.remediation_controller")


def policy(S, enabled=True, max_unavailable="1", window=600, retries=3,
           drain=None):
    spec = {"enabled": enabled, "maxUnavailable": max_unavailable,
            "remediationWindowSeconds": window, "maxRetries": retries}
    if drain is not None:
        spec["drain"] = drain
    return S.policy({"remediation": spec})


def set_condition(S, c, node, status, ts=0.0):
    mon = S.mod("health.monitor")
    c.patch("Node", node, patch={"status": {"conditions": [
        {"type": mon.NODE_CONDITION_TYPE, "status": status,
         "lastTransitionTime": mon.iso_ts(ts)}]}}, subresource="status")


def mk_validator(S, c, node, ready=True):
    return c.create(S.obj({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": f"validator-{node}", "namespace": "tpu-operator",
                     "labels": {"app": "tpu-operator-validator"}},
        "spec": {"nodeName": node},
        "status": {"phase": "Running",
                   "conditions": [{"type": "Ready",
                                   "status": "True" if ready else "False"}]}}))


def set_validator(S, c, node, ready):
    c.patch("Pod", f"validator-{node}", S.ns, patch={"status": {
        "conditions": [{"type": "Ready",
                        "status": "True" if ready else "False"}]}},
        subresource="status")


def mk_workload(S, c, node, name=None):
    return c.create(S.obj({
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": name or f"train-{node}",
                     "namespace": "default"},
        "spec": {"nodeName": node, "containers": [
            {"name": "c", "resources": {"limits": {"tpu.dev/chip": "4"}}}]},
        "status": {"phase": "Running"}}))


def mk_cluster(S, n=3, group=GROUP):
    c = S.kube.FakeClient()
    for i in range(n):
        c.add_node(f"n{i}", S.tr({
            "tpu.dev/chip.present": "true",
            "cloud.google.com/gke-tpu-accelerator": group}))
    return c


def upgrade_cordon(S, c, name):
    node = c.get("Node", name)
    node.annotations[S.mod("controllers.upgrade_controller")
                     .CORDONED_BY_US] = "true"
    node.set("spec", "unschedulable", True)
    c.update(node)


class Run:
    """One controller over one cluster on a virtual clock, with a metrics
    registry and an event recorder; ``record()`` is what a pass left."""

    def __init__(self, S, c, clock=None):
        self.S, self.c = S, c
        self.clock = clock or Clock()
        self.metrics = S.mod("controllers.metrics").OperatorMetrics()
        self.ctl = rc(S).RemediationController(
            c, S.ns, metrics=self.metrics, clock=self.clock,
            recorder=S.mod("controllers.events").EventRecorder(c, S.ns))

    def reconcile(self, pol):
        st = self.ctl.reconcile(pol)
        return {"total": st.total, "healthy": st.healthy,
                "unhealthy": st.unhealthy, "quarantined": st.quarantined,
                "waiting": st.waiting, "permanent": st.permanent,
                "stages": dict(st.stages)}

    def record(self):
        c = self.c
        return {"nodes": {n.name: node_view(c, n.name)
                          for n in c.list("Node")},
                "pods": sorted((p.namespace, p.name) for p in c.list("Pod")),
                "events": sorted((e.raw["reason"], e.raw["type"],
                                  e.raw["message"], e.raw["count"])
                                 for e in c.list("Event", self.S.ns)),
                "metrics": samples(self.metrics.registry,
                                   keep="remediation|quarantine|recover")}


# -- scenarios -----------------------------------------------------------------

def s_quarantine_cordons_taints_and_drains(S):
    c = mk_cluster(S, 3)
    mk_validator(S, c, "n0")
    mk_workload(S, c, "n0")
    r = Run(S, c)
    set_condition(S, c, "n0", "False", r.clock() - 90)
    st = r.reconcile(policy(S))
    assert st["stages"]["n0"] == rc(S).DRAINING
    assert c.get_or_none("Pod", "train-n0", "default") is None
    return [st, r.record()]


def s_drain_disabled_leaves_pods(S):
    c = mk_cluster(S, 1)
    mk_workload(S, c, "n0")
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, drain={"enable": False}))
    assert c.get_or_none("Pod", "train-n0", "default") is not None
    return [st, r.record()]


def s_recovery_gated_on_validator_then_reintegrates(S):
    c = mk_cluster(S, 2)
    mk_validator(S, c, "n0")
    r = Run(S, c)
    set_condition(S, c, "n0", "False", r.clock())
    rec = [r.reconcile(policy(S))]
    r.clock.advance(300)
    set_condition(S, c, "n0", "True", r.clock())
    set_validator(S, c, "n0", False)
    rec += [r.reconcile(policy(S)), r.record()]
    assert rec[1]["stages"]["n0"] == rc(S).VERIFYING
    set_validator(S, c, "n0", True)
    r.clock.advance(60)
    rec += [r.reconcile(policy(S)), r.record()]
    assert rec[3]["stages"]["n0"] == rc(S).HEALTHY
    return rec


def s_budget_defers_and_admits_later(S):
    c = mk_cluster(S, 3)
    r = Run(S, c)
    for n in ("n0", "n1"):
        set_condition(S, c, n, "False", r.clock())
    pol = policy(S, max_unavailable="1")
    rec = [r.reconcile(pol)]
    admitted = next(n for n, s in rec[0]["stages"].items()
                    if s == rc(S).DRAINING)
    mk_validator(S, c, admitted)
    set_condition(S, c, admitted, "True", r.clock())
    rec += [r.reconcile(pol), r.reconcile(pol), r.record()]
    assert list(rec[2]["stages"].values()).count(rc(S).DRAINING) == 1
    return rec


def s_budget_counts_upgrade_cordons_shared_pool(S):
    c = mk_cluster(S, 3)
    upgrade_cordon(S, c, "n1")
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, max_unavailable="1"))
    assert st["stages"]["n0"] == rc(S).WAITING
    return [st, r.record()]


def s_upgrade_owned_node_left_alone(S):
    c = mk_cluster(S, 2)
    upgrade_cordon(S, c, "n0")
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, max_unavailable="3"))
    assert st["stages"]["n0"] == rc(S).UPGRADING
    return [st, r.record()]


def s_slice_guard_keeps_last_node_schedulable(S):
    c = mk_cluster(S, 2, group="v5p-group")
    n1 = c.get("Node", "n1")
    n1.set("spec", "unschedulable", True)
    c.update(n1)
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, max_unavailable="2"))
    assert st["stages"]["n0"] == rc(S).WAITING
    return [st, r.record()]


def s_single_node_group_stays_remediable(S):
    c = mk_cluster(S, 1)
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, max_unavailable="1"))
    assert st["stages"]["n0"] == rc(S).DRAINING
    return [st, r.record()]


def s_backoff_doubles_then_permanent(S):
    c = mk_cluster(S, 2)
    r = Run(S, c)
    pol = policy(S, window=100, retries=2)
    set_condition(S, c, "n0", "False", r.clock())
    rec = [r.reconcile(pol)]
    for dt in (101, 201, 401, 10_000):
        r.clock.advance(dt)
        rec += [r.reconcile(pol), r.record()]
    assert rec[-2]["stages"]["n0"] == rc(S).PERMANENT
    return rec


def s_verifying_wedged_validator_burns_window_to_permanent(S):
    c = mk_cluster(S, 2)
    mk_validator(S, c, "n0", ready=False)
    r = Run(S, c)
    pol = policy(S, window=100, retries=1)
    set_condition(S, c, "n0", "False", r.clock())
    rec = [r.reconcile(pol)]
    set_condition(S, c, "n0", "True", r.clock())
    rec.append(r.reconcile(pol))
    for dt in (101, 201):
        r.clock.advance(dt)
        rec += [r.reconcile(pol), r.record()]
    assert rec[-1]["nodes"]["n0"]["unschedulable"] is True
    return rec


def s_cleanup_on_disable_preserves_permanent_label(S):
    m = rc(S)
    c = mk_cluster(S, 2)
    r = Run(S, c)
    set_condition(S, c, "n0", "False", r.clock())
    r.reconcile(policy(S))
    n1 = c.get("Node", "n1")
    n1.labels[m.PERMANENT_LABEL] = "true"
    n1.labels[m.STATE_LABEL] = m.PERMANENT
    c.update(n1)
    st = r.reconcile(policy(S, enabled=False))
    assert st["total"] == 0
    return [st, r.record()]


def s_budget_zero_freezes_quarantines(S):
    c = mk_cluster(S, 2)
    r = Run(S, c)
    set_condition(S, c, "n0", "False")
    st = r.reconcile(policy(S, max_unavailable="0"))
    assert st["quarantined"] == 0 and st["waiting"] == 1
    return [st, r.record()]


def s_missing_condition_is_healthy(S):
    r = Run(S, mk_cluster(S, 2))
    st = r.reconcile(policy(S))
    assert st["healthy"] == 2
    return [st, r.record()]


def s_budget_never_exceeded_across_chaos_schedules(S, seeds):
    """The reference's property over randomized schedules (cluster size,
    budget, flips, an upgrade cordon): the budget holds on both, and both
    take the same steps."""
    m = rc(S)
    cordon_key = S.mod("controllers.upgrade_controller").CORDONED_BY_US
    out = []
    for seed in seeds:
        rng = random.Random(1000 + seed)
        n = rng.randint(3, 8)
        budget = rng.randint(1, 2)
        c = S.kube.FakeClient()
        for i in range(n):
            c.add_node(f"n{i}", S.tr({
                "tpu.dev/chip.present": "true",
                "cloud.google.com/gke-tpu-accelerator":
                    rng.choice(["g0", "g1"])}))
        r = Run(S, c)
        pol = policy(S, max_unavailable=str(budget), window=10_000)
        upgrade_cordoned = 0
        if rng.random() < 0.3:
            upgrade_cordon(S, c, f"n{rng.randrange(n)}")
            upgrade_cordoned = 1
        for _ in range(30):
            r.clock.advance(rng.uniform(10, 120))
            for i in range(n):
                name = f"n{i}"
                if c.get("Node", name).annotations.get(cordon_key) == "true":
                    continue
                if rng.random() < 0.25:
                    set_condition(S, c, name,
                                  rng.choice(["True", "False"]), r.clock())
            out.append(r.reconcile(pol)["stages"])
            nodes = c.list("Node")
            ours = sum(1 for x in nodes
                       if x.annotations.get(m.QUARANTINED_BY_US) == "true")
            unavailable = sum(1 for x in nodes if x.get(
                "spec", "unschedulable", default=False))
            assert ours <= budget
            assert unavailable <= max(budget, upgrade_cordoned)
        out.append(r.record()["metrics"])
    return out


SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_") and k != "s_budget_never_exceeded"
                   "_across_chaos_schedules")


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_remediation_fsm_matches_the_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


@pytest.mark.parametrize("block", range(4))
def test_budget_property_matches_the_reference(block):
    """``test_budget_property_never_exceeded_across_chaos_schedules``'s 100
    seeds, in four blocks of 25."""
    ref, port = both(s_budget_never_exceeded_across_chaos_schedules,
                     range(25 * block, 25 * (block + 1)))
    assert port == ref


def test_slice_guard_groups_by_gpu_product():
    """The port's group is the node's product: two H100 nodes are one
    group (the guard keeps the last schedulable one), an A100 node beside
    them is a group of its own and stays remediable."""
    from tpu_operator_torch.controllers import remediation_controller as m
    from tpu_operator_torch.kube import FakeClient
    from torch_sides import A100, H100, Side
    S = Side("p")
    c = FakeClient()
    for name, product in (("h0", H100), ("h1", H100), ("a0", A100)):
        c.add_node(name, {"nvidia.com/gpu.present": "true",
                          "nvidia.com/gpu.product": product})
    h1 = c.get("Node", "h1")
    h1.set("spec", "unschedulable", True)
    c.update(h1)
    for name in ("h0", "a0"):
        set_condition(S, c, name, "False")
    st = m.RemediationController(c, "gpu-operator", clock=Clock()).reconcile(
        policy(S, max_unavailable="3"))
    assert st.stages == {"h0": m.WAITING, "h1": m.HEALTHY,
                         "a0": m.DRAINING}
