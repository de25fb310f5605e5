"""The reconciler (``controllers/clusterpolicy_controller.py``), its watch
trigger (``controllers/watch.py``), the leader electors (``cli/operator.py``
and ``controllers/leader.py``) and the operator CLI against the reference.

The reconciler scenarios of ``tests/test_controllers.py`` (a pass to
ready, not ready until the rollout, the slow poll without GPU nodes, the
singleton guard, an invalid spec, the converged pass write-free, status
only on a transition, the status blocks, the detection gauge), the
watch-trigger scenarios (``:723-820``), the electors
(``test_controllers.py:443``, ``:946-998``, ``test_fleet_scale.py:338-413``)
and the degraded pass (``test_chaos.py:347``) run on both copies with the
same cluster, written in the reference's names and mapped onto the port's
(``torch_sides``). What each pass returns, the CR's status, the Events,
the operator's families and every write that reaches the fake cluster
must be equal after the name map. The rendered objects themselves are
compared by ``test_torch_state_pipeline.py``.

Then the CLI: ``--client fake: --once`` in this process and as a module,
and a file-backed cluster driven pass after pass to ready, on both.

Waiting for the simulated cluster and the e2e harnesses (next slice):
``test_fleet_scale.py``'s failover and harness cases (``:415-450``).
"""

import io
import json
import os
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout

import pytest

from torch_sides import both, samples

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GKE = {"cloud.google.com/gke-tpu-accelerator": "tpu-v5p-slice",
       "cloud.google.com/gke-tpu-topology": "2x2x1"}
IMAGE_ENVS = ("LIBTPU_INSTALLER_IMAGE", "RUNTIME_HOOK_IMAGE",
              "DRIVER_IMAGE", "CONTAINER_TOOLKIT_IMAGE",
              "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
              "SLICE_MANAGER_IMAGE", "METRICS_AGENT_IMAGE",
              "METRICS_EXPORTER_IMAGE", "VALIDATOR_IMAGE")


@pytest.fixture(autouse=True)
def env_images(monkeypatch):
    for env in IMAGE_ENVS:
        monkeypatch.setenv(env, "reg/operand:v1")


def assets(S):
    return os.path.join(ROOT, "tpu_operator_torch", "assets") if S.port \
        else os.path.join(ROOT, "assets")


def mk_cr(S, c, spec=None, name="tpu-cluster-policy",
          ts="2026-01-01T00:00:00Z"):
    return c.create(S.obj({
        "apiVersion": "tpu.dev/v1alpha1", "kind": "TPUClusterPolicy",
        "metadata": {"name": name, "creationTimestamp": ts},
        "spec": spec or {}}))


def cluster(S, auto_ready=True, nodes=("tpu-node-1", "tpu-node-2")):
    c = S.kube.FakeClient(auto_ready=auto_ready)
    for n in nodes:
        c.add_node(S.tr(n), S.tr(dict(GKE)))
    c.add_node("cpu-node", {})
    return c


def reconciler(S, c, **kw):
    return S.mod("controllers.clusterpolicy_controller").Reconciler(
        c, S.ns, assets(S), **kw)


def result(res) -> dict:
    return {"ready": res.ready, "requeue_after": res.requeue_after,
            "statuses": dict(res.statuses), "message": res.message}


def crs(S, c) -> dict:
    kind = "GPUClusterPolicy" if S.port else "TPUClusterPolicy"
    return {o.name: o.raw.get("status") for o in c.list(kind)}


def events(S, c) -> list:
    return sorted((e.raw["reason"], e.raw["type"], e.raw["message"],
                   e.raw["count"], e.raw["involvedObject"]["kind"])
                  for e in c.list("Event", S.ns))


def writes(c, skip=("Event",)) -> list:
    """The fake cluster's writes, without the best-effort Events (``both``
    sorts them: the DAG walk applies states concurrently)."""
    return [dict(zip(("verb", "kind", "namespace", "name"), a))
            for a in c.actions if a[1] not in skip]


def view(S, r, c, res) -> dict:
    return {"result": result(res), "crs": crs(S, c), "events": events(S, c),
            "metrics": samples(r.metrics.registry, keep="reconcil|nodes|"
                               "state_status|labels|degraded|upgrades|"
                               "goodput_score|shard"),
            "writes": writes(c)}


# -- scenarios (tests/test_controllers.py, tests/test_chaos.py) ----------------

def s_reconcile_end_to_end_ready(S):
    c = cluster(S)
    mk_cr(S, c)
    r = reconciler(S, c)
    res = r.reconcile()
    assert res.ready and r.is_ready()
    return view(S, r, c, res)


def s_reconcile_not_ready_until_rollout(S):
    c = cluster(S, auto_ready=False, nodes=("tpu-node-1",))
    mk_cr(S, c)
    r = reconciler(S, c)
    first = result(r.reconcile())
    assert not first["ready"] and first["requeue_after"] == 5
    c.mark_daemonsets_ready()
    res = r.reconcile()
    assert res.ready
    return [first, view(S, r, c, res)]


def s_reconcile_no_gpu_nodes_slow_poll(S):
    c = S.kube.FakeClient(auto_ready=True)
    c.add_node("cpu-node", {})
    mk_cr(S, c)
    r = reconciler(S, c)
    res = r.reconcile()
    assert res.requeue_after == 45 and c.list("DaemonSet", S.ns) == []
    return view(S, r, c, res)


def s_reconcile_singleton_guard(S):
    c = cluster(S)
    mk_cr(S, c, name="a-first", ts="2026-01-01T00:00:00Z")
    mk_cr(S, c, name="b-second", ts="2026-01-02T00:00:00Z")
    r = reconciler(S, c)
    res = r.reconcile()
    assert crs(S, c)["b-second"]["state"] == "ignored"
    return view(S, r, c, res)


def s_reconcile_no_policy(S):
    c = cluster(S)
    r = reconciler(S, c)
    return view(S, r, c, r.reconcile())


def s_reconcile_invalid_spec_reports(S):
    c = cluster(S)
    mk_cr(S, c, {"sandboxWorkloads": {"enabled": True}})
    r = reconciler(S, c)
    res = r.reconcile()
    assert not res.ready
    return view(S, r, c, res)


@pytest.mark.parametrize("cache", [False, True])
def s_converged_pass_is_write_free(S, cache):
    c = cluster(S)
    mk_cr(S, c)
    r = reconciler(S, c, cache=cache)
    r.reconcile()
    c.actions.clear()
    res = r.reconcile()
    # converged: nothing written, the CR's status included
    assert c.actions == []
    out = view(S, r, c, res)
    if cache:
        out["fastpath"] = r.metrics.reconcile_noop_fastpath_total.get()
        assert out["fastpath"] == 1
    return out


def s_converged_reconcile_issues_zero_live_reads(S):
    """``test_dag_cache.py:363``: through a cache without watches, a
    converged pass reads nothing live."""
    fake = cluster(S, nodes=("tpu-node-1",))
    mk_cr(S, fake)
    cached = S.mod("kube.cache").CachedKubeClient(fake, watch=False)
    r = reconciler(S, cached)
    out = [r.reconcile().ready]
    reads = len(fake.reads)
    out += [r.reconcile().ready, fake.reads[reads:]]
    assert out[2] == [] and cached.hit_ratio() > 0.5
    return out


def s_disabled_component_deletes_operand(S):
    c = cluster(S)
    cr = mk_cr(S, c)
    r = reconciler(S, c)
    r.reconcile()
    cr = c.get(cr.kind, cr.name)
    cr.raw["spec"] = S.tr({"sliceManager": {"enabled": False}})
    c.update(cr)
    c.actions.clear()
    return view(S, r, c, r.reconcile())


def s_cr_status_carries_states_upgrades_slices(S):
    c = cluster(S)
    node = c.get("Node", S.tr("tpu-node-1"))
    node.labels.update(S.tr({"tpu.dev/slice.state": "success",
                             "tpu.dev/slice.config": "halves"}))
    c.update(node)
    mk_cr(S, c)
    r = reconciler(S, c)
    out = [view(S, r, c, r.reconcile())]
    node = c.get("Node", S.tr("tpu-node-1"))
    del node.labels[S.tr("tpu.dev/slice.state")]
    c.update(node)
    out.append(view(S, r, c, r.reconcile())["crs"])
    return out


def s_has_detection_labels_gauge(S):
    c = S.kube.FakeClient(auto_ready=True)
    c.add_node("cpu-only", {})
    mk_cr(S, c)
    r = reconciler(S, c)
    r.reconcile()
    key = "has_gpu_labels" if S.port else "has_tpu_labels"
    out = [getattr(r.metrics, key).get()]
    c.add_node(S.tr("tpu"), S.tr(dict(GKE)))
    r.reconcile()
    return out + [getattr(r.metrics, key).get()]


def s_upgrades_and_remediation_status_counts(S):
    rec = S.mod("controllers.clusterpolicy_controller").Reconciler
    up = S.mod("controllers.upgrade_controller").UpgradeStatus
    rem = S.mod("controllers.remediation_controller").RemediationStatus
    return [rec._upgrades_status(up(
        total=4, done=1, in_progress=2, waiting=1,
        stages={"n1": "draining", "n2": "pod-restart", "n3": "waiting",
                "n4": "done"})),
            rec._upgrades_status(up(total=4, done=4)),
            rec._remediation_status(rem(total=3, healthy=1, quarantined=2,
                                        stages={"a": "draining",
                                                "b": "remediating",
                                                "c": "healthy"})),
            rec._remediation_status(rem(total=2, healthy=2)),
            rec._degraded_condition({}),
            rec._degraded_condition({"a": "boom", "b": "skipped: a"})]


def s_controllers_ride_a_ready_pass(S):
    """A ready pass runs goodput, upgrades, remediation and resharding:
    an unhealthy node is quarantined, the plan shrinks, and the status
    blocks and families say so."""
    c = cluster(S)
    for n in ("tpu-node-1", "tpu-node-2"):
        c.patch("Node", S.tr(n), patch={"status": {"capacity": S.tr(
            {"tpu.dev/chip": "4"})}}, subresource="status")
    mk_cr(S, c, {"remediation": {"enabled": True, "maxUnavailable": "1"},
                 "resharding": {"enabled": True,
                                "planFile": f"/dev/null/{S.name}"}})
    r = reconciler(S, c)
    r.resharding._write_plan_file = lambda spec, st: None
    out = [view(S, r, c, r.reconcile())]
    c.patch("Node", S.tr("tpu-node-2"), patch={"status": {"conditions": [
        {"type": S.mod("health.monitor").NODE_CONDITION_TYPE,
         "status": "False", "lastTransitionTime": "2026-01-01T00:00:00Z"}]}},
        subresource="status")
    c.actions.clear()
    out.append(view(S, r, c, r.reconcile()))
    return out


def s_degraded_pass_publishes_partial_status(S):
    sm = S.mod("controllers.state_manager").StateManager
    orig = sm._apply_one

    def failing(self, name, comp):
        if name == "state-device-plugin":
            raise RuntimeError("boom: injected persistent failure")
        return orig(self, name, comp)
    c = cluster(S)
    mk_cr(S, c)
    r = reconciler(S, c)
    sm._apply_one = failing
    try:
        first = view(S, r, c, r.reconcile())
    finally:
        sm._apply_one = orig
    return [first, view(S, r, c, r.reconcile())]


def s_forced_failure_emits_one_warning_event(S):
    c = cluster(S)
    mk_cr(S, c)
    r = reconciler(S, c)
    client = S.mod("kube.client")

    def boom():
        raise client.KubeError("state-device-plugin: apiserver exploded")
    r.manager.run_all = boom
    r.reconcile()
    return view(S, r, c, r.reconcile())


def s_run_all_degrades_instead_of_aborting(S, workers):
    """``test_chaos.py:317``: one failing state; the pass completes, the
    failure and its dependents are not ready with errors, nothing raises."""
    sm_cls = S.mod("controllers.state_manager").StateManager
    orig = sm_cls._apply_one

    def failing(self, name, comp):
        if name == "state-device-plugin":
            raise RuntimeError("boom: injected persistent failure")
        return orig(self, name, comp)
    c = cluster(S, nodes=("tpu-node-1",))
    cr = mk_cr(S, c)
    m = sm_cls(c, S.ns, assets(S))
    sm_cls._apply_one = failing
    try:
        m.init(S.Policy.from_obj(cr.raw), cr)
        statuses = m.run_all(max_workers=workers)
    finally:
        sm_cls._apply_one = orig
    assert set(m.state_errors) == {"state-device-plugin",
                                   "state-slice-manager"}
    return [statuses, dict(m.state_errors)]


SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_") and k not in (
                       "s_converged_pass_is_write_free",
                       "s_run_all_degrades_instead_of_aborting"))


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_reconciler_matches_the_reference(scenario):
    ref, port = both(scenario)
    assert port == ref


@pytest.mark.parametrize("cache", [False, True], ids=["live", "cached"])
def test_converged_pass_is_write_free_as_the_reference(cache):
    ref, port = both(s_converged_pass_is_write_free, cache=cache)
    assert port == ref


@pytest.mark.parametrize("workers", [1, 4], ids=["serial", "dag"])
def test_run_all_degrades_as_the_reference(workers):
    ref, port = both(s_run_all_degrades_instead_of_aborting, workers)
    assert port == ref


# -- the watch trigger ---------------------------------------------------------

def s_node_event_relevance_predicate(S):
    w = S.mod("controllers.watch")
    gpu = S.obj({"kind": "Node", "metadata": {"labels": dict(GKE)}})
    cpu = S.obj({"kind": "Node", "metadata": {"labels": {"foo": "bar"}}})
    cap = S.obj({"kind": "Node", "metadata": {},
                 "status": {"capacity": {"tpu.dev/chip": "4"}}})
    return [w.node_event_relevant(e, n) for e, n in (
        ("ADDED", cpu), ("DELETED", cpu), ("MODIFIED", gpu),
        ("MODIFIED", cpu), ("MODIFIED", cap))]


def drain(trig, quiet=0.3):
    while trig.wait(quiet):
        pass


def s_watch_trigger(S, case):
    trig_cls = S.mod("controllers.watch").WatchTrigger
    c = S.kube.FakeClient(auto_ready=True)
    if case == "daemonset":
        c.add_node(S.tr("tpu"), S.tr(dict(GKE)))
        mk_cr(S, c)
        reconciler(S, c).reconcile()
    trig = trig_cls(c, S.ns).start()
    time.sleep(0.2)
    out = []
    try:
        if case == "wakes":
            out.append(trig.wait(0.1))
            c.add_node(S.tr("new-tpu"), S.tr(dict(GKE)))
            out.append(trig.wait(2.0))
            c.add_node("cpu", {})
            trig.wait(2.0)
            n = c.get("Node", "cpu")
            n.labels["unrelated"] = "x"
            c.update(n)
            out.append(trig.wait(0.3))
        elif case in ("heartbeat", "stripped"):
            c.add_node(S.tr("tpu"), S.tr(dict(GKE)))
            drain(trig)
            n = c.get("Node", S.tr("tpu"))
            if case == "heartbeat":
                n.raw.setdefault("status", {})["conditions"] = [
                    {"type": "Ready", "status": "True",
                     "lastHeartbeatTime": "now"}]
                c.update_status(n)
                out.append(trig.wait(0.5))
                n = c.get("Node", S.tr("tpu"))
                n.labels[S.tr("tpu.dev/deploy.operands")] = "false"
            else:
                n.metadata["labels"] = {}
            c.update(n)
            out.append(trig.wait(2.0))
        else:
            name = S.tr("tpu-device-plugin")
            c.update_status(c.get("DaemonSet", name, S.ns))
            drain(trig)
            ds = c.get("DaemonSet", name, S.ns)
            ds.raw["status"]["numberReady"] = 1
            c.update_status(ds)
            out.append(trig.wait(0.5))
            ds = c.get("DaemonSet", name, S.ns)
            ds.annotations[S.mod("controllers.object_controls")
                           .HASH_ANNOTATION] = "different"
            c.update(ds)
            out.append(trig.wait(2.0))
    finally:
        trig.stop()
    return out


def test_node_event_relevance_matches_the_reference():
    ref, port = both(s_node_event_relevance_predicate)
    assert port == ref == [True, True, True, False, True]


@pytest.mark.parametrize("case,want", [
    ("wakes", [False, True, False]), ("heartbeat", [False, True]),
    ("stripped", [True]), ("daemonset", [False, True])])
def test_watch_trigger_matches_the_reference(case, want):
    ref, port = both(s_watch_trigger, case=case)
    assert port == ref == want


def test_the_product_label_wakes_the_loop():
    """The driver fans out on ``nvidia.com/gpu.product``; a node gaining a
    product must wake the loop though it is no detection label (the
    reference's fan-out key is one)."""
    from tpu_operator_torch.controllers.watch import node_event_relevant
    from tpu_operator_torch.kube import Obj
    n = Obj({"kind": "Node", "metadata": {"labels": {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3"}}})
    assert node_event_relevant("MODIFIED", n)


def s_watch_gone_relist_resume(S):
    """``test_chaos.py:414``: a 410 Gone on resume clears the
    resourceVersion; the relisted stream's event wakes the loop."""
    client = S.mod("kube.client")
    gone = S.mod("kube.incluster").GoneError

    class GoneOnce(client.KubeClient):
        def __init__(self):
            self.rvs = []
            self.resumed = threading.Event()

        def watch(self, kind, namespace=None, label_selector=None,
                  timeout_s=300.0, resource_version=None):
            self.rvs.append(resource_version)
            if len(self.rvs) == 1:
                yield "ADDED", S.kube.Obj({"kind": "Node", "metadata": {
                    "name": "n1", "resourceVersion": "5"}})
                return
            if len(self.rvs) == 2:
                raise gone("watch Node: resourceVersion expired")
            self.resumed.set()
            yield "ADDED", S.kube.Obj({"kind": "Node", "metadata": {
                "name": "n2", "resourceVersion": "6"}})
            time.sleep(30)
    c = GoneOnce()
    trig = S.mod("controllers.watch").WatchTrigger(c, S.ns)
    threading.Thread(target=trig._loop, args=("Node", None, None),
                     daemon=True).start()
    out = [c.resumed.wait(5.0), trig.wait(5.0)]
    trig.stop()
    return out + [c.rvs[:3]]


def test_watch_gone_relist_resume_as_the_reference():
    ref, port = both(s_watch_gone_relist_resume)
    assert port == ref == [True, True, [None, "5", None]]


def test_watch_backoff_is_decorrelated_jitter_as_the_reference():
    from random import Random

    import tpu_operator.controllers.watch as ref
    import tpu_operator_torch.controllers.watch as port
    assert (port.WATCH_BACKOFF_BASE_S, port.WATCH_BACKOFF_CAP_S) == \
        (ref.WATCH_BACKOFF_BASE_S, ref.WATCH_BACKOFF_CAP_S)
    seqs = []
    for m in (ref, port):
        rng, prev, seq = Random(3), 1.0, []
        for _ in range(200):
            prev = m._next_backoff(rng, prev)
            seq.append(prev)
        seqs.append(seq)
    assert seqs[0] == seqs[1] and len(set(seqs[1])) > 50


# -- the leader electors -------------------------------------------------------

def s_cli_elector(S, monkeypatch):
    """The reference CLI's own elector (``test_controllers.py:443``,
    ``:946-998``) against the port's, which is the fenced one of
    ``controllers/leader.py`` (the port does not copy the unfenced one its
    loop no longer uses): acquire, standby, renew, takeover after expiry,
    and a holder judged by the duration it published."""
    now = [1_000_000.0]
    monkeypatch.setattr(time, "time", lambda: now[0])
    c = S.kube.FakeClient()
    if S.port:
        leader = S.mod("controllers.leader")
        micro, parse, seconds = (leader.micro_time, leader.parse_micro_time,
                                 leader.DEFAULT_LEASE_SECONDS)

        def elector(name, lease=None):
            return leader.LeaderElector(c, S.ns, identity=name,
                                        lease_seconds=lease,
                                        clock=lambda: now[0])
        lease_name = leader.LEASE_NAME
    else:
        op = S.mod("cli.operator")
        micro, parse, seconds = (op._micro_time, op._parse_micro_time,
                                 op.LEASE_SECONDS)

        def elector(name, lease=None):
            if lease is not None:
                monkeypatch.setattr(op, "LEASE_SECONDS", lease)
            return op.LeaderElector(c, S.ns, identity=name)
        lease_name = op.LEASE_NAME
    t = 1753795200.123456
    out = [micro(t), round(parse(micro(t)), 6), parse(None),
           parse(1700000000)]
    a, b = elector("a"), elector("b")
    out += [a.try_acquire(), b.try_acquire(), a.try_acquire()]
    now[0] += seconds - 5
    out.append(b.try_acquire())
    now[0] += 10
    out += [b.try_acquire(), a.try_acquire()]
    spec = c.get("Lease", lease_name, S.ns).raw["spec"]
    out.append([spec["holderIdentity"], spec["leaseDurationSeconds"]])
    short = elector("a", lease=3)    # a shorter local lease
    now[0] += 10
    out.append(short.try_acquire())  # b's published 30 s still hold
    now[0] += 25
    return out + [short.try_acquire()]


def s_lease_seconds_env(S, monkeypatch):
    """``test_controllers.py:988``: an invalid lease length neither crashes
    nor disables mutual exclusion; the reference's CLI and its fenced
    elector read it alike, the port's one elector the same way."""
    leader = S.mod("controllers.leader")
    read = leader.lease_seconds_from_env if S.port \
        else S.mod("cli.operator")._lease_seconds
    var = S.tr("TPU_OPERATOR_LEASE_SECONDS")
    out = []
    for value in ("7", "0", "-5", "10s", "soon", None):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
        out.append([read(), leader.lease_seconds_from_env()])
    return out


def s_fenced_elector(S, monkeypatch):
    leader = S.mod("controllers.leader")
    c = S.kube.FakeClient()
    clk = [1_000.0]
    metrics = S.mod("controllers.metrics").OperatorMetrics()

    def elector(name):
        return leader.LeaderElector(c, S.ns, identity=name,
                                    lease_seconds=30,
                                    clock=lambda: clk[0], metrics=metrics)
    a, b = elector("a"), elector("b")
    out = [a.try_acquire(), a.is_leader(), a.epoch, b.try_acquire()]
    clk[0] += 25                       # past the 80% self-fence margin
    out.append(a.is_leader())
    try:
        a.check_fencing()
    except leader.FencingError:
        out.append("fenced")
    out.append(b.try_acquire())
    clk[0] += 6                        # the lease expired
    out += [b.try_acquire(), b.is_leader(), b.epoch,
            metrics.leader_transitions_total.get()]
    fenced = leader.FencedClient(c, a)
    try:
        fenced.patch("Node", "n1", patch={"metadata": {}})
    except leader.FencingError:
        out.append("write fenced")
    out.append(fenced.list("Node"))
    writes0 = len(c.actions)
    clk[0] += 1
    out += [b.try_acquire(), len(c.actions) == writes0]   # throttled
    clk[0] += 11
    out += [b.try_acquire(), len(c.actions) > writes0]
    clk[0] += 31                       # expired for everyone
    out += [a.try_acquire(), b.try_acquire(), b.is_leader()]
    a.resign()
    out += [a.is_leader(), b.try_acquire(), b.epoch]
    return out + [c.get("Lease", leader.LEASE_NAME, S.ns).raw["spec"]]


@pytest.mark.parametrize("scenario", [s_cli_elector, s_lease_seconds_env,
                                      s_fenced_elector],
                         ids=["cli", "lease-env", "fenced"])
def test_electors_match_the_reference(scenario, monkeypatch):
    ref, port = both(scenario, monkeypatch)
    assert port == ref


def test_a_fenced_reconciler_aborts_mid_pass_as_the_reference():
    """A stale leader's first write dies at the fence; the pass aborts
    with the reference's result and counts a failure."""
    def scenario(S):
        leader = S.mod("controllers.leader")
        c = cluster(S)
        mk_cr(S, c)
        clk = [0.0]
        e = leader.LeaderElector(c, S.ns, identity="a", lease_seconds=30,
                                 clock=lambda: clk[0])
        r = reconciler(S, c, elector=e)
        first = result(r.reconcile())
        e._renewed_at = -100.0         # stalled past the margin mid-pass
        e._holding = True
        e.try_acquire = lambda: True
        res = r.reconcile()
        return [first, result(res),
                r.metrics.reconciliation_failed_total.get()]
    ref, port = both(scenario)
    assert port == ref
    assert port[0]["ready"] and not port[1]["ready"]


# -- the operator CLI ----------------------------------------------------------

def run_cli(S, argv):
    op = S.mod("cli.operator")
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = op.main(argv)
    return rc, json.loads(buf.getvalue())


def s_cli_once_fake(S):
    return run_cli(S, ["--client", "fake:", "--once", "--no-retry"])


def test_cli_once_prints_the_references_json():
    """``--client fake: --once``: the same JSON, states mapped, rc 0 — the
    reference seeds a GKE TPU node and an empty policy, the port a node
    NFD labels an NVIDIA PCI device and the sample ``GPUClusterPolicy``."""
    ref, port = both(s_cli_once_fake)
    assert port == ref
    rc, out = port
    assert rc == 0 and out["ready"] and sorted(out) == [
        "message", "ready", "requeueAfter", "states"]
    assert out["states"]["state-driver"] == "ready"


def test_cli_fake_seed_is_a_gpu_node_and_the_sample():
    from tpu_operator_torch.cli.operator import SAMPLE_CR, build_client
    c = build_client("fake:")
    [node] = c.list("Node")
    assert node.labels == {
        "feature.node.kubernetes.io/pci-10de.present": "true"}
    [cr] = c.list("GPUClusterPolicy")
    assert cr.name == "gpu-cluster-policy" and SAMPLE_CR.endswith(
        "config/samples/v1alpha1_gpuclusterpolicy.yaml")
    assert cr.raw["spec"]["driver"]["image"] == "gpu-node-agent"


def s_cli_file_backed_to_ready(S, root):
    """The e2e flow: a file-backed cluster seeded by hand, ``--once`` pass
    after pass, kubelet played between passes by marking the rendered
    DaemonSets ready; then converged passes write nothing."""
    path = str(root / S.name / "cluster.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    fake = S.mod("kube.fake").FileBackedFakeClient(path)
    fake.add_node(S.tr("tpu-node-1"), S.tr(dict(GKE)))
    fake.add_node("cpu-node", {})
    mk_cr(S, fake)
    passes = []
    for _ in range(10):
        rc, out = run_cli(S, ["--client", f"fake:{path}", "--once",
                              "--no-retry"])
        passes.append([rc, out])
        if rc == 0:
            break
        fake.mark_daemonsets_ready()
    before = json.loads(open(path).read())
    for _ in range(2):
        passes.append(run_cli(S, ["--client", f"fake:{path}", "--once",
                                  "--no-retry"]))
    after = json.loads(open(path).read())
    assert after == before              # no resourceVersion moved
    return passes


def test_cli_file_backed_cluster_converges_as_the_reference(tmp_path):
    ref, port = both(s_cli_file_backed_to_ready, tmp_path)
    assert port == ref
    assert [p[0] for p in port] == [1, 0, 0, 0]


def test_cli_once_runs_as_a_module():
    env = {k: v for k, v in os.environ.items() if not k.endswith("_IMAGE")}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run([sys.executable, "-m",
                        "tpu_operator_torch.cli.operator", "--client",
                        "fake:", "--once"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    out = json.loads(p.stdout)
    assert out["ready"] and out["message"] == "all states ready"
    assert out["states"]["state-container-toolkit"] == "ready"


def test_cli_serves_metrics_and_reconciles_until_interrupted(tmp_path,
                                                             monkeypatch):
    """The long-running loop on the port: metrics and readiness are served,
    the loop reconciles, and an interrupt ends it with rc 0."""
    import urllib.request

    from tpu_operator_torch.cli import operator as op
    from tpu_operator_torch.utils import prom
    served = {}
    real_serve = prom.serve

    def serve(*a, **kw):
        srv = real_serve(*a, **kw)
        served["port"] = srv.server_address[1]
        return srv
    monkeypatch.setattr(prom, "serve", serve)
    passes = []
    real = op.Reconciler.reconcile

    def reconcile(self):
        res = real(self)
        passes.append(res.ready)
        if len(passes) == 2:
            page = urllib.request.urlopen(
                f"http://127.0.0.1:{served['port']}/metrics").read().decode()
            assert "gpu_operator_reconciliation_status 1" in page
            raise KeyboardInterrupt
        return res
    monkeypatch.setattr(op.Reconciler, "reconcile", reconcile)
    monkeypatch.setattr(
        "tpu_operator_torch.controllers.watch.WatchTrigger.wait",
        lambda self, timeout: False)
    assert op.main(["--client", "fake:", "--metrics-port", "0",
                    "--no-retry"]) == 0
    assert passes == [True, True]
