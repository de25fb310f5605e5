"""The reshard controller (``controllers/reshard_controller.py``) and the
torch-free ``MeshPlan`` against the reference.

The controller half of ``tests/test_reshard.py`` (``:72-300``) runs on
both copies with the same cluster, written in the reference's names and
mapped onto the port's (``torch_sides``): each pass's ``ReshardStatus``,
the plan document, every node's plan labels, the status block, the
subscribers' view and the writes must be equal after the name map. A
node's chips are its cards (``nvidia.com/gpu.count``). The relay tier's
half (``:302-629``: the compile cache's plan generations, ``PlanWatcher``,
the service and router reshard paths) waits for the relay port.

``MeshPlan`` moved to ``parallel/mesh_plan.py``, which loads no torch;
``parallel/mesh.py`` re-exports it, and both give the reference's plans.
"""

import json
import os
import random

import pytest

from torch_sides import Side, both

NODE_LABELS = {"tpu.dev/chip.present": "true"}


class Clock:
    def __init__(self, t=0.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def rs(S):
    return S.mod("controllers.reshard_controller")


def rem(S):
    return S.mod("controllers.remediation_controller")


def policy(S, root, enabled=True, max_model=8, chips_per_node=4):
    return S.Policy.from_obj({
        "metadata": {"name": "p"},
        "spec": {"resharding": {
            "enabled": enabled,
            "planFile": str(root / S.name / "reshard-plan.json"),
            "maxModel": max_model, "chipsPerNode": chips_per_node}}})


def mk_cluster(S, n_nodes=2, chips=4):
    c = S.kube.FakeClient()
    for i in range(n_nodes):
        c.add_node(S.tr(f"tpu-{i}"), S.tr(
            {**NODE_LABELS, "tpu.dev/chip.count": str(chips)}))
    return c


def stages(S, **kw):
    return rem(S).RemediationStatus(
        stages={S.tr(k): getattr(rem(S), v) for k, v in kw.items()})


def status(st) -> dict:
    return {"generation": st.generation, "data": st.data, "model": st.model,
            "chips": st.chips, "nodes": st.nodes, "in_flight": st.in_flight,
            "last_transition": st.last_transition, "changed": st.changed}


def published(S, c, ctl, root):
    """The plan file, every node's plan labels, the status block and the
    API writes so far."""
    path = root / S.name / "reshard-plan.json"
    doc = json.loads(path.read_text()) if path.exists() else None
    plan_labels = rs(S).PLAN_LABELS
    return {"doc": doc,
            "tmp_left": os.path.exists(f"{path}.tmp"),
            "labels": {n.name: {k: v for k, v in n.labels.items()
                                if k in plan_labels}
                       for n in c.list("Node")},
            "block": ctl.status_block(),
            "writes": [a for a in c.actions if a[0] != "get"]}


# -- scenarios (tests/test_reshard.py:72-300) ---------------------------------

def s_spec_round_trip_and_validation(S, root):
    ok = S.Policy.from_obj({"metadata": {"name": "p"}, "spec": {
        "resharding": {"enabled": True, "maxModel": 4}}})
    bad = S.Policy.from_obj({"metadata": {"name": "p"}, "spec": {
        "resharding": {"maxModel": 0, "planFile": ""}}})
    r = ok.spec.resharding
    return [r.enabled, r.max_model, r.chips_per_node, ok.spec.validate(),
            bad.spec.validate()]


def s_node_chip_count_label_and_fallback(S, root):
    c = S.kube.FakeClient()
    key = S.tr("tpu.dev/chip.count")
    nodes = [c.add_node("a", {key: "8"}), c.add_node("b", {}),
             c.add_node("c", {key: "lots"})]
    return [rs(S).node_chip_count(n, 4) for n in nodes]


def s_first_reconcile_publishes(S, root):
    c = mk_cluster(S)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    st = ctl.reconcile(policy(S, root))
    assert st.changed and st.generation == 1 and st.chips == 8
    return [status(st), published(S, c, ctl, root)]


def s_converged_pass_is_read_only(S, root):
    c = mk_cluster(S)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    pol = policy(S, root)
    ctl.reconcile(pol)
    writes = len(c.actions)
    st = ctl.reconcile(pol)
    assert not st.changed and len(c.actions) == writes
    return [status(st), published(S, c, ctl, root)]


def s_quarantine_shrinks_then_reintegrate_expands(S, root):
    c = mk_cluster(S)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    pol = policy(S, root)
    rec = [status(ctl.reconcile(pol))]
    for stage in ("QUARANTINE", "HEALTHY"):
        st = ctl.reconcile(pol, remediation=stages(S, **{"tpu-0": stage}))
        rec += [status(st), published(S, c, ctl, root)]
    assert [r["last_transition"] for r in rec[1::2]] == ["shrink", "expand"]
    return rec


def s_waiting_and_upgrading_nodes_still_serve(S, root):
    c = mk_cluster(S, 3)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    st = ctl.reconcile(policy(S, root), remediation=stages(
        S, **{"tpu-0": "WAITING", "tpu-1": "UPGRADING",
              "tpu-2": "DRAINING"}))
    assert st.chips == 8 and st.nodes == 2
    return [status(st), published(S, c, ctl, root)]


def s_unschedulable_and_unhealthy_nodes_excluded(S, root):
    c = mk_cluster(S, 3)
    c.patch("Node", S.tr("tpu-0"), patch={"spec": {"unschedulable": True}})
    c.patch("Node", S.tr("tpu-1"), patch={"status": {"conditions": [
        {"type": S.mod("health.monitor").NODE_CONDITION_TYPE,
         "status": "False"}]}}, subresource="status")
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    st = ctl.reconcile(policy(S, root))
    assert st.chips == 4 and st.nodes == 1
    return [status(st), published(S, c, ctl, root)]


def s_zero_surviving_chips_keeps_last_plan(S, root):
    c = mk_cluster(S, 1)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    pol = policy(S, root)
    ctl.reconcile(pol)
    st = ctl.reconcile(pol, remediation=stages(S, **{"tpu-0": "QUARANTINE"}))
    assert not st.changed and st.generation == 1
    return [status(st), published(S, c, ctl, root)]


def s_max_model_bounds_the_model_axis(S, root, max_model):
    c = mk_cluster(S, 4)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    st = ctl.reconcile(policy(S, root, max_model=max_model))
    assert st.model <= max_model and st.data * st.model == 16
    return status(st)


def s_push_hooks_mark_dirty_and_reconcile_clears_it(S, root):
    m = rem(S)
    ctl = rs(S).ReshardController(mk_cluster(S), S.ns, clock=Clock())
    rec = [ctl.dirty]
    ctl.notify_transition(m.HEALTHY)
    rec.append(ctl.dirty)
    ctl.notify_transition(m.DRAINING)
    rec.append(ctl.dirty)
    ctl.reconcile(policy(S, root, enabled=False))
    rec.append(ctl.dirty)
    ctl.notify_invalidation([0, 2])
    rec.append(ctl.dirty)
    assert rec == [False, False, True, False, True]
    return rec


def s_disable_cleans_labels_but_keeps_plan_file(S, root):
    c = mk_cluster(S)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    ctl.reconcile(policy(S, root))
    rec = [status(ctl.reconcile(policy(S, root, enabled=False))),
           published(S, c, ctl, root)]
    st = ctl.reconcile(policy(S, root))
    assert st.generation == 2
    return rec + [status(st), published(S, c, ctl, root)]


def s_subscribers_fire_once_per_publication(S, root):
    c = mk_cluster(S)
    ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
    pol = policy(S, root)
    seen = []
    ctl.subscribe(lambda st: seen.append(
        (st.generation, st.data, st.model, st.in_flight)))
    ctl.reconcile(pol)
    ctl.reconcile(pol)
    ctl.reconcile(pol, remediation=stages(S, **{"tpu-0": "QUARANTINE"}))
    assert [g for g, *_ in seen] == [1, 2]
    return seen


def s_status_block_empty_until_first_plan(S, root):
    return rs(S).ReshardController(mk_cluster(S), S.ns).status_block()


def s_ordering_over_seeded_schedules(S, root, schedules):
    """``test_invalidation_to_reshard_ordering_100_schedules``: the
    generation is monotone and the file and the labels never disagree,
    over seeded quarantine/reintegrate/invalidation schedules."""
    m = rem(S)
    rnd = random.Random(1402)
    out = []
    for schedule in range(max(schedules) + 1):
        n_nodes = rnd.randint(2, 6)
        c = mk_cluster(S, n_nodes, rnd.choice((2, 4, 8)))
        ctl = rs(S).ReshardController(c, S.ns, clock=Clock())
        sub = root / f"s{schedule}"
        pol = policy(S, sub, max_model=rnd.choice((2, 4, 8)))
        down: set[str] = set()
        last_gen = 0
        for _ in range(rnd.randint(3, 8)):
            ev = rnd.random()
            if ev < 0.4 and len(down) < n_nodes:
                down.add(rnd.choice(sorted(
                    {f"tpu-{i}" for i in range(n_nodes)} - down)))
                ctl.notify_transition(m.DRAINING)
            elif ev < 0.7 and down:
                down.discard(rnd.choice(sorted(down)))
                ctl.notify_transition(m.REINTEGRATE)
            else:
                ctl.notify_invalidation([rnd.randrange(8)])
            if schedule not in schedules:
                continue
            st = ctl.reconcile(pol, remediation=stages(
                S, **{n: "QUARANTINE" for n in down}))
            assert st.generation == last_gen + (1 if st.changed else 0)
            last_gen = st.generation
            if st.generation == 0:
                continue
            view = published(S, c, ctl, sub)
            doc = view["doc"]
            assert (doc["generation"], doc["data"], doc["model"]) == \
                (st.generation, st.data, st.model)
            assert all(lab == {k: str(getattr(st, k.rsplit(".", 1)[1]))
                               for k in lab} for lab in view["labels"].values())
            out.append([status(st), doc])
    return out


SCENARIOS = sorted((k[2:], v) for k, v in globals().items()
                   if k.startswith("s_") and k not in (
                       "s_max_model_bounds_the_model_axis",
                       "s_ordering_over_seeded_schedules"))


@pytest.mark.parametrize("scenario", [v for _, v in SCENARIOS],
                         ids=[k for k, _ in SCENARIOS])
def test_reshard_controller_matches_the_reference(scenario, tmp_path):
    ref, port = both(scenario, tmp_path)
    assert port == ref


@pytest.mark.parametrize("max_model", [1, 2, 8])
def test_max_model_bounds_the_model_axis(tmp_path, max_model):
    ref, port = both(s_max_model_bounds_the_model_axis, tmp_path,
                     max_model=max_model)
    assert port == ref


@pytest.mark.parametrize("block", range(4))
def test_ordering_over_100_schedules_matches_the_reference(tmp_path, block):
    """The reference's 100 seeded schedules, in four blocks of 25 (one
    random stream: every block draws the schedules before it too)."""
    ref, port = both(s_ordering_over_seeded_schedules, tmp_path,
                     set(range(25 * block, 25 * (block + 1))))
    assert port == ref and port


@pytest.mark.parametrize("n", range(1, 17))
def test_mesh_plan_is_the_references_through_both_modules(n):
    """``MeshPlan.auto`` for n = 1…16 at every ``max_model`` the planner
    uses: the torch-free module, its re-export in ``parallel/mesh.py`` and
    the reference give the same plan."""
    from tpu_operator.parallel.mesh import MeshPlan as RefPlan
    from tpu_operator_torch.parallel import mesh, mesh_plan
    assert mesh.MeshPlan is mesh_plan.MeshPlan
    for max_model in (1, 2, 4, 8, 16):
        ref = RefPlan.auto(n, max_model=max_model)
        port = mesh_plan.MeshPlan.auto(n, max_model=max_model)
        assert (port.data, port.model, port.n_devices) == \
            (ref.data, ref.model, ref.n_devices)
        assert port.data * port.model == n and port.model <= max_model
    assert mesh.make_mesh(n, device="cpu").shape == {
        "data": mesh_plan.MeshPlan.auto(n).data,
        "model": mesh_plan.MeshPlan.auto(n).model}


def test_slice_manager_invalidation_marks_the_planner_dirty(tmp_path):
    """The slice manager's ``on_invalidate`` hook wired to
    ``notify_invalidation``: a card the health monitor flags invalidates
    its partition, the hook marks the controller dirty, and the next
    level-triggered pass clears the mark."""
    from tpu_operator_torch.controllers.reshard_controller import (
        ReshardController)
    from tpu_operator_torch.operands.slice_manager import SliceManager
    from tpu_operator_torch.kube import FakeClient
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(2):
        (dev / f"nvidia{i}").touch()
    plan = tmp_path / "partitions.json"
    plan.write_text(json.dumps({"partitions": [[str(dev / "nvidia0")],
                                               [str(dev / "nvidia1")]]}))
    health = tmp_path / "health"
    health.write_text("1\n")
    c = FakeClient()
    ctl = ReshardController(c, "gpu-operator", clock=Clock())
    sm = SliceManager(c, node_name="n", partitions_file=str(plan),
                      device_glob=str(dev / "nvidia[0-9]*"),
                      health_file=str(health))
    sm.on_invalidate = ctl.notify_invalidation
    assert not ctl.dirty
    assert sm.invalidate_unhealthy_partitions() == [1]
    assert ctl.dirty
    ctl.reconcile(Side("p").policy({"resharding": {"enabled": False}}))
    assert not ctl.dirty
    assert sm.invalidate_unhealthy_partitions() == [1]   # unchanged: no push
    assert not ctl.dirty
