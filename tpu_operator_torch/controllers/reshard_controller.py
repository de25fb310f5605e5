"""Elastic slice resharding — the (data, model) re-planning loop.

The port of ``tpu_operator/controllers/reshard_controller.py``. A node's
chips are its cards (feature discovery's ``nvidia.com/gpu.count``), the
plan labels are ``nvidia.com/plan.*``, and ``MeshPlan`` comes from the
torch-free ``parallel/mesh_plan.py`` that the validator's mesh re-exports,
so the planner loads no torch and keeps the validator's factorization.

Remediation removes capacity on failure and the slice manager
invalidates partitions holding unhealthy chips, but until this controller
nothing RE-PLANNED the fleet: a quarantine just shrank the schedulable
world and the relay tier ate cold compiles for whatever shard shapes
survived. Tenplex (PAPERS.md) is the blueprint — parallelizable tensor
collections that survive device-count changes at runtime.

Level-triggered like every other controller here: each pass derives the
surviving chip count from the GPU node set (remediation stages + the
``nvidia.com/gpu.count`` label feature discovery maintains), re-derives the
live plan via ``MeshPlan.auto``, and — only when the plan actually
changed — publishes the new topology atomically:

- a plan document at ``spec.resharding.planFile`` (tmp + ``os.replace``,
  the same torn-read discipline as the slice-partition file),
- NFD-style ``nvidia.com/plan.*`` node labels (written only when different,
  so a converged pass patches nothing),
- a ``status.resharding`` block with a monotone generation counter so
  observers can detect in-flight transitions,
- subscriber callbacks (the relay tier's pre-warm → cutover → drain
  path hangs off these).

Quarantine/reintegrate transitions and slice-manager partition
invalidations additionally PUSH into ``notify_transition`` /
``notify_invalidation`` — they only mark the controller dirty; the next
reconcile does the work, so the push path can never race the level
trigger into a torn publication.
"""

from __future__ import annotations

import json
import logging
import os
import time
from dataclasses import dataclass

from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy
from tpu_operator_torch.kube.client import KubeClient
from tpu_operator_torch.parallel.mesh_plan import MeshPlan
from tpu_operator_torch.utils import trace
from . import remediation_controller
from .remediation_controller import node_reported_healthy, _ro_labels
from .state_manager import GPU_PRESENT_LABEL

log = logging.getLogger("gpu-operator")

GPU_COUNT_LABEL = "nvidia.com/gpu.count"
PLAN_DATA_LABEL = "nvidia.com/plan.data"
PLAN_MODEL_LABEL = "nvidia.com/plan.model"
PLAN_GENERATION_LABEL = "nvidia.com/plan.generation"
PLAN_LABELS = (PLAN_DATA_LABEL, PLAN_MODEL_LABEL, PLAN_GENERATION_LABEL)

SHRINK = "shrink"
EXPAND = "expand"

# remediation stages whose nodes still contribute chips to the plan: a
# node the FSM merely defers (WAITING) is still serving, as is one the
# upgrade FSM owns — only actual quarantine removes capacity
_SERVING_STAGES = (remediation_controller.HEALTHY,
                   remediation_controller.WAITING,
                   remediation_controller.UPGRADING)

@dataclass
class ReshardStatus:
    generation: int = 0
    data: int = 0
    model: int = 0
    chips: int = 0
    nodes: int = 0
    in_flight: bool = False
    last_transition: str = ""     # "" until the first replan
    changed: bool = False         # this pass published a new plan


def node_chip_count(node, fallback: int) -> int:
    """Chips a node contributes, from the feature-discovery label; the
    spec fallback covers nodes discovery hasn't labeled yet."""
    try:
        n = int(_ro_labels(node).get(GPU_COUNT_LABEL, fallback))
    except (TypeError, ValueError):
        n = fallback
    return max(0, n)


class ReshardController:
    def __init__(self, client: KubeClient, namespace: str = "gpu-operator",
                 recorder=None, metrics=None, clock=time.time):
        self.client = client
        self.namespace = namespace
        self.recorder = recorder
        self.metrics = metrics
        self.clock = clock
        # observers of plan changes: fn(ReshardStatus). The relay tier's
        # pre-warm/cutover/drain path subscribes here.
        self._subscribers: list = []
        # push-path dirty mark (remediation transitions, slice-manager
        # partition invalidations). Purely an accelerant for pollers that
        # gate on `dirty` — reconcile() itself is level-triggered and
        # recomputes regardless.
        self.dirty = False
        self._status = ReshardStatus()
        self._labels_converged = False

    # -- subscriptions ----------------------------------------------------
    def subscribe(self, fn):
        """Register a plan-change observer; called (ReshardStatus) after
        every publication, in subscription order."""
        self._subscribers.append(fn)
        return fn

    def notify_transition(self, stage: str):
        """Push hook for remediation FSM transitions (wire to
        ``RemediationController.on_transition``). Quarantine entry and
        reintegration are the capacity-changing edges."""
        if stage in (remediation_controller.DRAINING,
                     remediation_controller.REINTEGRATE):
            self.dirty = True

    def notify_invalidation(self, invalid: list[int]):
        """Push hook for slice-manager partition invalidations (wire to
        ``SliceManager.on_invalidate``)."""
        self.dirty = True

    # -- observations -----------------------------------------------------
    def _surviving(self, nodes, stages: dict, fallback: int
                   ) -> tuple[int, int]:
        """(chips, nodes) still serving: schedulable, reported healthy,
        and not held by the remediation FSM. With remediation disabled
        (empty stages) the health condition + cordon state decide alone."""
        chips = n_nodes = 0
        for node in nodes:
            stage = stages.get(node.name, remediation_controller.HEALTHY)
            if stage not in _SERVING_STAGES:
                continue
            if node.get("spec", "unschedulable", default=False):
                continue
            if not node_reported_healthy(node):
                continue
            c = node_chip_count(node, fallback)
            if c:
                chips += c
                n_nodes += 1
        return chips, n_nodes

    # -- publication ------------------------------------------------------
    def _write_plan_file(self, spec, st: ReshardStatus):
        """tmp + os.replace, the partition-file discipline: the relay
        CLI's PlanWatcher polls this file concurrently and must never see
        a torn document."""
        path = spec.plan_file
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"generation": st.generation, "data": st.data,
                       "model": st.model, "chips": st.chips,
                       "nodes": st.nodes, "ts": self.clock()}, f)
        os.replace(tmp, path)

    def _publish_labels(self, nodes, st: ReshardStatus):
        """Stamp nvidia.com/plan.* on every GPU node, patching only nodes
        whose labels differ — a converged pass issues zero writes."""
        want = {PLAN_DATA_LABEL: str(st.data),
                PLAN_MODEL_LABEL: str(st.model),
                PLAN_GENERATION_LABEL: str(st.generation)}
        for node in nodes:
            labels = _ro_labels(node)
            if all(labels.get(k) == v for k, v in want.items()):
                continue
            self.client.patch("Node", node.name,
                              patch={"metadata": {"labels": dict(want)}})

    def _publish(self, spec, nodes, st: ReshardStatus, primary=None):
        t0 = self.clock()
        st.in_flight = True
        if self.metrics is not None:
            self.metrics.reshard_in_flight.set(1)
        with trace.span("reshard.publish", generation=st.generation,
                        data=st.data, model=st.model):
            self._write_plan_file(spec, st)
            self._publish_labels(nodes, st)
            for fn in self._subscribers:
                fn(st)
        st.in_flight = False
        self._labels_converged = True
        if self.metrics is not None:
            m = self.metrics
            m.reshard_in_flight.set(0)
            m.reshard_generation.set(st.generation)
            m.reshard_chips.set(st.chips)
            m.reshard_plan_size.labels("data").set(st.data)
            m.reshard_plan_size.labels("model").set(st.model)
            m.reshard_transitions_total.labels(st.last_transition).inc()
            m.reshard_duration_seconds.observe(
                max(0.0, self.clock() - t0))
        if self.recorder is not None and primary is not None:
            self.recorder.normal(
                primary, "Resharded",
                f"plan generation {st.generation} "
                f"({st.last_transition}): data={st.data} model={st.model} "
                f"over {st.chips} chip(s) on {st.nodes} node(s)")
        log.info("resharded (%s): generation=%d data=%d model=%d chips=%d",
                 st.last_transition, st.generation, st.data, st.model,
                 st.chips)

    # -- reconcile --------------------------------------------------------
    def reconcile(self, policy: GPUClusterPolicy,
                  remediation=None, primary=None) -> ReshardStatus:
        """One level-triggered pass: derive surviving capacity, replan,
        publish on change. ``remediation`` is the RemediationStatus the
        same reconcile pass just produced (None when its reconcile failed
        or the FSM is disabled)."""
        spec = policy.spec.resharding
        self.dirty = False
        if not spec.enabled:
            self._cleanup()
            st = self._status
            return ReshardStatus(generation=st.generation)

        selector = {GPU_PRESENT_LABEL: "true"}
        ro = getattr(self.client, "list_readonly", None)
        nodes = ro("Node", label_selector=selector) if ro else None
        if nodes is None:
            nodes = self.client.list("Node", label_selector=selector)
        stages = dict(getattr(remediation, "stages", None) or {})
        chips, n_nodes = self._surviving(nodes, stages,
                                         spec.chips_per_node)
        st = self._status
        st.changed = False
        if chips <= 0:
            # an empty fleet has no plan; keep the last published topology
            # rather than publish a degenerate one (nothing can serve it)
            return st
        plan = MeshPlan.auto(chips, max_model=spec.max_model)
        if (plan.data, plan.model, chips) == (st.data, st.model, st.chips) \
                and st.generation > 0 and self._labels_converged:
            return st    # converged: zero writes, zero notifications
        direction = SHRINK if st.generation > 0 and chips < st.chips \
            else EXPAND
        st.generation += 1
        st.data, st.model = plan.data, plan.model
        st.chips, st.nodes = chips, n_nodes
        st.last_transition = direction
        st.changed = True
        self._publish(spec, nodes, st, primary=primary)
        return st

    def _cleanup(self):
        """resharding.enabled switched off → drop our plan labels (the
        plan file is left in place: a consumer mid-read must not see it
        vanish; a re-enable overwrites it)."""
        if not self._labels_converged and self._status.generation == 0:
            return
        for node in self.client.list("Node"):
            if not any(k in node.labels for k in PLAN_LABELS):
                continue
            self.client.patch(
                "Node", node.name,
                patch={"metadata": {"labels":
                                    {k: None for k in PLAN_LABELS}}})
        self._labels_converged = False

    # -- status -----------------------------------------------------------
    def status_block(self) -> dict:
        """The status.resharding block — empty until the first replan so
        a cluster that never resharded keeps a clean CR."""
        st = self._status
        if st.generation == 0:
            return {}
        return {"generation": st.generation, "data": st.data,
                "model": st.model, "chips": st.chips, "nodes": st.nodes,
                "inFlight": st.in_flight,
                "lastTransition": st.last_transition}
