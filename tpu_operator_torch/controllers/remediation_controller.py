"""Auto-remediation FSM — quarantine → drain → remediate → verify →
reintegrate (reference analogue: node maintenance machinery around DCGM
health; the upgrade FSM's sibling).

The port of ``tpu_operator/controllers/remediation_controller.py``. The
slice guard and the MTTR span's ``slice`` tag key on the node's
``nvidia.com/gpu.product`` (the driver fan-out's key), where the reference
keys them on the TPU accelerator type: nodes of one product form one group.

Same level-triggered redesign as upgrade_controller.py: every pass derives
each node's stage from observable cluster state — the health monitor's
``nvidia.com/GPUHealthy`` NodeCondition, our ownership annotations, GPU
workload pods, validator pod readiness — and performs at most the next
action. Node annotations record only non-observable facts: whether the
cordon is ours to undo, when the quarantine started, how many remediation
attempts have burned.

Safety rails (the budget semantics):

- disruption budget: never more than maxUnavailable nodes quarantined at
  once; nodes cordoned by the upgrade FSM (or anyone else) count AGAINST
  the budget — the two controllers share one unavailability pool;
- slice guard: never quarantine the last schedulable node of an
  product group (one group ≈ one slice's host pool) — a whole-slice
  outage is worse than running degraded;
- per-node backoff: the remediation window doubles every failed attempt,
  and past maxRetries the node is labeled a permanent failure (kept
  cordoned, Warning Event, metric) instead of flapping forever;
- reintegration gate: uncordon only after the condition is back True AND
  the node's validator pod is Ready — the same gate upgrades use.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy
from tpu_operator_torch.health.monitor import NODE_CONDITION_TYPE, parse_iso_ts
from tpu_operator_torch.kube.client import KubeClient
from tpu_operator_torch.kube.objects import Obj, consumes_gpu
from tpu_operator_torch.utils import trace
from .sharding import MAX_SHARDS, HashRing, pick_shard_count
from .state_manager import (DEFAULT_STATE_WORKERS, GPU_PRESENT_LABEL,
                            PRODUCT_LABEL)
from .upgrade_controller import (VALIDATOR_APP, _pod_ready,
                                 parse_max_unavailable)
from .upgrade_controller import CORDONED_BY_US as UPGRADE_CORDONED_BY_US

log = logging.getLogger("gpu-operator")

QUARANTINED_BY_US = "nvidia.com/remediation-cordoned"
QUARANTINE_START = "nvidia.com/remediation-start"    # unix ts of this attempt
ATTEMPTS_ANN = "nvidia.com/remediation-attempts"
UNHEALTHY_SINCE = "nvidia.com/remediation-unhealthy-since"  # for ttq metric
STATE_LABEL = "nvidia.com/remediation.state"         # informational
PERMANENT_LABEL = "nvidia.com/remediation.permanent-failure"
TAINT_KEY = "nvidia.com/unhealthy"

# derived stages, in pipeline order
HEALTHY = "healthy"
QUARANTINE = "quarantine-required"
WAITING = "waiting"               # over the disruption budget
DRAINING = "draining"
REMEDIATING = "remediating"       # drained; waiting for health to return
VERIFYING = "verifying"           # healthy again; validator gate pending
REINTEGRATE = "reintegrate"
PERMANENT = "permanent-failure"
UPGRADING = "upgrading"           # owned by the upgrade FSM this pass


@dataclass
class RemediationStatus:
    total: int = 0
    healthy: int = 0
    unhealthy: int = 0
    quarantined: int = 0          # nodes we currently hold cordoned
    waiting: int = 0              # unhealthy but deferred by the budget
    permanent: int = 0
    stages: dict = field(default_factory=dict)  # node -> stage


def _ro_labels(node: Obj) -> dict:
    """Labels without materializing metadata sub-dicts. ``Obj.labels``
    setdefault-s into the raw — forbidden on the shared raws a readonly
    cache LIST hands out (and a mutation would defeat the identity memo)."""
    return (node.raw.get("metadata") or {}).get("labels") or {}


def _ro_anns(node: Obj) -> dict:
    return (node.raw.get("metadata") or {}).get("annotations") or {}


def _condition(node: Obj) -> dict | None:
    for c in node.get("status", "conditions", default=[]) or []:
        if c.get("type") == NODE_CONDITION_TYPE:
            return c
    return None


def node_reported_healthy(node: Obj) -> bool:
    """Absence of the condition means the monitor hasn't reported — treat
    as healthy (never quarantine on missing data)."""
    c = _condition(node)
    return c is None or c.get("status") == "True"


class RemediationController:
    def __init__(self, client: KubeClient, namespace: str = "gpu-operator",
                 recorder=None, metrics=None, clock=time.time,
                 max_workers: int = DEFAULT_STATE_WORKERS):
        self.client = client
        self.namespace = namespace
        self.recorder = recorder
        self.metrics = metrics
        self.clock = clock
        self.max_workers = max_workers
        # optional goodput pacer (observability/goodput.py): when attached
        # AND pacing is enabled in the spec, its budget verdict can only
        # TIGHTEN the static maxUnavailable (which stays the hard ceiling)
        # and its backoff scale stretches the attempt window while the
        # fleet is below the goodput floor
        self.pacer = None
        # optional FSM-transition observer (stage: str): the reshard
        # controller hangs its dirty-mark push path here — quarantine and
        # reintegration are the capacity-changing edges it cares about
        self.on_transition = None
        # tests/harnesses can pin the shard count (None = autotune)
        self.shard_override: int | None = None
        # per-shard identity memos over known-good nodes: name -> (raw,
        # group, unschedulable). A hit means the cached readonly raw is the
        # SAME object the apiserver cache holds (copy-on-write store: any
        # write replaces the raw wholesale), so the node is still HEALTHY
        # with a clean state label — stage derivation, the health-condition
        # scan and the pod lookups are all skipped. This is what makes a
        # converged all-healthy pass O(fleet dict lookups), zero API calls.
        self._healthy_shards: list[dict[str, tuple]] = [{}]
        self._healthy_ring: HashRing | None = None
        self._pods_lock = threading.Lock()
        self._pods_loaded = True
        self._pods_resource = ""
        self._validator_pods: dict[str, list[Obj]] = defaultdict(list)
        self._workload_pods: dict[str, list[Obj]] = defaultdict(list)

    @property
    def _healthy_memo(self) -> dict:
        """Flat view of the per-shard memos (test/debug convenience)."""
        if len(self._healthy_shards) == 1:
            return self._healthy_shards[0]
        merged: dict = {}
        for d in self._healthy_shards:
            merged.update(d)
        return merged

    # -- events / metrics -------------------------------------------------
    def _record(self, node: Obj, stage: str, msg: str, warning=False):
        if self.recorder is None:
            return
        reason = "RemediationFailed" if warning else "RemediationProgress"
        if warning:
            self.recorder.warning(node, reason, msg)
        else:
            self.recorder.normal(node, reason, msg)

    def _tick_transition(self, stage: str):
        if self.metrics is not None:
            self.metrics.remediation_transitions_total.labels(stage).inc()
        if self.on_transition is not None:
            self.on_transition(stage)

    # -- observations -----------------------------------------------------
    def _snapshot_pods(self, resource: str):
        """Arm the (lazy) per-pass pod snapshot. The cluster-wide pod LIST
        only actually runs if some node needs it — an all-healthy converged
        pass never touches a quarantined branch, so it costs zero pod
        reads. At most ONE LIST per pass either way (same economics as the
        upgrade FSM)."""
        self._pods_resource = resource
        self._pods_loaded = False
        self._validator_pods = defaultdict(list)
        self._workload_pods = defaultdict(list)

    def _ensure_pods(self):
        with self._pods_lock:
            if self._pods_loaded:
                return
            self._pods_loaded = True
            for pod in self.client.list("Pod"):
                node = pod.get("spec", "nodeName")
                if not node:
                    continue
                if pod.namespace == self.namespace:
                    if pod.labels.get("app") == VALIDATOR_APP:
                        self._validator_pods[node].append(pod)
                    continue
                if consumes_gpu(pod, self._pods_resource):
                    self._workload_pods[node].append(pod)

    def _validator_ready(self, node: str) -> bool:
        self._ensure_pods()
        pods = self._validator_pods.get(node, [])
        return bool(pods) and _pod_ready(pods[0])

    def _workload_pods_on(self, node: str) -> list[Obj]:
        self._ensure_pods()
        return self._workload_pods.get(node, [])

    def _attempts(self, node: Obj) -> int:
        try:
            return max(0, int(_ro_anns(node).get(ATTEMPTS_ANN, 0)))
        except (TypeError, ValueError):
            return 0

    def _derive_stage(self, node: Obj, spec) -> str:
        anns = _ro_anns(node)
        quarantined = anns.get(QUARANTINED_BY_US) == "true"
        healthy = node_reported_healthy(node)
        if _ro_labels(node).get(PERMANENT_LABEL) == "true":
            return PERMANENT
        if not quarantined:
            if anns.get(UPGRADE_CORDONED_BY_US) == "true":
                # mid-upgrade: the upgrade FSM owns this cordon; if the node
                # is also unhealthy we still wait — one owner at a time
                return UPGRADING
            return HEALTHY if healthy else QUARANTINE
        # quarantined by us: walk the recovery pipeline
        if healthy:
            if not self._validator_ready(node.name):
                return VERIFYING
            return REINTEGRATE
        if self._workload_pods_on(node.name):
            return DRAINING
        return REMEDIATING

    # -- actions ----------------------------------------------------------
    def _taints(self, node: Obj) -> list:
        return node.get("spec", "taints", default=[]) or []

    @staticmethod
    def _span(stage: str, node: Obj):
        """One trace span per FSM transition, tagged with the node and its
        slice (product group) — the MTTR trace view."""
        return trace.span(f"remediation.{stage}", node=node.name,
                          slice=_ro_labels(node).get(PRODUCT_LABEL, ""))

    def _quarantine(self, node: Obj):
        with self._span(DRAINING, node):
            live = self.client.get("Node", node.name)
            live.set("spec", "unschedulable", True)
            taints = self._taints(live)
            if not any(t.get("key") == TAINT_KEY for t in taints):
                taints.append({"key": TAINT_KEY, "value": "true",
                               "effect": "NoSchedule"})
                live.set("spec", "taints", taints)
            now = self.clock()
            live.annotations[QUARANTINED_BY_US] = "true"
            live.annotations[QUARANTINE_START] = str(int(now))
            live.annotations.setdefault(ATTEMPTS_ANN, "0")
            cond = _condition(live) or {}
            since = parse_iso_ts(cond.get("lastTransitionTime", ""))
            if since:
                live.annotations[UNHEALTHY_SINCE] = str(int(since))
                if self.metrics is not None:
                    self.metrics.time_to_quarantine_seconds.observe(
                        max(0.0, now - since))
            live.labels[STATE_LABEL] = DRAINING
            self.client.update(live)
            self._tick_transition(DRAINING)
            self._record(live, DRAINING,
                         f"node {live.name} unhealthy "
                         f"({(cond.get('message') or 'no detail')}): "
                         f"cordoned + tainted, draining GPU workloads",
                         warning=True)

    def _reintegrate(self, node: Obj):
        with self._span(REINTEGRATE, node):
            live = self.client.get("Node", node.name)
            live.set("spec", "unschedulable", False)
            taints = [t for t in self._taints(live)
                      if t.get("key") != TAINT_KEY]
            live.set("spec", "taints", taints)
            now = self.clock()
            try:
                started = float(live.annotations.get(QUARANTINE_START, 0))
            except (TypeError, ValueError):
                started = 0.0
            try:
                since = float(live.annotations.get(UNHEALTHY_SINCE, 0))
            except (TypeError, ValueError):
                since = 0.0
            if self.metrics is not None and (since or started):
                self.metrics.time_to_recover_seconds.observe(
                    max(0.0, now - (since or started)))
            for ann in (QUARANTINED_BY_US, QUARANTINE_START, ATTEMPTS_ANN,
                        UNHEALTHY_SINCE):
                live.annotations.pop(ann, None)
            live.labels[STATE_LABEL] = HEALTHY
            self.client.update(live)
            self._tick_transition(REINTEGRATE)
            self._record(live, REINTEGRATE,
                         f"node {live.name} healthy and validated: "
                         f"uncordoned")

    def _evict(self, node_name: str):
        for p in self._workload_pods_on(node_name):
            log.info("remediation: evicting GPU pod %s/%s from %s",
                     p.namespace, p.name, node_name)
            self.client.delete("Pod", p.name, p.namespace)

    def _set_state_label(self, node: Obj, value: str):
        live = self.client.get("Node", node.name)
        if live.labels.get(STATE_LABEL) != value:
            with self._span(value, live):
                live.labels[STATE_LABEL] = value
                self.client.update(live)
                self._tick_transition(value)
                self._record(live, value,
                             f"remediation on {live.name}: {value}",
                             warning=value == PERMANENT)

    def _window_s(self, spec, attempts: int) -> int:
        """The attempt window, stretched by the goodput pacer's backoff
        scale while the fleet is below the floor (retry slower when the
        fleet can least afford churn)."""
        window = spec.window_s(attempts)
        if self.pacer is not None:
            window = int(window * self.pacer.backoff_scale())
        return window

    def _check_window(self, node: Obj, spec):
        """DRAINING/REMEDIATING/VERIFYING past the attempt window: burn a
        retry (backoff doubles the next window) or, past maxRetries, mark
        permanent."""
        try:
            started = float(_ro_anns(node).get(QUARANTINE_START, 0))
        except (TypeError, ValueError):
            started = 0.0
        attempts = self._attempts(node)
        if not started or \
                self.clock() - started <= self._window_s(spec, attempts):
            return
        live = self.client.get("Node", node.name)
        attempts += 1
        if attempts > spec.max_retries:
            with self._span(PERMANENT, live):
                live.labels[PERMANENT_LABEL] = "true"
                live.labels[STATE_LABEL] = PERMANENT
                self.client.update(live)
                self._tick_transition(PERMANENT)
                self._record(
                    live, PERMANENT,
                    f"node {live.name} still unhealthy after {attempts - 1} "
                    f"remediation attempts: marked permanent failure, kept "
                    f"cordoned — replace the hardware and remove the "
                    f"{PERMANENT_LABEL} label", warning=True)
                if self.metrics is not None:
                    self.metrics.remediation_permanent_total.inc()
            return
        with self._span("attempt-burn", live):
            live.annotations[ATTEMPTS_ANN] = str(attempts)
            live.annotations[QUARANTINE_START] = str(int(self.clock()))
            self.client.update(live)
            self._record(
                live, REMEDIATING,
                f"node {live.name} not recovered (healthy + validated) "
                f"within the remediation window: "
                f"attempt {attempts}/{spec.max_retries}, window now "
                f"{self._window_s(spec, attempts)}s", warning=True)

    # -- sharding ---------------------------------------------------------
    def _plan_shards(self, n_nodes: int) -> int:
        if self.shard_override is not None:
            shards = max(1, min(MAX_SHARDS, self.shard_override))
        else:
            shards = pick_shard_count(n_nodes, self.max_workers)
        if shards != len(self._healthy_shards):
            self._reshard(shards)
        return shards

    def _reshard(self, shards: int):
        """Repartition the healthy-node memos onto a new ring. Consistent
        hashing keeps ~(1 - new/old) of entries in place on a resize."""
        ring = HashRing(shards) if shards > 1 else None
        new: list[dict[str, tuple]] = [{} for _ in range(shards)]
        moved = 0
        for old_shard, d in enumerate(self._healthy_shards):
            for name, ent in d.items():
                dest = ring.owner(name) if ring else 0
                if dest != old_shard:
                    moved += 1
                new[dest][name] = ent
        self._healthy_shards = new
        self._healthy_ring = ring
        if self.metrics is not None and moved:
            self.metrics.shard_rebalance_total.inc(moved)

    def _derive_batch(self, items: list[Obj], memo: dict, from_cache: bool,
                      spec):
        """Pass-1 body for one shard: derive each node's stage and its
        contribution to the shared unavailability pool. Memo entries replay
        known-good nodes (raw identity == unchanged under copy-on-write)
        without touching conditions, annotations, or the pod snapshot."""
        stages: dict[str, str] = {}
        unavailable = 0
        sched: dict[str, int] = defaultdict(int)
        group_of: dict[str, str] = {}
        for node in items:
            ent = memo.get(node.name) if from_cache else None
            if ent is not None and ent[0] is node.raw:
                _, group, unsched = ent
                stages[node.name] = HEALTHY
                group_of[node.name] = group
                if unsched:
                    unavailable += 1
                else:
                    sched[group] += 1
                continue
            stage = self._derive_stage(node, spec)
            labels = _ro_labels(node)
            group = labels.get(PRODUCT_LABEL, "")
            group_of[node.name] = group
            unsched = bool(node.get("spec", "unschedulable", default=False))
            if unsched:
                unavailable += 1
            else:
                sched[group] += 1
            stages[node.name] = stage
            # memo only nodes pass 2 will provably not write to: HEALTHY
            # stage AND state label already clean
            if (from_cache and stage == HEALTHY
                    and labels.get(STATE_LABEL) in (None, HEALTHY)):
                memo[node.name] = (node.raw, group, unsched)
            else:
                memo.pop(node.name, None)
        return stages, unavailable, sched, group_of

    # -- reconcile --------------------------------------------------------
    def reconcile(self, policy: GPUClusterPolicy) -> RemediationStatus:
        status = RemediationStatus()
        spec = policy.spec.remediation
        if not spec.enabled:
            self._cleanup()
            return status

        selector = {GPU_PRESENT_LABEL: "true"}
        ro = getattr(self.client, "list_readonly", None)
        nodes = ro("Node", label_selector=selector) if ro else None
        from_cache = nodes is not None
        if nodes is None:
            nodes = self.client.list("Node", label_selector=selector)
        status.total = len(nodes)
        if not nodes:
            for d in self._healthy_shards:
                d.clear()
            return status
        budget = parse_max_unavailable(spec.max_unavailable, len(nodes))
        if self.pacer is not None:
            # pacing only tightens: the static maxUnavailable stays the
            # hard ceiling (mirrors the upgrade FSM)
            paced = self.pacer.remediation_budget(len(nodes))
            if paced is not None and paced < budget:
                if self.metrics is not None:
                    self.metrics.goodput_pacing_throttled_total.labels(
                        "remediation").inc()
                budget = paced
        if self.metrics is not None:
            self.metrics.goodput_effective_budget.labels(
                "remediation").set(budget)
        self._snapshot_pods(policy.spec.device_plugin.resource_name)

        # pass 1 (shard-parallel): derive stages + count the shared
        # unavailability pool. Read-only over the node snapshot; shards own
        # disjoint node sets via the consistent-hash ring, so the per-shard
        # memos never contend.
        shards = self._plan_shards(len(nodes))
        if shards <= 1:
            batches: list[list[Obj]] = [list(nodes)]
        else:
            ring = self._healthy_ring
            batches = [[] for _ in range(shards)]
            for n in nodes:
                batches[ring.owner(n.name)].append(n)
        results = []
        if shards <= 1:
            results.append(self._derive_batch(
                batches[0], self._healthy_shards[0], from_cache, spec))
        else:
            workers = min(shards, max(2, self.max_workers or shards))
            with ThreadPoolExecutor(
                    max_workers=workers,
                    thread_name_prefix="remed-shard") as pool:
                futs = [pool.submit(self._derive_batch, batch,
                                    self._healthy_shards[s], from_cache,
                                    spec)
                        for s, batch in enumerate(batches)]
                results = [f.result() for f in futs]

        stages: dict[str, str] = {}
        unavailable = 0          # every cordoned/unschedulable GPU node
        schedulable_by_group: dict[str, int] = defaultdict(int)
        group_of: dict[str, str] = {}
        for b_stages, b_unavail, b_sched, b_groups in results:
            stages.update(b_stages)
            unavailable += b_unavail
            for g, c in b_sched.items():
                schedulable_by_group[g] += c
            group_of.update(b_groups)
        group_size: dict[str, int] = defaultdict(int)
        for g in group_of.values():
            group_size[g] += 1

        # prune memo entries for nodes that left the fleet (churn would
        # otherwise grow the memos without bound)
        if from_cache and sum(len(d) for d in self._healthy_shards) > 0:
            live = set(stages)
            for d in self._healthy_shards:
                for name in [n for n in d if n not in live]:
                    del d[name]

        # pass 2: act
        for node in nodes:
            stage = stages[node.name]
            if stage == HEALTHY:
                status.healthy += 1
                if _ro_labels(node).get(STATE_LABEL) not in (None, HEALTHY):
                    self._set_state_label(node, HEALTHY)
            elif stage == UPGRADING:
                # counted in `unavailable` already; nothing to do
                pass
            elif stage == QUARANTINE:
                status.unhealthy += 1
                # budget gate: the unavailability pool is shared with the
                # upgrade FSM and manual cordons
                over_budget = unavailable >= budget
                # slice guard: keep at least one schedulable node per
                # product group (single-node groups stay remediable —
                # there is nothing left to protect)
                group = group_of[node.name]
                last_in_group = (
                    schedulable_by_group[group] <= 1
                    and group_size[group] > 1)
                if over_budget or last_in_group:
                    status.waiting += 1
                    stages[node.name] = WAITING
                    self._set_state_label(node, WAITING)
                    if self.metrics is not None:
                        self.metrics.remediation_budget_deferred_total.inc()
                    continue
                unavailable += 1
                schedulable_by_group[group] -= 1
                self._quarantine(node)
                if spec.drain_enabled():
                    self._evict(node.name)
                status.quarantined += 1
                stages[node.name] = DRAINING
            elif stage == DRAINING:
                if spec.drain_enabled():
                    self._evict(node.name)
                status.quarantined += 1
                self._set_state_label(node, DRAINING)
                self._check_window(node, spec)
            elif stage == REMEDIATING:
                status.quarantined += 1
                self._set_state_label(node, REMEDIATING)
                self._check_window(node, spec)
            elif stage == VERIFYING:
                status.quarantined += 1
                self._set_state_label(node, VERIFYING)
                # the validator gate can also wedge (pod unschedulable,
                # probe stuck): the attempt window applies here too, so a
                # node can't hold a budget slot forever in VERIFYING
                self._check_window(node, spec)
            elif stage == REINTEGRATE:
                self._reintegrate(node)
                status.healthy += 1
                stages[node.name] = HEALTHY
            elif stage == PERMANENT:
                status.permanent += 1
                status.quarantined += 1
                self._set_state_label(node, PERMANENT)
        status.stages = stages
        return status

    def _cleanup(self):
        """remediation.enabled switched off → release our cordons and drop
        our labels/annotations (mirror of upgrade _cleanup_labels; permanent
        failures stay labeled — they are a human's decision to clear)."""
        for node in self.client.list("Node"):
            ours = node.annotations.get(QUARANTINED_BY_US) == "true"
            has_state = STATE_LABEL in node.labels
            if not ours and not has_state:
                continue
            patch: dict = {"metadata": {}}
            if has_state:
                patch["metadata"]["labels"] = {STATE_LABEL: None}
            if ours:
                patch["metadata"]["annotations"] = {
                    QUARANTINED_BY_US: None, QUARANTINE_START: None,
                    ATTEMPTS_ANN: None, UNHEALTHY_SINCE: None}
                patch["spec"] = {
                    "unschedulable": False,
                    "taints": [t for t in self._taints(node)
                               if t.get("key") != TAINT_KEY]}
            self.client.patch("Node", node.name, patch=patch)
