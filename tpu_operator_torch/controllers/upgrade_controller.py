"""Safe rolling driver upgrades — the driver-upgrade FSM.

The port of ``tpu_operator/controllers/upgrade_controller.py``: the
library swapped is the driver's user-space half (``libcuda.so.1`` and the
libraries beside it) and an upgrade is the per-product fan-out's pin
moving (``driver.versionMap``, ``object_controls._compile_driver_fanout``:
one installer DaemonSet per ``nvidia.com/gpu.product``, whose hash changes
with its ``DRIVER_REQUIRED_VERSION``). Reference analogue: controllers/upgrade_controller.go + the vendored
NVIDIA/k8s-operator-libs upgrade state machine (cordon → pod-deletion →
drain → driver restart → validation gate → uncordon, SURVEY.md §3.4).

Redesign: instead of a persisted per-node state label that must be kept in
sync, each pass *derives* every node's stage from observable cluster state
(installer pod hash vs DaemonSet hash, GPU pods present, validator pod
readiness) and performs at most the next action. That makes the FSM
level-triggered and crash-safe — an operator restart mid-upgrade resumes
exactly where the cluster actually is. A node annotation records only the one
fact that is NOT observable: whether the cordon was ours to undo.

Why OnDelete + controller-driven restarts (not RollingUpdate): the installer
DaemonSet uses updateStrategy OnDelete (assets/state-driver/0500_daemonset.
yaml) so a driver version bump never restarts node agents by itself —
swapping libcuda under a running CUDA job would kill it. This controller
restarts installer pods node-by-node, draining GPU workloads first.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

from collections import defaultdict

from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy
from tpu_operator_torch.kube.client import KubeClient
from tpu_operator_torch.kube.objects import Obj, consumes_gpu
from .object_controls import (DRIVER_DS, FANOUT_LABEL, HASH_ANNOTATION,
                              PRODUCT_DS_LABEL)
from .state_manager import GPU_PRESENT_LABEL, PRODUCT_LABEL

log = logging.getLogger("gpu-operator")

CORDONED_BY_US = "nvidia.com/upgrade-cordoned"
DRAIN_START = "nvidia.com/upgrade-drain-start"    # unix ts, for drain timeout
DRAIN_HASH = "nvidia.com/upgrade-drain-hash"      # DS hash the drain serves
STATE_LABEL = "nvidia.com/driver-upgrade.state"   # informational, for kubectl
INSTALLER_APP = DRIVER_DS
VALIDATOR_APP = "gpu-operator-validator"

# derived stages, in pipeline order
DONE = "done"
UPGRADE_REQUIRED = "upgrade-required"
WAITING = "waiting"           # over the parallelism budget
DRAINING = "draining"
POD_RESTART = "pod-restart"
VALIDATING = "validating"
FAILED = "upgrade-failed"     # installer/validator crash-looping on the node
UNCORDON = "uncordon-required"


@dataclass
class UpgradeStatus:
    total: int = 0
    done: int = 0
    in_progress: int = 0
    waiting: int = 0
    available: int = 0
    failed: int = 0
    stages: dict = field(default_factory=dict)  # node -> stage


def _pod_ready(pod: Obj) -> bool:
    if pod.get("status", "phase") != "Running":
        return False
    for cond in pod.get("status", "conditions", default=[]) or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return False


def parse_max_unavailable(value, total: int) -> int:
    """Resolve an absolute-or-percentage maxUnavailable against the node
    count (reference: the maxUnavailable math, upgrade_controller.go:134-142).
    Percentages round UP (k8s intstr convention for maxUnavailable). Zero is
    honored — it means "start no new upgrades" (incident freeze); bad values
    fall back to 1 node."""
    try:
        if isinstance(value, str) and value.strip().endswith("%"):
            pct = float(value.strip().rstrip("%"))
            if pct < 0:
                return 1  # a negative percentage is a typo, not a freeze
            if pct == 0:
                return 0
            return max(1, -(-int(pct * total) // 100))  # ceil
        n = int(value)
        if n < 0:
            return 1
        return n
    except (TypeError, ValueError):
        return 1


def _pod_failed(pod: Obj) -> bool:
    if pod.get("status", "phase") == "Failed":
        return True
    for key in ("containerStatuses", "initContainerStatuses"):
        for cs in pod.get("status", key, default=[]) or []:
            waiting = (cs.get("state") or {}).get("waiting") or {}
            if waiting.get("reason") in ("CrashLoopBackOff",
                                         "ImagePullBackOff",
                                         "ErrImagePull"):
                return True
    return False


class UpgradeController:
    def __init__(self, client: KubeClient, namespace: str = "gpu-operator",
                 recorder=None, metrics=None):
        self.client = client
        self.namespace = namespace
        # optional EventRecorder: every FSM move leaves a kubectl-visible
        # Event on the node (Warning when the upgrade is crash-looping)
        self.recorder = recorder
        self.metrics = metrics
        # optional goodput pacer (observability/goodput.py): when attached
        # AND pacing is enabled, its verdict caps the parallelism budget —
        # frozen below the goodput floor, the user's maxParallelUpgrades
        # stays the hard ceiling
        self.pacer = None
        # node name → last cache raw verified clean by _cleanup_labels
        self._clean_memo: dict[str, dict] = {}
        # nodes whose FAILED derivation came from the drain-timeout escape
        # this pass (so the action pass can attribute the Warning)
        self._drain_timed_out: set[str] = set()

    def _record_move(self, node: Obj, stage: str):
        if self.recorder is None:
            return
        msg = f"driver upgrade on {node.name}: {stage}"
        if stage == FAILED:
            self.recorder.warning(node, "UpgradeFailed", msg)
        else:
            self.recorder.normal(node, "UpgradeProgress", msg)

    # -- observations -----------------------------------------------------
    def _snapshot_pods(self, resource: str):
        """ONE cluster-wide pod LIST per pass, indexed by node — the stage
        derivation for N nodes must not cost N LISTs."""
        self._operand_pods: dict[tuple, list[Obj]] = defaultdict(list)
        self._workload_pods: dict[str, list[Obj]] = defaultdict(list)
        for pod in self.client.list("Pod"):
            node = pod.get("spec", "nodeName")
            if not node:
                continue
            if pod.namespace == self.namespace:
                app = pod.labels.get("app")
                if app:
                    self._operand_pods[(node, app)].append(pod)
                continue  # operands don't consume chips
            if consumes_gpu(pod, resource):
                self._workload_pods[node].append(pod)

    def _pods_on(self, node: str, app: str) -> list[Obj]:
        return self._operand_pods.get((node, app), [])

    def _gpu_workload_pods(self, node: str) -> list[Obj]:
        """Pods consuming GPUs on the node — what must drain before the
        library is swapped (reference: gpuPodSpecFilter, main.go:161-183)."""
        return self._workload_pods.get(node, [])

    def _derive_stage(self, node: Obj, ds_hash: str,
                      drain_timeout_s: int = 0) -> str:
        pods = self._pods_on(node.name, INSTALLER_APP)
        pod_hash = pods[0].annotations.get(HASH_ANNOTATION) if pods else None
        current = bool(pods) and pod_hash == ds_hash and _pod_ready(pods[0])
        cordoned_by_us = node.annotations.get(CORDONED_BY_US) == "true"
        if cordoned_by_us and any(
                _pod_failed(p) for p in
                pods + self._pods_on(node.name, VALIDATOR_APP)):
            # When the failing pod predates a spec correction (its hash no
            # longer matches the DaemonSet), fall through to the NORMAL flow:
            # with updateStrategy OnDelete only a pod delete picks up the
            # fix, so the node drains (with the usual drain-timeout escape)
            # and then pod-restarts — FAILED must not trap a node whose
            # remediation is already in the cluster.
            if not (pods and pod_hash != ds_hash):
                # mid-upgrade and the CURRENT-spec agent is crash-looping:
                # surface it instead of silently holding the budget forever
                # (reference: upgrade-failed state in k8s-operator-libs)
                return FAILED
        if current:
            if cordoned_by_us:
                # validation gate: the node validator must pass on the new
                # library before workloads return (reference:
                # WithValidationEnabled("app=nvidia-operator-validator"),
                # main.go:120-142)
                if not self._validator_ready(node):
                    return VALIDATING
                return UNCORDON
            return DONE
        if not cordoned_by_us:
            # an admin's manual cordon is not an upgrade in progress: the
            # node still goes through the budget gate below and is only
            # adopted (annotated) when admitted
            return UPGRADE_REQUIRED
        if self._gpu_workload_pods(node.name):
            # the timeout clock only counts while it serves the CURRENT
            # spec: a mid-flight spec correction (new DS hash) restarts the
            # drain window (the DRAINING action re-stamps it), otherwise a
            # node that sat in FAILED would re-derive FAILED off the stale
            # timestamp before its self-heal ever ran
            if drain_timeout_s > 0 and \
                    node.annotations.get(DRAIN_HASH) == ds_hash:
                try:
                    started = float(node.annotations.get(DRAIN_START, 0))
                except (TypeError, ValueError):
                    started = 0.0
                if started and time.time() - started > drain_timeout_s:
                    # stuck pods past the deadline: surface instead of
                    # holding the budget forever (reference: drain spec
                    # timeoutSeconds -> upgrade-failed)
                    self._drain_timed_out.add(node.name)
                    return FAILED
            return DRAINING
        if pods and pod_hash != ds_hash:
            return POD_RESTART
        # pod gone (kubelet rescheduling) or new pod not ready yet
        return VALIDATING

    # -- actions ----------------------------------------------------------
    def _cordon(self, node: Obj, ds_hash: str = ""):
        node = self.client.get("Node", node.name)
        node.set("spec", "unschedulable", True)
        node.annotations[CORDONED_BY_US] = "true"
        node.annotations[DRAIN_START] = str(int(time.time()))
        node.annotations[DRAIN_HASH] = ds_hash
        node.labels[STATE_LABEL] = DRAINING
        self.client.update(node)
        self._record_move(node, DRAINING)

    def _uncordon(self, node: Obj):
        node = self.client.get("Node", node.name)
        node.set("spec", "unschedulable", False)
        node.annotations.pop(CORDONED_BY_US, None)
        node.annotations.pop(DRAIN_START, None)
        node.annotations.pop(DRAIN_HASH, None)
        node.labels[STATE_LABEL] = DONE
        self.client.update(node)
        self._record_move(node, DONE)

    def _restamp_drain_window(self, node: Obj, ds_hash: str):
        """The drain now serves a NEW spec (hash changed since cordon):
        restart the timeout clock so the self-heal isn't killed by the old
        timestamp."""
        live = self.client.get("Node", node.name)
        if live.annotations.get(DRAIN_HASH) != ds_hash:
            live.annotations[DRAIN_START] = str(int(time.time()))
            live.annotations[DRAIN_HASH] = ds_hash
            self.client.update(live)

    def _evict(self, pods: list[Obj]):
        for p in pods:
            log.info("upgrade: evicting GPU pod %s/%s", p.namespace, p.name)
            self.client.delete("Pod", p.name, p.namespace)

    def _restart_installer(self, node: Obj):
        for p in self._pods_on(node.name, INSTALLER_APP):
            log.info("upgrade: restarting installer on %s", node.name)
            self.client.delete("Pod", p.name, p.namespace)
        # the validator must re-run its init chain against the NEW library —
        # its old Ready condition proves nothing about the swapped driver
        for p in self._pods_on(node.name, VALIDATOR_APP):
            log.info("upgrade: restarting validator on %s", node.name)
            self.client.delete("Pod", p.name, p.namespace)

    def _validator_ready(self, node: Obj) -> bool:
        pods = self._pods_on(node.name, VALIDATOR_APP)
        return bool(pods) and _pod_ready(pods[0])

    def _set_state_label(self, node: Obj, value: str):
        live = self.client.get("Node", node.name)
        if live.labels.get(STATE_LABEL) != value:
            live.labels[STATE_LABEL] = value
            self.client.update(live)
            self._record_move(live, value)

    # -- reconcile --------------------------------------------------------
    def reconcile(self, policy: GPUClusterPolicy) -> UpgradeStatus:
        status = UpgradeStatus()
        up = policy.spec.upgrade_policy
        if not up.auto_upgrade:
            self._cleanup_labels()
            return status

        # the installer may be fanned out per GPU product
        # (_compile_driver_fanout): map each node to ITS DaemonSet's hash
        base_hash = None
        hash_by_product: dict[str, str] = {}
        for d in self.client.list("DaemonSet", self.namespace):
            if d.name == INSTALLER_APP:
                base_hash = d.annotations.get(HASH_ANNOTATION, "")
            elif d.labels.get(FANOUT_LABEL) == "true":
                hash_by_product[d.labels.get(PRODUCT_DS_LABEL, "")] = \
                    d.annotations.get(HASH_ANNOTATION, "")
        if base_hash is None and not hash_by_product:
            return status
        resource = policy.spec.device_plugin.resource_name

        nodes = self.client.list(
            "Node", label_selector={GPU_PRESENT_LABEL: "true"})
        status.total = len(nodes)
        # budget = the stricter of maxParallelUpgrades and maxUnavailable
        # (the latter absolute or a percentage of GPU nodes; 0 freezes new
        # admissions — `if up.max_unavailable:` would drop int 0 on the floor)
        max_parallel = max(1, int(up.max_parallel_upgrades or 1))
        if up.max_unavailable is not None and up.max_unavailable != "":
            max_parallel = min(max_parallel, parse_max_unavailable(
                up.max_unavailable, len(nodes)))
        if self.pacer is not None:
            paced = self.pacer.upgrade_budget(len(nodes))
            if paced is not None and paced < max_parallel:
                if self.metrics is not None:
                    self.metrics.goodput_pacing_throttled_total.labels(
                        "upgrade").inc()
                max_parallel = paced
        if self.metrics is not None:
            self.metrics.goodput_effective_budget.labels(
                "upgrade").set(max_parallel)
        self._snapshot_pods(resource)

        # pass 1: derive stages
        self._drain_timed_out.clear()
        stages = {}
        node_hash: dict[str, str] = {}
        for n in nodes:
            ds_hash = hash_by_product.get(
                n.labels.get(PRODUCT_LABEL, ""), base_hash)
            if ds_hash is None:
                stages[n.name] = DONE  # no installer serves this node
                continue
            node_hash[n.name] = ds_hash
            stages[n.name] = self._derive_stage(
                n, ds_hash, drain_timeout_s=up.drain_timeout_s())
        in_progress = sum(1 for s in stages.values()
                          if s in (DRAINING, POD_RESTART, VALIDATING, FAILED))
        status.available = sum(1 for s in stages.values()
                               if s == UPGRADE_REQUIRED)

        # pass 2: act, respecting the parallelism budget
        for node in nodes:
            stage = stages[node.name]
            if stage == DONE:
                status.done += 1
                if node.labels.get(STATE_LABEL) not in (None, DONE):
                    self._set_state_label(node, DONE)
            elif stage == UNCORDON:
                self._uncordon(node)
                status.done += 1
            elif stage == UPGRADE_REQUIRED:
                if in_progress >= max_parallel:
                    status.waiting += 1
                    stages[node.name] = WAITING
                    self._set_state_label(node, UPGRADE_REQUIRED)
                    continue
                in_progress += 1
                self._cordon(node, node_hash.get(node.name, ""))
                if up.drain_enabled():
                    self._evict(self._gpu_workload_pods(node.name))
                status.in_progress += 1
            elif stage == DRAINING:
                # a spec correction mid-drain restarts the timeout clock
                self._restamp_drain_window(node, node_hash.get(node.name, ""))
                if up.drain_enabled():
                    self._evict(self._gpu_workload_pods(node.name))
                # drain disabled: wait for GPU pods to finish on their own
                status.in_progress += 1
                # keep the label current: a node can re-enter DRAINING from
                # FAILED (spec-correction self-heal) long after _cordon
                self._set_state_label(node, DRAINING)
            elif stage == POD_RESTART:
                self._restart_installer(node)
                status.in_progress += 1
                self._set_state_label(node, POD_RESTART)
            elif stage == VALIDATING:
                status.in_progress += 1
                self._set_state_label(node, VALIDATING)
                # nothing to do: kubelet restarts the pod, validator re-runs;
                # next pass observes readiness and uncordons
            elif stage == FAILED:
                # keep the node cordoned (don't return workloads to a broken
                # library); hold its budget slot and flag for the operator
                status.failed += 1
                if node.name in self._drain_timed_out and \
                        node.labels.get(STATE_LABEL) != FAILED:
                    # the drain-timeout escape used to fall through silently;
                    # the transition into FAILED is the once-per-occurrence
                    # point to surface it
                    if self.metrics is not None:
                        self.metrics.drain_timeouts_total.inc()
                    if self.recorder is not None:
                        self.recorder.warning(
                            node, "DrainTimeout",
                            f"drain on {node.name} exceeded "
                            f"{up.drain_timeout_s()}s with GPU pods still "
                            f"running; node marked {FAILED} and kept "
                            f"cordoned")
                self._set_state_label(node, FAILED)
        status.stages = stages
        return status

    def _cleanup_labels(self):
        """autoUpgrade switched off → drop our state labels (reference:
        upgrade_controller.go:168-194). Reads the watch-maintained cache's
        shared raws when available (no per-pass LIST + deepcopy) and merge
        patches only nodes that actually carry our labels — on a converged
        cluster this touches nothing."""
        ro = getattr(self.client, "list_readonly", None)
        nodes = ro("Node") if ro is not None else None
        from_cache = nodes is not None
        if nodes is None:
            nodes = self.client.list("Node")
        memo = self._clean_memo
        for node in nodes:
            raw = node.raw
            # cache-served raws are replaced wholesale on change: identity
            # with the last known-clean raw means nothing to clean up
            if from_cache and memo.get(node.name) is raw:
                continue
            # defensive reads only: readonly raws are shared with the cache
            meta = raw.get("metadata") or {}
            labels = meta.get("labels") or {}
            anns = meta.get("annotations") or {}
            has_state = STATE_LABEL in labels
            cordoned = anns.get(CORDONED_BY_US) == "true"
            if not has_state and not cordoned:
                if from_cache:
                    memo[node.name] = raw
                continue
            memo.pop(node.name, None)
            patch: dict = {"metadata": {}}
            if has_state:
                patch["metadata"]["labels"] = {STATE_LABEL: None}
            if cordoned:
                patch["metadata"]["annotations"] = {
                    CORDONED_BY_US: None, DRAIN_START: None,
                    DRAIN_HASH: None}
                patch["spec"] = {"unschedulable": False}
            self.client.patch("Node", node.name, patch=patch)
        # prune entries for deleted nodes — under churn the memo would
        # otherwise pin every dead node's raw forever
        if from_cache and len(memo) > 0:
            live = {n.name for n in nodes}
            for name in [n for n in memo if n not in live]:
                del memo[name]
