"""Top-level reconciler for the GPUClusterPolicy singleton.

The port of ``tpu_operator/controllers/clusterpolicy_controller.py``.

Reference analogue: controllers/clusterpolicy_controller.go — fetch the CR,
enforce the singleton (oldest wins, extras marked ignored, :104-109), walk
the state machine, publish CR status, choose the requeue interval (5 s while
not ready :140,167; 45 s while no GPU nodes are detectable :173).

The run loop is level-triggered polling rather than watch-driven: with a 5 s
requeue already in the design, watches only save API reads, and the stdlib
client stays ~150 lines. The reconcile outcome is identical.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass

from tpu_operator_torch.api.v1alpha1 import State, GPUClusterPolicy
from tpu_operator_torch.kube.client import KubeClient, KubeError
from tpu_operator_torch.utils import trace
from .events import EventRecorder
from .leader import FencedClient, FencingError, LeaderElector
from .metrics import OperatorMetrics
from .state_manager import StateManager
from . import remediation_controller
from .remediation_controller import RemediationController
from .reshard_controller import ReshardController
from .upgrade_controller import UpgradeController

log = logging.getLogger("gpu-operator")

REQUEUE_NOT_READY_S = 5
REQUEUE_NO_NODES_S = 45
REQUEUE_READY_S = 60


@dataclass
class ReconcileResult:
    ready: bool
    requeue_after: float
    statuses: dict
    message: str = ""


class Reconciler:
    def __init__(self, client: KubeClient, namespace: str = "gpu-operator",
                 assets_dir: str | None = None,
                 metrics: OperatorMetrics | None = None,
                 cache: bool = False, max_workers: int | None = None,
                 tracer: trace.Tracer | None = None,
                 elector: LeaderElector | None = None):
        self.metrics = metrics or OperatorMetrics()
        self.tracer = tracer
        self.elector = elector
        if elector is not None:
            if elector.metrics is None:
                elector.metrics = self.metrics
            # fence BELOW the cache: a stale leader's write must die before
            # it can poison the write-through cache
            client = FencedClient(client, elector)
        self.cache = None
        if cache:
            # read-through object cache (kube/cache.py): opt-in because
            # unit tests mutate the fake cluster out-of-band between passes
            # and expect the very next reconcile to see it; production
            # entrypoints and the e2e harness turn it on
            from tpu_operator_torch.kube.cache import CachedKubeClient
            client = self.cache = CachedKubeClient(client,
                                                  metrics=self.metrics)
        self.client = client
        self.namespace = namespace
        self.recorder = EventRecorder(client, namespace)
        self.manager = StateManager(client, namespace, assets_dir,
                                    metrics=self.metrics)
        if max_workers is not None:
            self.manager.max_workers = max_workers
        self.upgrades = UpgradeController(client, namespace,
                                          recorder=self.recorder,
                                          metrics=self.metrics)
        self.remediation = RemediationController(client, namespace,
                                                 recorder=self.recorder,
                                                 metrics=self.metrics)
        # elastic resharding (reshard_controller.py): re-derives the live
        # (data, model) plan when remediation changes the surviving chip
        # count; the FSM's transition hook marks it dirty so pollers can
        # skip the wait for the next level-triggered pass
        self.resharding = ReshardController(client, namespace,
                                            recorder=self.recorder,
                                            metrics=self.metrics)
        self.remediation.on_transition = self.resharding.notify_transition
        # goodput engine (observability/goodput.py): scores the fleet off
        # the same cache-served signals each ready pass, and doubles as
        # the pacer the disruptive FSMs consult when spec.goodput.pacing
        # is on (it returns None verdicts otherwise)
        from tpu_operator_torch.observability.goodput import GoodputEngine
        self.goodput = GoodputEngine(client, namespace,
                                     metrics=self.metrics)
        self.upgrades.pacer = self.goodput
        self.remediation.pacer = self.goodput
        # /readyz truth: flips once the first reconcile pass has run the
        # state machine without erroring (ready_check for prom.serve)
        self.first_reconcile_ok = False
        # previous pass's per-state statuses, for transition Events
        self._prev_statuses: dict[str, str] = {}

    def is_ready(self) -> bool:
        return self.first_reconcile_ok

    # -- status plumbing --------------------------------------------------
    def _set_status(self, cr_obj, state: str, message: str = "",
                    extra: dict | None = None):
        """Write CR status only when it actually changed; lastTransitionTime
        moves only on a state transition (converged loop stays write-free).
        ``extra`` carries observability blocks (statesStatus, upgrades,
        slices) so `kubectl get -o yaml` answers "is the rollout stuck"
        without log-diving."""
        prev = cr_obj.raw.get("status", {})
        new = {
            "state": state,
            "namespace": self.namespace,
            "message": message,
        }
        for k, v in (extra or {}).items():
            if v:
                new[k] = v
        # control-plane facts, once detected (reference: OpenShift/k8s
        # version in CR conditions, state_manager.go:169-210)
        server = getattr(self.manager, "server", None)
        if server is not None and server.known:
            new["serverVersion"] = f"{server.major}.{server.minor}"
            new["clusterFlavor"] = server.flavor
        # full-dict comparison: a key present before but absent now (e.g. an
        # upgrade block after the rollout converged) must trigger a rewrite,
        # or the CR would forever show the stale in-flight state
        if {k: v for k, v in prev.items() if k != "lastTransitionTime"} \
                == new:
            return
        transition = prev.get("lastTransitionTime") \
            if prev.get("state") == state else None
        new["lastTransitionTime"] = transition or time.strftime(
            "%Y-%m-%dT%H:%M:%SZ", time.gmtime())
        # the CR may be a shared cache-served raw (list_readonly in
        # _singleton_guard): mutate a private copy, never the cached dict
        cr_obj = cr_obj.deepcopy()
        cr_obj.raw["status"] = new
        try:
            self.client.update_status(cr_obj)
        except KubeError as e:
            log.warning("status update failed: %s", e)

    def _singleton_guard(self) -> tuple:
        """Oldest CR wins; later ones get status=ignored. Served from the
        shared cache raws when available — the converged pass reads the CR
        without a deepcopy (writers must copy first, see _set_status)."""
        ro = getattr(self.client, "list_readonly", None)
        crs = ro("GPUClusterPolicy") if ro is not None else None
        if crs is None:
            crs = self.client.list("GPUClusterPolicy")
        if not crs:
            return None, []
        crs.sort(key=lambda o: (
            ((o.raw.get("metadata") or {}).get("creationTimestamp") or ""),
            o.name))
        return crs[0], crs[1:]

    # -- main entry -------------------------------------------------------
    def reconcile(self) -> ReconcileResult:
        """One pass, wrapped in a root "reconcile" span (when a tracer is
        attached) and timed into the reconcile-duration histogram. The span
        is active on this thread, so every state span (state_manager) and
        API-call span (cache/incluster) nests under it."""
        t0 = time.monotonic()
        root = (self.tracer.start_trace("reconcile")
                if self.tracer is not None else trace.NULL_SPAN)
        try:
            with root:
                if self.elector is not None \
                        and not self.elector.try_acquire():
                    result = ReconcileResult(
                        False, REQUEUE_NOT_READY_S, {},
                        "standby: another replica holds the leader lease")
                else:
                    try:
                        result = self._reconcile()
                    except FencingError as e:
                        # a write tripped the fence mid-pass: leadership
                        # moved while we were working. Abort cleanly — the
                        # new leader (next epoch) re-runs the pass; level-
                        # triggered reconcile makes the retry safe.
                        log.warning("reconcile fenced mid-pass: %s", e)
                        self.metrics.reconciliation_failed_total.inc()
                        result = ReconcileResult(
                            False, REQUEUE_NOT_READY_S, {}, str(e))
                root.set(ready=result.ready, message=result.message)
            return result
        finally:
            self.metrics.reconcile_seconds.observe(time.monotonic() - t0)

    def _record_transitions(self, cr_obj, statuses: dict[str, str]):
        """State Ready/NotReady transition Events on the CR — the durable
        `kubectl get events` record of the provisioning story. Sorted so
        Event names (which carry a creation serial) don't depend on the
        DAG walk's completion order."""
        for state, st in sorted(statuses.items()):
            prev = self._prev_statuses.get(state)
            if st == prev:
                continue
            if st == State.READY:
                self.recorder.normal(cr_obj, "StateReady",
                                     f"state {state} is ready")
            elif st == State.NOT_READY:
                self.recorder.warning(cr_obj, "StateNotReady",
                                      f"state {state} is not ready")
        self._prev_statuses = dict(statuses)

    def _reconcile(self) -> ReconcileResult:
        primary, extras = self._singleton_guard()
        for extra in extras:
            self._set_status(extra, State.IGNORED,
                             "only one GPUClusterPolicy is honored "
                             f"(active: {primary.name})")
        if primary is None:
            return ReconcileResult(False, REQUEUE_NO_NODES_S, {},
                                   "no GPUClusterPolicy found")

        policy = GPUClusterPolicy.from_obj(primary.raw)
        errs = policy.spec.validate()
        if errs:
            msg = "; ".join(errs)
            self._set_status(primary, State.NOT_READY, f"invalid spec: {msg}")
            self.metrics.reconciliation_failed_total.inc()
            self.metrics.reconciliation_status.set(-1)
            return ReconcileResult(False, REQUEUE_NOT_READY_S, {}, msg)

        writes_before = self._api_writes()
        try:
            self.manager.init(policy, primary)
            statuses = self.manager.run_all()
            self.metrics.state_apply_concurrency.set(
                self.manager.last_concurrency)
        except KubeError as e:
            log.error("reconcile error: %s", e)
            self.metrics.reconciliation_failed_total.inc()
            self.metrics.reconciliation_status.set(-1)
            self.recorder.warning(primary, "ReconcileFailed", str(e))
            self._set_status(primary, State.NOT_READY, str(e))
            return ReconcileResult(False, REQUEUE_NOT_READY_S, {}, str(e))

        self.first_reconcile_ok = True
        self._note_noop_fastpath(writes_before)
        self._record_transitions(primary, statuses)
        # degraded-mode accounting: run_all no longer aborts on the first
        # failing state — it completes the pass and reports per-state
        # errors, so one flaky apply can't mask the health of the rest
        state_errors = dict(self.manager.state_errors)
        conditions = self._degraded_condition(state_errors)
        if state_errors:
            self.metrics.degraded_passes_total.inc()
            failing = sorted(n for n, e in state_errors.items()
                             if not e.startswith("skipped:"))
            skipped = sorted(set(state_errors) - set(failing))
            msg = "degraded pass: " + ", ".join(
                f"{n}: {state_errors[n]}" for n in failing)
            if skipped:
                msg += f" (skipped dependents: {', '.join(skipped)})"
            self.recorder.warning(primary, "ReconcileDegraded", msg[:1024])
        self.metrics.has_gpu_labels.set(
            1 if self.manager.has_detection_labels else 0)
        not_ready = [s for s, st in statuses.items()
                     if st == State.NOT_READY]
        if self.manager.gpu_node_count == 0:
            # no GPU nodes yet: poll slowly until autoscaling/labeling brings
            # some (reference: 45 s NFD poll)
            self._set_status(primary, State.NOT_READY,
                             "no GPU nodes detected")
            self.metrics.observe(statuses, 0, ready=False,
                                 durations=self.manager.state_durations)
            return ReconcileResult(False, REQUEUE_NO_NODES_S, statuses,
                                   "no GPU nodes detected")
        if not_ready:
            msg = f"states not ready: {', '.join(sorted(not_ready))}"
            self._set_status(primary, State.NOT_READY, msg,
                             extra={"statesStatus": statuses,
                                    "stateErrors": state_errors,
                                    "conditions": conditions})
            self.metrics.observe(statuses, self.manager.gpu_node_count,
                                 ready=False,
                                 durations=self.manager.state_durations)
            return ReconcileResult(False, REQUEUE_NOT_READY_S, statuses, msg)

        # goodput is scored BEFORE the disruptive controllers run, so the
        # pacing verdicts they consult this pass reflect the fleet as it
        # stands, not as last pass left it
        goodput_status = {}
        try:
            report = self.goodput.observe(policy)
            goodput_status = self.goodput.status_block(report)
        except KubeError as e:
            log.warning("goodput evaluation failed: %s", e)

        # rolling driver upgrades only proceed on an otherwise-healthy
        # cluster (reference: upgrade reconciler is a separate loop; here one
        # healthy pass gates the next upgrade action)
        upgrades_status = {}
        try:
            up = self.upgrades.reconcile(policy)
            self.metrics.upgrades_in_progress.set(up.in_progress)
            self.metrics.upgrades_total.set(up.total)
            self.metrics.upgrades_done.set(up.done)
            self.metrics.upgrades_available.set(up.available)
            self.metrics.upgrades_pending.set(up.waiting)
            self.metrics.upgrades_failed.set(up.failed)
            upgrades_status = self._upgrades_status(up)
        except KubeError as e:
            log.warning("upgrade reconcile failed: %s", e)

        # health-driven auto-remediation rides the same healthy-pass gate:
        # quarantining nodes mid-rollout would fight the state machine
        remediation_status = {}
        rem = None
        try:
            rem = self.remediation.reconcile(policy)
            self.metrics.nodes_unhealthy.set(sum(
                1 for s in rem.stages.values()
                if s in (remediation_controller.QUARANTINE,
                         remediation_controller.WAITING,
                         remediation_controller.DRAINING,
                         remediation_controller.REMEDIATING,
                         remediation_controller.PERMANENT)))
            self.metrics.nodes_quarantined.set(rem.quarantined)
            remediation_status = self._remediation_status(rem)
        except KubeError as e:
            log.warning("remediation reconcile failed: %s", e)

        # resharding runs AFTER remediation so the plan reflects the
        # capacity changes this very pass made (quarantine shrinks,
        # reintegration re-expands — no one-pass lag)
        resharding_status = {}
        try:
            self.resharding.reconcile(policy, remediation=rem,
                                      primary=primary)
            resharding_status = self.resharding.status_block()
        except (KubeError, OSError) as e:
            log.warning("reshard reconcile failed: %s", e)

        self._set_status(primary, State.READY, "all states ready",
                         extra={"statesStatus": statuses,
                                "conditions": conditions,
                                "upgrades": upgrades_status,
                                "remediation": remediation_status,
                                "resharding": resharding_status,
                                "goodput": goodput_status,
                                "slices": self._slices_status()})
        self.metrics.observe(statuses, self.manager.gpu_node_count,
                             ready=True,
                             durations=self.manager.state_durations)
        return ReconcileResult(True, REQUEUE_READY_S, statuses,
                               "all states ready")

    # -- steady-state fast path accounting --------------------------------
    _WRITE_VERBS = ("create", "update", "update_status", "patch", "delete")

    def _api_writes(self) -> int:
        """Total write-verb API calls issued through the object cache (0
        when no cache is attached — the fastpath counter then never ticks,
        which is fine: without a cache there is no zero-read pass to
        celebrate either)."""
        if self.cache is None:
            return 0
        return sum(self.cache.api_reads(v) for v in self._WRITE_VERBS)

    def _note_noop_fastpath(self, writes_before: int):
        """Tick reconcile_noop_fastpath_total when the pass that just ran
        did zero work: every state compile was served from the desired-state
        cache, the node-label walk patched nothing, and no API write of any
        kind went out."""
        m = self.manager
        if self.cache is None or not getattr(m, "desired_cache_enabled",
                                             False):
            return
        if (m.last_compile_hits > 0 and m.last_compile_misses == 0
                and m.last_label_patches == 0
                and self._api_writes() == writes_before):
            self.metrics.reconcile_noop_fastpath_total.inc()

    @staticmethod
    def _degraded_condition(state_errors: dict[str, str]) -> list[dict]:
        """The `Degraded` condition for status.conditions: True when the
        last pass recorded any state error (partial statesStatus), False on
        a clean pass — always present, so `kubectl get -o yaml` answers
        "did something fail" without diffing statesStatus."""
        if not state_errors:
            return [{"type": "Degraded", "status": "False",
                     "reason": "AllStatesApplied",
                     "message": "last reconcile pass completed cleanly"}]
        failing = sorted(n for n, e in state_errors.items()
                         if not e.startswith("skipped:"))
        skipped = sorted(set(state_errors) - set(failing))
        msg = "failing: " + ", ".join(failing)
        if skipped:
            msg += "; skipped: " + ", ".join(skipped)
        return [{"type": "Degraded", "status": "True",
                 "reason": "StatesFailing", "message": msg}]

    @staticmethod
    def _upgrades_status(up) -> dict:
        """Per-stage node counts for status.upgrades — empty dict when no
        upgrade is in flight (everything done), so a converged CR stays
        clean."""
        if not up.total or up.done == up.total:
            return {}
        from collections import Counter
        counts = dict(Counter(up.stages.values()))
        counts["total"] = up.total
        counts["done"] = up.done
        return counts

    @staticmethod
    def _remediation_status(rem) -> dict:
        """Per-stage node counts for status.remediation — empty when every
        node is healthy (converged CR stays clean)."""
        if not rem.total or rem.healthy == rem.total:
            return {}
        from collections import Counter
        counts = dict(Counter(rem.stages.values()))
        counts["total"] = rem.total
        counts["quarantined"] = rem.quarantined
        return counts

    def _slices_status(self) -> dict:
        """Per-node slice reconcile state (status.slices) from the labels
        the slice manager maintains — collected during the state manager's
        node pass, no extra LIST."""
        return dict(getattr(self.manager, "slice_states", {}) or {})
