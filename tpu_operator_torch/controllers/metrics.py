"""Operator-level Prometheus metrics.

The port of ``tpu_operator/controllers/metrics.py``: the same families
under the upstream GPU Operator's ``gpu_operator_`` prefix (reference
analogue: controllers/operator_metrics.go:36-48), ``tpu`` in a family name
read as ``gpu``, the driver where the reference upgrades libtpu.
"""

from __future__ import annotations

import time

from tpu_operator_torch.utils.prom import Counter, Gauge, Histogram, Registry

# latency buckets tuned to this operator's scale: a cache hit is tens of
# microseconds, a wire API call single-digit milliseconds, a full reconcile
# pass tens of milliseconds to seconds on a loaded apiserver
LATENCY_BUCKETS = (0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                   0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)

# remediation timescales are operational, not request-latency: seconds for
# the detect→quarantine hop, minutes-to-hours for full recovery
MTTR_BUCKETS = (1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
                1200.0, 3600.0, 7200.0, 21600.0)


class OperatorMetrics:
    def __init__(self, registry: Registry | None = None):
        reg = registry or Registry()
        self.registry = reg
        self.gpu_nodes_total = Gauge(
            "gpu_operator_gpu_nodes_total",
            "Number of GPU nodes in the cluster", registry=reg)
        self.reconciliation_status = Gauge(
            "gpu_operator_reconciliation_status",
            "1=ready, 0=notReady, -1=failed", registry=reg)
        self.reconciliation_total = Counter(
            "gpu_operator_reconciliation_total",
            "Total reconciliation passes", registry=reg)
        self.reconciliation_failed_total = Counter(
            "gpu_operator_reconciliation_failed_total",
            "Reconciliation passes that errored", registry=reg)
        self.reconciliation_last_success = Gauge(
            "gpu_operator_reconciliation_last_success_ts_seconds",
            "Unix time of last successful reconcile", registry=reg)
        self.has_gpu_labels = Gauge(
            "gpu_operator_reconciliation_has_gpu_labels",
            "1 when any node carries a GPU detection label "
            "(NFD's pci-10de.present, gke-accelerator or "
            "nvidia.com/gpu.present) — "
            "0 means discovery has nothing to work with",
            registry=reg)
        self.state_status = Gauge(
            "gpu_operator_state_status",
            "Per-state status: 1=ready 0=notReady -1=disabled",
            labelnames=("state",), registry=reg)
        self.state_apply_seconds = Gauge(
            "gpu_operator_state_apply_seconds",
            "Wall seconds the last reconcile spent applying each state — "
            "the per-state breakdown of time-to-ready",
            labelnames=("state",), registry=reg)
        self.state_apply_concurrency = Gauge(
            "gpu_operator_state_apply_concurrency",
            "Peak number of states the DAG scheduler had in flight at once "
            "during the last reconcile (1 = serial walk)", registry=reg)
        self.cache_hits_total = Counter(
            "gpu_operator_cache_hits_total",
            "Reads served by the kube object cache without an API call",
            registry=reg)
        self.cache_misses_total = Counter(
            "gpu_operator_cache_misses_total",
            "Reads the kube object cache had to forward to the API",
            registry=reg)
        # steady-state fast path (desired-state compilation cache,
        # controllers/state_manager.py): a converged pass should be all
        # hits plus one noop-fastpath tick per reconcile
        self.desired_cache_hits_total = Counter(
            "gpu_operator_desired_cache_hits_total",
            "State compilations served from the desired-state cache "
            "(deepcopy/transform/canonicalize/hash skipped entirely)",
            registry=reg)
        self.desired_cache_misses_total = Counter(
            "gpu_operator_desired_cache_misses_total",
            "State compilations that ran because an input fingerprint "
            "changed (or the cache is cold/disabled)", registry=reg)
        self.reconcile_noop_fastpath_total = Counter(
            "gpu_operator_reconcile_noop_fastpath_total",
            "Reconcile passes that did zero work: every state compile was "
            "a cache hit and no API write was issued", registry=reg)
        self.api_requests_total = Counter(
            "gpu_operator_api_requests_total",
            "API-server requests actually issued, by verb and kind — a "
            "converged reconcile pass should add zero get/list entries",
            labelnames=("verb", "kind"), registry=reg)
        # latency histograms: the distributions behind time-to-ready (the
        # reference exports these through controller-runtime; the e2e
        # harness reports p50/p99 straight off these buckets)
        self.reconcile_seconds = Histogram(
            "gpu_operator_reconciliation_duration_seconds",
            "Wall-clock duration of full reconcile passes",
            registry=reg, buckets=LATENCY_BUCKETS)
        self.state_apply_duration = Histogram(
            "gpu_operator_state_apply_duration_seconds",
            "Per-state apply latency distribution across passes (the "
            "_seconds gauge above is only the last pass)",
            labelnames=("state",), registry=reg, buckets=LATENCY_BUCKETS)
        self.api_request_seconds = Histogram(
            "gpu_operator_api_request_duration_seconds",
            "Client-observed latency of live API requests, by verb/kind",
            labelnames=("verb", "kind"), registry=reg,
            buckets=LATENCY_BUCKETS)
        self.cache_lookup_seconds = Histogram(
            "gpu_operator_cache_lookup_seconds",
            "Object-cache lookup latency by op (get/list); misses include "
            "the live fill",
            labelnames=("op",), registry=reg, buckets=LATENCY_BUCKETS)
        # fault-tolerance families (kube/retry.py, kube/chaos.py,
        # degraded-mode reconcile): how hard the operator is fighting the
        # control plane, and whether it is winning
        self.api_retries_total = Counter(
            "gpu_operator_api_retries_total",
            "API requests re-issued after a transient failure, by verb "
            "and kind (the retry layer's backoff loop)",
            labelnames=("verb", "kind"), registry=reg)
        self.circuit_open_total = Counter(
            "gpu_operator_circuit_open_total",
            "Times the API circuit breaker tripped open (fast-fail mode) "
            "after consecutive transient failures", registry=reg)
        self.circuit_state = Gauge(
            "gpu_operator_circuit_state",
            "API circuit breaker state: 0=closed, 1=open, 2=half-open",
            registry=reg)
        self.degraded_passes_total = Counter(
            "gpu_operator_degraded_passes_total",
            "Reconcile passes that completed with at least one state "
            "failing (partial statesStatus published, Degraded condition "
            "set)", registry=reg)
        self.chaos_injected_total = Counter(
            "gpu_operator_chaos_injected_total",
            "Faults injected by the client-side chaos wrapper, by fault "
            "(HTTP code, latency, drop, gone) — nonzero only under "
            "--chaos-* flags or the chaos harness",
            labelnames=("fault",), registry=reg)
        # driver upgrade FSM gauges (reference: the six upgrade gauges,
        # operator_metrics.go:36-48 / upgrade_controller.go:144-151)
        self.upgrades_in_progress = Gauge(
            "gpu_operator_node_upgrades_in_progress",
            "Nodes currently upgrading the driver", registry=reg)
        self.upgrades_total = Gauge(
            "gpu_operator_node_upgrades_total",
            "GPU nodes governed by the upgrade controller", registry=reg)
        self.upgrades_done = Gauge(
            "gpu_operator_node_upgrades_done",
            "Nodes on the current driver installer spec", registry=reg)
        self.upgrades_available = Gauge(
            "gpu_operator_node_upgrades_available",
            "Nodes that need an upgrade and are eligible to start",
            registry=reg)
        self.upgrades_pending = Gauge(
            "gpu_operator_node_upgrades_pending",
            "Nodes waiting on the maxParallelUpgrades budget", registry=reg)
        self.upgrades_failed = Gauge(
            "gpu_operator_node_upgrades_failed",
            "Nodes whose driver upgrade is crash-looping", registry=reg)
        # drain-timeout escape: a node released from DRAINING by the
        # deadline is an incident signal, not a silent fallthrough
        self.drain_timeouts_total = Counter(
            "gpu_operator_drain_timeouts_total",
            "Drains abandoned because drain.timeoutSeconds expired with "
            "GPU pods still running (the node goes upgrade-failed)",
            registry=reg)
        # health/remediation families (controllers/remediation_controller.py
        # off the health monitor's nvidia.com/GPUHealthy condition)
        self.nodes_unhealthy = Gauge(
            "gpu_operator_nodes_unhealthy",
            "GPU nodes currently reporting nvidia.com/GPUHealthy=False",
            registry=reg)
        self.nodes_quarantined = Gauge(
            "gpu_operator_nodes_quarantined",
            "GPU nodes the remediation controller holds cordoned+tainted",
            registry=reg)
        self.remediation_transitions_total = Counter(
            "gpu_operator_remediation_transitions_total",
            "Remediation FSM stage entries, by stage",
            labelnames=("stage",), registry=reg)
        self.remediation_budget_deferred_total = Counter(
            "gpu_operator_remediation_budget_deferred_total",
            "Quarantine admissions deferred by the disruption budget or "
            "the last-node-in-slice guard", registry=reg)
        self.remediation_permanent_total = Counter(
            "gpu_operator_remediation_permanent_total",
            "Nodes marked permanent-failure after exhausting remediation "
            "retries", registry=reg)
        self.time_to_quarantine_seconds = Histogram(
            "gpu_operator_time_to_quarantine_seconds",
            "Unhealthy-condition transition → node cordoned (detection + "
            "admission latency)", registry=reg, buckets=MTTR_BUCKETS)
        self.time_to_recover_seconds = Histogram(
            "gpu_operator_time_to_recover_seconds",
            "Unhealthy-condition transition → node uncordoned after "
            "passing the validator gate (full MTTR)",
            registry=reg, buckets=MTTR_BUCKETS)
        # fleet-scale sharding + HA families (controllers/sharding.py,
        # controllers/leader.py, the sharded per-node hot paths)
        self.reconcile_shard_nodes = Gauge(
            "gpu_operator_reconcile_shard_nodes",
            "Nodes owned by each consistent-hash shard in the last "
            "per-node walk (shard \"0\" carries the whole fleet on the "
            "serial path)", labelnames=("shard",), registry=reg)
        self.shard_rebalance_total = Counter(
            "gpu_operator_shard_rebalance_total",
            "Memo entries that changed shard ownership across ring "
            "resizes — consistent hashing keeps this near K/N per resize, "
            "not K", registry=reg)
        self.leader_transitions_total = Counter(
            "gpu_operator_leader_transitions_total",
            "Times this process acquired leadership (first election and "
            "every takeover from a lapsed holder)", registry=reg)
        self.node_walk_duration_seconds = Histogram(
            "gpu_operator_node_walk_duration_seconds",
            "Wall-clock duration of the per-node label walk, by mode "
            "(serial vs sharded) — the fleet-scale harness reports its "
            "speedup off these", labelnames=("mode",), registry=reg,
            buckets=LATENCY_BUCKETS)
        # goodput families (observability/goodput.py): the fleet
        # productivity decomposition and the pacing loop built on it
        self.goodput_score = Gauge(
            "gpu_operator_goodput_score",
            "Fleet ML Productivity Goodput in [0,1]: chip-weighted mean of "
            "per-slice availability x efficiency x overhead", registry=reg)
        self.goodput_component = Gauge(
            "gpu_operator_goodput_component",
            "Fleet goodput decomposition, by component (availability, "
            "efficiency, overhead) — which term pulled the score down",
            labelnames=("component",), registry=reg)
        self.goodput_slice_score = Gauge(
            "gpu_operator_goodput_slice_score",
            "Per-slice goodput in [0,1] (0 below the availability quorum "
            "— the slice cannot host its collective)",
            labelnames=("slice",), registry=reg)
        self.goodput_floor = Gauge(
            "gpu_operator_goodput_floor",
            "Configured goodput floor (spec.goodput.floor): at or below "
            "it, pacing freezes new disruptive actions", registry=reg)
        self.goodput_degraded_slices = Gauge(
            "gpu_operator_goodput_degraded_slices",
            "Slices currently scoring below the goodput floor",
            registry=reg)
        self.goodput_time_degraded_seconds = Histogram(
            "gpu_operator_goodput_time_degraded_seconds",
            "Duration of per-slice degradation episodes (score below the "
            "floor), observed when the episode ends",
            registry=reg, buckets=MTTR_BUCKETS)
        self.goodput_pacing_throttled_total = Counter(
            "gpu_operator_goodput_pacing_throttled_total",
            "Passes where goodput pacing clamped a disruption budget "
            "below its static threshold, by controller",
            labelnames=("controller",), registry=reg)
        self.goodput_effective_budget = Gauge(
            "gpu_operator_goodput_effective_budget",
            "Disruption budget actually in force after goodput pacing, "
            "by controller (equals the static threshold while pacing is "
            "off)", labelnames=("controller",), registry=reg)
        # elastic resharding families (controllers/reshard_controller.py):
        # the live (data, model) plan and its transitions
        self.reshard_generation = Gauge(
            "gpu_operator_reshard_generation",
            "Generation counter of the published (data, model) plan — "
            "monotone; a step marks a topology cutover", registry=reg)
        self.reshard_chips = Gauge(
            "gpu_operator_reshard_chips",
            "Surviving chips the current plan is derived from",
            registry=reg)
        self.reshard_plan_size = Gauge(
            "gpu_operator_reshard_plan_size",
            "Current plan extent, by axis (data, model) — "
            "data x model = surviving chips", labelnames=("axis",),
            registry=reg)
        self.reshard_transitions_total = Counter(
            "gpu_operator_reshard_transitions_total",
            "Plan publications, by direction (shrink on quarantine, "
            "expand on reintegration)", labelnames=("direction",),
            registry=reg)
        self.reshard_in_flight = Gauge(
            "gpu_operator_reshard_in_flight",
            "1 while a plan publication (file + labels + subscriber "
            "notifications) is in progress — the autoscaler holds scale "
            "decisions while this is up", registry=reg)
        self.reshard_duration_seconds = Histogram(
            "gpu_operator_reshard_duration_seconds",
            "Wall-clock duration of plan publications (file write + "
            "label stamping + subscriber fan-out)",
            registry=reg, buckets=LATENCY_BUCKETS)
        # reconcile-trace ring-buffer hygiene: eviction of a
        # finished trace before anyone exported it used to be silent
        self.traces_dropped_total = Counter(
            "gpu_operator_traces_dropped_total",
            "Finished reconcile traces evicted from the tracer ring "
            "buffer before export (raise the Tracer keep bound if "
            "nonzero while debugging)", registry=reg)
        # build identity (standard Prometheus convention: a constant 1
        # gauge whose labels carry the version facts)
        self.build_info = Gauge(
            "gpu_operator_build_info",
            "Always 1; labels carry the operator version, git SHA and "
            "Python runtime",
            labelnames=("version", "git_sha", "python"), registry=reg)

    def set_build_info(self):
        """Stamp the build_info gauge from the package version, the git
        SHA baked into the environment (GIT_SHA, set by the image build;
        'unknown' otherwise) and the Python runtime."""
        import os
        import platform
        from tpu_operator_torch import __version__
        self.build_info.labels(
            __version__, os.environ.get("GIT_SHA", "unknown"),
            platform.python_version()).set(1)

    def observe(self, statuses: dict[str, str], gpu_nodes: int, ready: bool,
                durations: dict[str, float] | None = None):
        from tpu_operator_torch.api.v1alpha1 import State
        self.gpu_nodes_total.set(gpu_nodes)
        self.reconciliation_total.inc()
        self.reconciliation_status.set(1 if ready else 0)
        for state, st in statuses.items():
            v = {State.READY: 1, State.NOT_READY: 0,
                 State.DISABLED: -1}.get(st, 0)
            self.state_status.labels(state).set(v)
        for state, secs in (durations or {}).items():
            self.state_apply_seconds.labels(state).set(round(secs, 6))
            self.state_apply_duration.labels(state).observe(secs)
        if ready:
            self.reconciliation_last_success.set(time.time())
