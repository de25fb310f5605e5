"""GPUClusterPolicy CRD types — the whole config surface.

The port of ``tpu_operator/api/v1alpha1.py`` (``TPUClusterPolicy`` →
``GPUClusterPolicy``, group ``nvidia.com``): a cluster-scoped singleton
whose sub-specs map one-to-one onto the operand states, as the upstream
GPU operator's ClusterPolicy (api/v1/clusterpolicy_types.go:35-79):

  driver            (reference: libtpu)       stage libcuda.so.1 on the host
  containerToolkit  (reference: runtimeHook)  containerd drop-in + CDI spec
  devicePlugin      → nvidia.com/gpu over the kubelet gRPC API
  featureDiscovery  → GFD's nvidia.com/gpu.* labels
  sliceManager      → NVLink groups of whole cards (not MIG)
  metricsAgent      → the native NVML metrics daemon
  metricsExporter   → the Prometheus exporter
  nodeStatusExporter→ the validator's metrics mode
  validator         → the node validator (CUDA kernels, collectives)
  multinode         (reference: multislice)   worker identity for jobs

Every class, default and validation rule is the reference's under these
names; ``tests/test_torch_api.py`` holds the two equal through the name map
(``tests/torch_names.py``). ``relay`` is copied too: it is opt-in and its
operand is not ported yet.

Defaulting philosophy follows the reference (IsEnabled nil-defaulting,
clusterpolicy_types.go:1567-1756): omitted blocks mean "enabled with
defaults" for core states, "disabled" for optional ones.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass, field, fields, is_dataclass

#: where the health monitor writes the unhealthy GPU indices, one a line;
#: the device plugin's ``GpuDiscovery`` reads it
DEFAULT_HEALTH_FILE = "/run/nvidia/gpu-health"

class ValidationError(Exception):
    pass


_CAMEL_RE = re.compile(r"_([a-z])")


def _camel(s: str) -> str:
    return _CAMEL_RE.sub(lambda m: m.group(1).upper(), s)


def _snake(s: str) -> str:
    return re.sub(r"([A-Z])", lambda m: "_" + m.group(1).lower(), s)


class SpecBase:
    """dict ⇄ dataclass round-trip with camelCase keys; unknown keys are
    preserved on a side channel so user manifests survive a
    read-modify-write."""

    @classmethod
    def from_dict(cls, d: dict | None):
        d = d or {}
        kwargs, extra = {}, {}
        names = {f.name: f for f in fields(cls)}
        for k, v in d.items():
            name = _snake(k)
            f = names.get(name)
            if f is None:
                extra[k] = v
                continue
            sub = _SPEC_TYPES.get(name)
            if sub is not None and isinstance(v, dict):
                kwargs[name] = sub.from_dict(v)
            else:
                kwargs[name] = v
        obj = cls(**kwargs)
        obj._extra = extra
        return obj

    def to_dict(self) -> dict:
        out = dict(getattr(self, "_extra", {}))
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if is_dataclass(v):
                v = v.to_dict()
                if not v:
                    continue
            out[_camel(f.name)] = v
        return out


@dataclass
class ComponentSpec(SpecBase):
    """Fields shared by every operand (reference: the repeated
    repository/image/version/imagePullPolicy/env block on each spec)."""
    enabled: bool | None = None
    repository: str | None = None
    image: str | None = None
    version: str | None = None
    image_pull_policy: str = "IfNotPresent"
    image_pull_secrets: list = field(default_factory=list)
    env: list = field(default_factory=list)          # [{name, value}]
    resources: dict | None = None
    args: list = field(default_factory=list)

    DEFAULT_ENABLED = True   # core states default on

    def is_enabled(self) -> bool:
        if self.enabled is None:
            return self.DEFAULT_ENABLED
        return bool(self.enabled)


@dataclass
class HealthMonitorSpec(ComponentSpec):
    """Node health surveillance operand (reference analogue: DCGM health
    checks feeding node conditions). Probes — device presence, per-GPU
    NVLink state, counter thresholds, optional bounded HBM sweep — run
    every ``intervalSeconds``; results pass a hysteresis filter before
    anything is published, so a flapping probe cannot oscillate the node
    condition."""
    interval_seconds: int = 30
    # hysteresis windows: a GPU/node must observe CONTINUOUSLY bad for
    # unhealthyAfterSeconds before the published state flips to unhealthy,
    # and continuously good for healthyAfterSeconds before it flips back
    unhealthy_after_seconds: int = 60
    healthy_after_seconds: int = 120
    # counter name → max tolerated value (NVML counters, e.g.
    # {"ecc_uncorrected_volatile": 0})
    counter_thresholds: dict = field(default_factory=dict)
    # opt-in bounded HBM bandwidth sweep via ops/hbm.py (needs a quiesced
    # card; keep off where workloads share the device)
    hbm_sweep: dict = field(default_factory=dict)  # {enable, sizeMb, minGbps}
    # one unhealthy GPU index per line; consumed by the device plugin
    # (GpuDiscovery health_file)
    health_file: str = DEFAULT_HEALTH_FILE

    def hbm_sweep_enabled(self) -> bool:
        return bool(self.hbm_sweep.get("enable", False))


# ---------------------------------------------------------------------------
# state enum (reference: State ignored/ready/notReady/disabled,
# clusterpolicy_types.go:1407-1419)

class State:
    IGNORED = "ignored"
    READY = "ready"
    NOT_READY = "notReady"
    DISABLED = "disabled"


# ---------------------------------------------------------------------------
# component sub-specs


@dataclass
class OperatorSpec(SpecBase):
    default_runtime: str = "containerd"
    runtime_class: str = "nvidia"
    init_container_image: str | None = None
    use_precompiled_headers: bool | None = None  # accepted, unused (parity)


@dataclass
class DaemonsetsSpec(SpecBase):
    """Common knobs stamped onto every operand DaemonSet (reference:
    applyCommonDaemonsetConfig via Daemonsets spec)."""
    tolerations: list = field(default_factory=lambda: [
        {"key": "nvidia.com/gpu", "operator": "Exists", "effect": "NoSchedule"},
    ])
    priority_class_name: str = "system-node-critical"
    labels: dict = field(default_factory=dict)
    annotations: dict = field(default_factory=dict)
    update_strategy: str = "RollingUpdate"
    rolling_update: dict = field(default_factory=lambda: {"maxUnavailable": "1"})


@dataclass
class DriverSpec(ComponentSpec):
    """The driver state: stages the driver's user-space libraries
    (``libcuda.so.1`` and the files beside it) into the host's install dir
    and checks them (``gpu-node-agent driver-install``). The kernel module
    is the host's; "driver ready" means the library is staged and loadable
    and the cards' device nodes are present (SURVEY.md §7 hard part a).
    """
    install_dir: str = "/home/kubernetes/bin"
    required_version: str | None = None
    device_glob: str = "/dev/nvidia[0-9]*"
    # GPU product → driver version. Non-empty ⇒ the installer DaemonSet
    # fans out per distinct ``nvidia.com/gpu.product`` node value (feature
    # discovery's label), each clone pinned to its version — the
    # reference's precompiled-driver-per-kernel fan-out
    # (object_controls.go:3142-3173)
    version_map: dict = field(default_factory=dict)


@dataclass
class ContainerToolkitSpec(ComponentSpec):
    """The container-toolkit state: containerd drop-in + CDI spec so pods
    get /dev/nvidia*, libcuda.so.1 and the workload env without privileged
    mode (``gpu-node-agent runtime-configure``, ``gpu-oci-hook``)."""
    containerd_config: str = "/etc/containerd/config.toml"
    containerd_socket: str = "/run/containerd/containerd.sock"
    # None = decide from the server version (CDI device injection needs
    # k8s>=1.28 / containerd 1.7); an explicit true/false always wins
    cdi_enabled: bool | None = None
    cdi_spec_dir: str = "/etc/cdi"


@dataclass
class DevicePluginSpec(ComponentSpec):
    resource_name: str = "nvidia.com/gpu"
    # further resource names the plugin answers to (the reference's
    # google.com/tpu); a GPU node has none by default
    compat_resource_names: list = field(default_factory=list)
    plugin_dir: str = "/var/lib/kubelet/device-plugins"


@dataclass
class FeatureDiscoverySpec(ComponentSpec):
    interval_seconds: int = 60
    # non-empty → also publish facts as an NFD local-feature file at this
    # host path (GFD's publishing mechanism; empty = direct node patching)
    nfd_feature_dir: str = ""


@dataclass
class SliceManagerSpec(ComponentSpec):
    """MIG-manager analogue: reconciles the nvidia.com/slice.config node
    label into NVLink groups of whole cards (SURVEY.md §2.3)."""
    config_map: str = "default-slice-config"
    default_profile: str = "full"


@dataclass
class MetricsAgentSpec(ComponentSpec):
    port: int = 9401


@dataclass
class MetricsExporterSpec(ComponentSpec):
    port: int = 9400
    service_monitor: dict = field(default_factory=dict)  # {enabled, interval}

    def service_monitor_enabled(self) -> bool:
        return bool(self.service_monitor.get("enabled", False))


@dataclass
class NodeStatusExporterSpec(ComponentSpec):
    DEFAULT_ENABLED = False


@dataclass
class ValidatorSpec(ComponentSpec):
    """Validation workload knobs: matmul shape for the tensor-core probe,
    payload for the collective check (reference analogue: cuda/plugin
    validation, validator/main.go:1170-1287)."""
    workload_matmul_dim: int = 4096
    workload_collective_mb: int = 64
    # Fail validation below this fraction of peak bf16 TFLOP/s. On by
    # default: a card delivering half of spec is unhealthy and must not
    # validate green (reference analogue: validator health gauges,
    # validator/metrics.go:73-157).
    min_efficiency: float = 0.5
    # Data-sheet denominator overrides for the efficiency gate; None = look
    # up by the card's name (ops/matmul.py, ops/hbm.py). Set these for
    # cards the table doesn't know — an unmatched lookup must be an audit
    # flag, not a silently-applied default.
    peak_tflops: float | None = None
    peak_hbm_gbps: float | None = None
    plugin_enabled: bool | None = None
    workload_enabled: bool | None = None
    fabric_enabled: bool | None = None   # NVLink/multi-node check
    fabric_mesh_port: int = 29500        # the fabric barrier's port


@dataclass
class MultinodeSpec(ComponentSpec):
    """Multi-node jobs: the container toolkit injects WORKER_ID,
    WORKER_HOSTNAMES and the rendezvous address torch.distributed reads
    (MASTER_ADDR, MASTER_PORT = coordinatorPort) into workload containers
    (SURVEY.md §2.4, §5 'distributed communication backend')."""
    DEFAULT_ENABLED = False
    coordinator_port: int = 8476


@dataclass
class RemediationSpec(SpecBase):
    """Controller-side auto-remediation of nodes the health monitor marks
    unhealthy (quarantine → drain → remediate → verify → reintegrate).
    Opt-in, like upgradePolicy.autoUpgrade."""
    enabled: bool = False
    # disruption budget: never quarantine more than this many GPU nodes at
    # once (absolute or percentage, same math as upgrade maxUnavailable);
    # nodes cordoned by the upgrade FSM count against it
    max_unavailable: str = "1"
    # drain.enable (default True): evict GPU pods from quarantined nodes;
    # drain.timeoutSeconds bounds the wait
    drain: dict = field(default_factory=dict)
    # per-attempt window for the node to come back healthy after drain;
    # doubles every retry (exponential per-node backoff)
    remediation_window_seconds: int = 600
    # attempts beyond this mark the node a permanent failure (labeled,
    # kept cordoned, surfaced via Warning Event + metric)
    max_retries: int = 3

    def drain_enabled(self) -> bool:
        return bool(self.drain.get("enable", True))

    def drain_timeout_s(self) -> int:
        try:
            return max(0, int(self.drain.get("timeoutSeconds", 0)))
        except (TypeError, ValueError):
            return 0

    def window_s(self, attempts: int) -> int:
        """Remediation window for attempt N: base * 2^N (capped)."""
        return self.remediation_window_seconds * (2 ** min(attempts, 6))


@dataclass
class ReshardingSpec(SpecBase):
    """Elastic slice resharding (Tenplex-style): when remediation changes
    the surviving card count, re-derive the live (data, model) plan via
    MeshPlan.auto and publish it atomically (partition file + nvidia.com/plan.*
    node labels + status.resharding generation) so the relay tier can
    pre-warm for the new shard shapes before cutover. Opt-in, like
    remediation — the loop closure only makes sense where remediation is
    driving capacity changes."""
    enabled: bool = False
    # published plan document, consumed by PlanWatcher in the relay CLI;
    # written tmp+os.replace like the slice-partition file
    plan_file: str = "/run/nvidia/reshard-plan.json"
    # widest model-parallel axis MeshPlan.auto may pick
    max_model: int = 8
    # fallback cards-per-node when a node lacks the nvidia.com/gpu.count
    # label (feature discovery not yet converged)
    chips_per_node: int = 4


@dataclass
class GoodputSpec(SpecBase):
    """ML Productivity Goodput scoring + pacing knobs (observability/
    goodput.py). Scoring is on by default — it is pure observation with
    zero API cost on a converged fleet; ``pacing`` (the loop closure that
    replaces the static disruption thresholds) is opt-in, like
    upgradePolicy.autoUpgrade and remediation.enabled."""
    enabled: bool = True
    # fleet score at or below which disruptive actions freeze (and below
    # which a slice counts as degraded for the time-in-degraded histogram)
    floor: float = 0.9
    # slice availability below this fraction scores 0 — a collective
    # cannot form on a minority of its hosts (the quorum cliff)
    quorum: float = 0.5
    # feed the score back into remediation/upgrade budget sizing and the
    # remediation attempt-window backoff
    pacing: bool = False


@dataclass
class RelaySpec(ComponentSpec):
    """Pooled relay data plane (the reference's tpu_operator/relay/, not
    ported yet): serves remote accelerator work to any pod through a
    channel pool + per-tenant admission
    control + dynamic batcher. Opt-in, like multislice — the serving front
    door is only wanted on clusters exposing the fleet to tenants."""
    DEFAULT_ENABLED = False
    port: int = 8479
    replicas: int = 2
    # channel pool: bounded dials, bounded concurrent streams per channel,
    # idle channels evicted after poolIdleTimeoutSeconds
    pool_max_channels: int = 8
    pool_max_streams: int = 16
    pool_idle_timeout_seconds: int = 300
    # per-tenant token bucket (the fairness floor) + bounded queue
    admission_rate: float = 100.0
    admission_burst: float = 200.0
    admission_queue_depth: int = 64
    # dynamic batcher: coalesce same-(op,shape,dtype) requests up to
    # batchMaxSize or batchWindowMs, whichever first; requests at or above
    # bypassBytes skip coalescing (already link-saturating)
    batch_max_size: int = 8
    batch_window_ms: float = 5.0
    bypass_bytes: int = 1048576
    # idle tenants have their per-tenant metric series pruned after this
    tenant_idle_seconds: int = 600
    # serving fast path: "continuous" forms the next batch while
    # the previous executes (earliest-deadline-first, no flush-window
    # barrier); "window" keeps the flush-window batcher above
    scheduler: str = "continuous"
    # per-request latency SLO; requests whose deadline is provably
    # unmeetable are shed pre-deadline as retryable 429s. 0 disables
    # deadline scheduling/shedding entirely
    slo_ms: float = 50.0
    # pad shapes to power-of-two-ish buckets so diverse traffic shares
    # executables (and batches); the executable cache is LRU-bounded at
    # compileCacheEntries and spills evictions to compileCacheDir ("" =
    # in-memory only)
    shape_bucketing: bool = True
    compile_cache_entries: int = 128
    compile_cache_dir: str = ""
    # working set compiled at startup so first requests dispatch hot:
    # [{op, shape: [dims...], dtype}, ...]
    warm_start: list = field(default_factory=list)
    # per-request tracing + tail-sampled flight recorder:
    # tracing.enabled (default True — spans ride the serving clock and
    # cost <5% of p99), tracing.sampleRate (fraction of HEALTHY traces
    # retained; shed/miss/error/slow always retained), tracing.
    # slowThresholdMs (0 = adaptive p99), tracing.recorderEntries (ring
    # size per retention class), tracing.keepTraces (tracer ring size)
    tracing: dict = field(default_factory=dict)
    # replicated relay tier: the router consistent-hashes each
    # request's bucketed executable key onto the replica set so every
    # replica's compile cache stays hot. router.enabled (default False —
    # single-replica deployments need no front door), router.vnodes
    # (virtual ring points per replica; bucketed-key cardinality is low,
    # so the default is 2x the fleet-scale ring's), router.
    # capacityPerReplica (in-flight bound before saturation spillover),
    # router.spillover (second-choice fallback on a saturated owner),
    # router.port (the router's own serving port)
    router: dict = field(default_factory=dict)
    # goodput-driven horizontal autoscaler over the replica set:
    # autoscaler.enabled (default False), .minReplicas/.maxReplicas,
    # .lowMarginFrac/.highMarginFrac (SLO-margin dead band: below low →
    # scale up, above high → scale down), .upAfter/.downAfter
    # (consecutive-evaluation hysteresis), .cooldown (evaluations between
    # scale events), .evalIntervalSeconds (loop cadence)
    autoscaler: dict = field(default_factory=dict)
    # pinned-buffer arena: donated payloads and batch output
    # buffers come from size-class free lists instead of per-request
    # allocations. arena.enabled (default True — the zero-copy dispatch
    # path needs it), arena.blockBytes (smallest size class; leases round
    # up to the next power of two), arena.maxBlocks (free blocks retained
    # across all classes before releases fall through to the allocator)
    arena: dict = field(default_factory=dict)
    # multi-tenant QoS: qos.enabled (default False — classless
    # EDF preserved), qos.classes ([{name, weight, rateMultiplier,
    # priority}] — weight is the DWRR byte share of batch formation,
    # rateMultiplier scales the per-tenant admission budget, lower
    # priority = more important; empty = the built-in latency-critical/
    # standard/batch-best-effort trio), qos.tenantClassMap (tenant →
    # class name), qos.defaultClass (class for unmapped tenants)
    qos: dict = field(default_factory=dict)
    # multi-cell federation: a FederationRouter front door
    # over N cells, each a full router tier with its own replicas and
    # compile-cache dir. federation.enabled (default False — one cell
    # needs no front door), federation.port (the federation's own
    # serving port), federation.cells (cell count), federation.vnodes
    # (tenant-affinity ring points per cell), federation.spillCells
    # (next-choice cells tried on home-cell saturation; 429s/sheds
    # never spill), federation.headroomFloor (cells at or below this
    # goodput headroom score are frozen as spill targets), federation.
    # replicateCache (cross-cell hot compile-cache replication through
    # the write-through spill format), federation.cellClasses (latency
    # class per cell ordinal), federation.tenantClassMap (tenant →
    # preferred latency class), federation.tenantHomes (tenant →
    # explicit home cell pin, ahead of the ring)
    federation: dict = field(default_factory=dict)
    # utilization ledger: utilization.enabled (default False —
    # the capacity decomposition is opt-in observability), utilization.
    # deviceKindModelsJson (JSON object of per-kind roofline overrides,
    # {kind: {peakTflops, pinRateGbps, sustainedCeiling, launchOverheadS,
    # perItemS, compileS}}; "" = the calibrated built-in registry),
    # utilization.burnRateFloor (degradation event when the live
    # busy_ideal fraction falls below floor x baseline; doubles as the
    # low-utilization flight-recorder retention bar), utilization.
    # windowSeconds (burn-rate evaluation window)
    utilization: dict = field(default_factory=dict)
    # SPMD sharded dispatch: spmd.enabled (default False —
    # off keeps the monolithic single-call dispatch), spmd.partitionRules
    # (ordered [{pattern, axes}] list mapping op-name regexes to the mesh
    # axes they shard over, first re.search match wins; an implicit
    # catch-all shards both axes, so rules only name exceptions),
    # spmd.maxConcurrentShards (one dispatch wave's width — a plan whose
    # data x model fan-out exceeds it executes in successive waves)
    spmd: dict = field(default_factory=dict)
    # stateful sessions: sessions.enabled (default False —
    # off keeps every request one-shot), sessions.maxSessions (resident
    # KV caches per replica; crossing it preempts the LRU session via
    # spill — recoverable, never lost), sessions.pageBytes (KV bytes one
    # decode step appends; the lease-extent granularity), sessions.
    # spillDir (where preempted caches spill, atomic tmp+replace; ""
    # disables preemption — eviction then has nowhere safe to go),
    # sessions.classMap ({prefill|decode: QoS class name} overrides of
    # the built-in prefill=standard / decode=latency-critical mapping),
    # sessions.idleTimeoutSeconds (sessions idle past this expire; 0
    # never expires)
    sessions: dict = field(default_factory=dict)

    def qos_enabled(self) -> bool:
        return bool(self.qos.get("enabled", False))

    def qos_classes(self) -> list:
        c = self.qos.get("classes")
        return list(c) if isinstance(c, list) else []

    def qos_tenant_class_map(self) -> dict:
        m = self.qos.get("tenantClassMap")
        return dict(m) if isinstance(m, dict) else {}

    def qos_default_class(self) -> str:
        return str(self.qos.get("defaultClass", "standard"))

    def utilization_enabled(self) -> bool:
        return bool(self.utilization.get("enabled", False))

    def utilization_device_kind_models_json(self) -> str:
        v = self.utilization.get("deviceKindModelsJson", "")
        return v if isinstance(v, str) else ""

    def utilization_burn_rate_floor(self) -> float:
        try:
            return min(1.0, max(
                0.0, float(self.utilization.get("burnRateFloor", 0.5))))
        except (TypeError, ValueError):
            return 0.5

    def utilization_window_seconds(self) -> float:
        try:
            v = float(self.utilization.get("windowSeconds", 1.0))
            return v if v > 0 else 1.0
        except (TypeError, ValueError):
            return 1.0

    def spmd_enabled(self) -> bool:
        return bool(self.spmd.get("enabled", False))

    def spmd_partition_rules(self) -> list:
        rules = self.spmd.get("partitionRules")
        return list(rules) if isinstance(rules, list) else []

    def spmd_max_concurrent_shards(self) -> int:
        try:
            return max(1, int(self.spmd.get("maxConcurrentShards", 8)))
        except (TypeError, ValueError):
            return 8

    def sessions_enabled(self) -> bool:
        return bool(self.sessions.get("enabled", False))

    def sessions_max_sessions(self) -> int:
        try:
            return max(1, int(self.sessions.get("maxSessions", 64)))
        except (TypeError, ValueError):
            return 64

    def sessions_page_bytes(self) -> int:
        try:
            return max(64, int(self.sessions.get("pageBytes", 4096)))
        except (TypeError, ValueError):
            return 4096

    def sessions_spill_dir(self) -> str:
        v = self.sessions.get("spillDir", "")
        return v if isinstance(v, str) else ""

    def sessions_class_map(self) -> dict:
        m = self.sessions.get("classMap")
        return dict(m) if isinstance(m, dict) else {}

    def sessions_idle_timeout_seconds(self) -> float:
        try:
            return max(0.0, float(
                self.sessions.get("idleTimeoutSeconds", 300.0)))
        except (TypeError, ValueError):
            return 300.0

    def arena_enabled(self) -> bool:
        return bool(self.arena.get("enabled", True))

    def arena_block_bytes(self) -> int:
        try:
            return max(4096, int(self.arena.get("blockBytes", 65536)))
        except (TypeError, ValueError):
            return 65536

    def arena_max_blocks(self) -> int:
        try:
            return max(1, int(self.arena.get("maxBlocks", 256)))
        except (TypeError, ValueError):
            return 256

    def router_enabled(self) -> bool:
        return bool(self.router.get("enabled", False))

    def router_port(self) -> int:
        try:
            return max(1, int(self.router.get("port", 8480)))
        except (TypeError, ValueError):
            return 8480

    def router_vnodes(self) -> int:
        try:
            return max(1, int(self.router.get("vnodes", 128)))
        except (TypeError, ValueError):
            return 128

    def router_capacity_per_replica(self) -> int:
        try:
            return max(1, int(self.router.get("capacityPerReplica", 64)))
        except (TypeError, ValueError):
            return 64

    def router_spillover(self) -> bool:
        return bool(self.router.get("spillover", True))

    def router_spillover_depth(self) -> int:
        try:
            return max(1, int(self.router.get("spilloverDepth", 2)))
        except (TypeError, ValueError):
            return 2

    def federation_enabled(self) -> bool:
        return bool(self.federation.get("enabled", False))

    def federation_port(self) -> int:
        try:
            return max(1, int(self.federation.get("port", 8481)))
        except (TypeError, ValueError):
            return 8481

    def federation_cells(self) -> int:
        try:
            return max(1, int(self.federation.get("cells", 2)))
        except (TypeError, ValueError):
            return 2

    def federation_vnodes(self) -> int:
        try:
            return max(1, int(self.federation.get("vnodes", 64)))
        except (TypeError, ValueError):
            return 64

    def federation_spill_cells(self) -> int:
        try:
            return max(0, int(self.federation.get("spillCells", 1)))
        except (TypeError, ValueError):
            return 1

    def federation_headroom_floor(self) -> float:
        try:
            return min(1.0, max(
                0.0, float(self.federation.get("headroomFloor", 0.1))))
        except (TypeError, ValueError):
            return 0.1

    def federation_replicate_cache(self) -> bool:
        return bool(self.federation.get("replicateCache", True))

    def federation_cell_classes(self) -> list:
        v = self.federation.get("cellClasses")
        return list(v) if isinstance(v, list) else []

    def federation_tenant_class_map(self) -> dict:
        v = self.federation.get("tenantClassMap")
        return dict(v) if isinstance(v, dict) else {}

    def federation_tenant_homes(self) -> dict:
        v = self.federation.get("tenantHomes")
        return dict(v) if isinstance(v, dict) else {}

    def autoscaler_enabled(self) -> bool:
        return bool(self.autoscaler.get("enabled", False))

    def autoscaler_min_replicas(self) -> int:
        try:
            return max(1, int(self.autoscaler.get("minReplicas", 1)))
        except (TypeError, ValueError):
            return 1

    def autoscaler_max_replicas(self) -> int:
        try:
            return max(self.autoscaler_min_replicas(),
                       int(self.autoscaler.get("maxReplicas", 8)))
        except (TypeError, ValueError):
            return 8

    def autoscaler_low_margin_frac(self) -> float:
        try:
            return float(self.autoscaler.get("lowMarginFrac", 0.2))
        except (TypeError, ValueError):
            return 0.2

    def autoscaler_high_margin_frac(self) -> float:
        try:
            return float(self.autoscaler.get("highMarginFrac", 0.6))
        except (TypeError, ValueError):
            return 0.6

    def autoscaler_up_after(self) -> int:
        try:
            return max(1, int(self.autoscaler.get("upAfter", 2)))
        except (TypeError, ValueError):
            return 2

    def autoscaler_down_after(self) -> int:
        try:
            return max(1, int(self.autoscaler.get("downAfter", 3)))
        except (TypeError, ValueError):
            return 3

    def autoscaler_cooldown(self) -> int:
        try:
            return max(0, int(self.autoscaler.get("cooldown", 2)))
        except (TypeError, ValueError):
            return 2

    def autoscaler_eval_interval_s(self) -> int:
        try:
            return max(1, int(self.autoscaler.get(
                "evalIntervalSeconds", 15)))
        except (TypeError, ValueError):
            return 15

    def tracing_enabled(self) -> bool:
        return bool(self.tracing.get("enabled", True))

    def tracing_sample_rate(self) -> float:
        try:
            return min(1.0, max(
                0.0, float(self.tracing.get("sampleRate", 0.01))))
        except (TypeError, ValueError):
            return 0.01

    def tracing_slow_threshold_ms(self) -> float:
        try:
            return max(0.0, float(self.tracing.get("slowThresholdMs", 0.0)))
        except (TypeError, ValueError):
            return 0.0

    def tracing_recorder_entries(self) -> int:
        try:
            return max(1, int(self.tracing.get("recorderEntries", 256)))
        except (TypeError, ValueError):
            return 256

    def tracing_keep_traces(self) -> int:
        try:
            return max(1, int(self.tracing.get("keepTraces", 64)))
        except (TypeError, ValueError):
            return 64


@dataclass
class UpgradePolicySpec(SpecBase):
    auto_upgrade: bool = False
    max_parallel_upgrades: int = 1
    max_unavailable: str = "25%"
    wait_for_completion_timeout_seconds: int = 0
    pod_deletion: dict = field(default_factory=dict)
    # drain.enable (default True): evict GPU pods; False waits for them to
    # finish on their own. drain.timeoutSeconds (default 0 = unlimited):
    # a node still draining past the deadline goes upgrade-failed.
    drain: dict = field(default_factory=dict)

    def drain_enabled(self) -> bool:
        return bool(self.drain.get("enable", True))

    def drain_timeout_s(self) -> int:
        try:
            t = int(self.drain.get(
                "timeoutSeconds",
                # reference accepts the same deadline at the policy level
                self.wait_for_completion_timeout_seconds or 0))
            return max(0, t)
        except (TypeError, ValueError):
            return 0


@dataclass
class PSASpec(SpecBase):
    """Pod Security Admission labels for the operand namespace — the modern
    replacement for the reference's PodSecurityPolicy state (dropped in
    k8s 1.25, resource_manager.go:169; PSA labeling analogue:
    state_manager.go:589-637)."""
    enabled: bool = True
    enforce: str = "privileged"
    version: str = "latest"


_SPEC_TYPES = {
    "operator": OperatorSpec,
    "daemonsets": DaemonsetsSpec,
    "driver": DriverSpec,
    "container_toolkit": ContainerToolkitSpec,
    "device_plugin": DevicePluginSpec,
    "feature_discovery": FeatureDiscoverySpec,
    "slice_manager": SliceManagerSpec,
    "metrics_agent": MetricsAgentSpec,
    "metrics_exporter": MetricsExporterSpec,
    "node_status_exporter": NodeStatusExporterSpec,
    "health_monitor": HealthMonitorSpec,
    "validator": ValidatorSpec,
    "multinode": MultinodeSpec,
    "upgrade_policy": UpgradePolicySpec,
    "remediation": RemediationSpec,
    "resharding": ReshardingSpec,
    "goodput": GoodputSpec,
    "psa": PSASpec,
    "relay": RelaySpec,
}


# ---------------------------------------------------------------------------
# top-level spec


@dataclass
class GPUClusterPolicySpec(SpecBase):
    operator: OperatorSpec = field(default_factory=OperatorSpec)
    daemonsets: DaemonsetsSpec = field(default_factory=DaemonsetsSpec)
    driver: DriverSpec = field(default_factory=DriverSpec)
    container_toolkit: ContainerToolkitSpec = field(
        default_factory=ContainerToolkitSpec)
    device_plugin: DevicePluginSpec = field(default_factory=DevicePluginSpec)
    feature_discovery: FeatureDiscoverySpec = field(
        default_factory=FeatureDiscoverySpec)
    slice_manager: SliceManagerSpec = field(default_factory=SliceManagerSpec)
    metrics_agent: MetricsAgentSpec = field(default_factory=MetricsAgentSpec)
    metrics_exporter: MetricsExporterSpec = field(
        default_factory=MetricsExporterSpec)
    node_status_exporter: NodeStatusExporterSpec = field(
        default_factory=NodeStatusExporterSpec)
    health_monitor: HealthMonitorSpec = field(
        default_factory=HealthMonitorSpec)
    validator: ValidatorSpec = field(default_factory=ValidatorSpec)
    multinode: MultinodeSpec = field(default_factory=MultinodeSpec)
    upgrade_policy: UpgradePolicySpec = field(default_factory=UpgradePolicySpec)
    remediation: RemediationSpec = field(default_factory=RemediationSpec)
    resharding: ReshardingSpec = field(default_factory=ReshardingSpec)
    goodput: GoodputSpec = field(default_factory=GoodputSpec)
    psa: PSASpec = field(default_factory=PSASpec)
    relay: RelaySpec = field(default_factory=RelaySpec)
    sandbox_workloads: dict = field(default_factory=dict)  # rejected if enabled

    def component(self, name: str) -> ComponentSpec:
        return getattr(self, name)

    def validate(self) -> list[str]:
        errs = []
        if self.sandbox_workloads.get("enabled"):
            errs.append(
                "sandboxWorkloads (VM passthrough / vGPU) has no counterpart "
                "in this operator and must not be enabled; remove the block "
                "or set enabled: false (see SURVEY.md §2.3)")
        if self.operator.default_runtime not in ("containerd", "docker", "crio"):
            errs.append(f"operator.defaultRuntime "
                        f"{self.operator.default_runtime!r} not one of "
                        f"containerd|docker|crio")
        if self.device_plugin.resource_name.count("/") != 1:
            errs.append("devicePlugin.resourceName must be vendor/resource")
        if not (0.0 <= self.validator.min_efficiency <= 1.0):
            errs.append("validator.minEfficiency must be within [0, 1]")
        for fname in ("peak_tflops", "peak_hbm_gbps"):
            v = getattr(self.validator, fname)
            if v is not None and (not isinstance(v, (int, float))
                                  or isinstance(v, bool) or v <= 0):
                errs.append(f"validator.{_camel(fname)} must be a positive "
                            f"number")
        hm = self.health_monitor
        for fname in ("interval_seconds", "unhealthy_after_seconds",
                      "healthy_after_seconds"):
            v = getattr(hm, fname)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                errs.append(f"healthMonitor.{_camel(fname)} must be a "
                            f"positive integer")
        if not isinstance(hm.counter_thresholds, dict) or any(
                not k or not isinstance(t, (int, float))
                or isinstance(t, bool) or t < 0
                for k, t in hm.counter_thresholds.items()):
            errs.append("healthMonitor.counterThresholds must map counter "
                        "names to non-negative numbers")
        rem = self.remediation
        if not isinstance(rem.max_retries, int) or isinstance(
                rem.max_retries, bool) or rem.max_retries < 0:
            errs.append("remediation.maxRetries must be a non-negative "
                        "integer")
        if not isinstance(rem.remediation_window_seconds, int) or isinstance(
                rem.remediation_window_seconds, bool) or \
                rem.remediation_window_seconds <= 0:
            errs.append("remediation.remediationWindowSeconds must be a "
                        "positive integer")
        rs = self.resharding
        for fname in ("max_model", "chips_per_node"):
            v = getattr(rs, fname)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                errs.append(f"resharding.{_camel(fname)} must be a "
                            f"positive integer")
        if not isinstance(rs.plan_file, str) or not rs.plan_file:
            errs.append("resharding.planFile must be a non-empty path")
        gp = self.goodput
        for fname in ("floor", "quorum"):
            v = getattr(gp, fname)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or \
                    not (0.0 <= v <= 1.0):
                errs.append(f"goodput.{fname} must be within [0, 1]")
        rl = self.relay
        for fname in ("port", "replicas", "pool_max_channels",
                      "pool_max_streams", "pool_idle_timeout_seconds",
                      "admission_queue_depth", "batch_max_size",
                      "bypass_bytes", "tenant_idle_seconds"):
            v = getattr(rl, fname)
            if not isinstance(v, int) or isinstance(v, bool) or v <= 0:
                errs.append(f"relay.{_camel(fname)} must be a positive "
                            f"integer")
        for fname in ("admission_rate", "admission_burst",
                      "batch_window_ms"):
            v = getattr(rl, fname)
            if not isinstance(v, (int, float)) or isinstance(v, bool) or \
                    v <= 0:
                errs.append(f"relay.{_camel(fname)} must be a positive "
                            f"number")
        if rl.scheduler not in ("continuous", "window"):
            errs.append(f"relay.scheduler {rl.scheduler!r} not one of "
                        f"continuous|window")
        if not isinstance(rl.slo_ms, (int, float)) or \
                isinstance(rl.slo_ms, bool) or rl.slo_ms < 0:
            errs.append("relay.sloMs must be a non-negative number "
                        "(0 disables deadline scheduling)")
        if not isinstance(rl.compile_cache_entries, int) or isinstance(
                rl.compile_cache_entries, bool) or \
                rl.compile_cache_entries <= 0:
            errs.append("relay.compileCacheEntries must be a positive "
                        "integer")
        if not isinstance(rl.tracing, dict):
            errs.append("relay.tracing must be an object "
                        "({enabled, sampleRate, slowThresholdMs, "
                        "recorderEntries, keepTraces})")
        else:
            sr = rl.tracing.get("sampleRate", 0.01)
            if not isinstance(sr, (int, float)) or isinstance(sr, bool) or \
                    not (0.0 <= sr <= 1.0):
                errs.append("relay.tracing.sampleRate must be within "
                            "[0, 1]")
            st = rl.tracing.get("slowThresholdMs", 0.0)
            if not isinstance(st, (int, float)) or isinstance(st, bool) or \
                    st < 0:
                errs.append("relay.tracing.slowThresholdMs must be a "
                            "non-negative number (0 = adaptive p99)")
            for iname in ("recorderEntries", "keepTraces"):
                iv = rl.tracing.get(iname, 1)
                if not isinstance(iv, int) or isinstance(iv, bool) or \
                        iv <= 0:
                    errs.append(f"relay.tracing.{iname} must be a "
                                f"positive integer")
        if not isinstance(rl.arena, dict):
            errs.append("relay.arena must be an object ({enabled, "
                        "blockBytes, maxBlocks})")
        else:
            for iname in ("blockBytes", "maxBlocks"):
                iv = rl.arena.get(iname, 1)
                if not isinstance(iv, int) or isinstance(iv, bool) or \
                        iv <= 0:
                    errs.append(f"relay.arena.{iname} must be a "
                                f"positive integer")
        if not isinstance(rl.router, dict):
            errs.append("relay.router must be an object ({enabled, port, "
                        "vnodes, capacityPerReplica, spillover, "
                        "spilloverDepth})")
        else:
            for iname in ("port", "vnodes", "capacityPerReplica",
                          "spilloverDepth"):
                iv = rl.router.get(iname, 1)
                if not isinstance(iv, int) or isinstance(iv, bool) or \
                        iv <= 0:
                    errs.append(f"relay.router.{iname} must be a "
                                f"positive integer")
        if not isinstance(rl.federation, dict):
            errs.append("relay.federation must be an object ({enabled, "
                        "port, cells, vnodes, spillCells, headroomFloor, "
                        "replicateCache, cellClasses, tenantClassMap, "
                        "tenantHomes})")
        else:
            fed = rl.federation
            for iname in ("port", "cells", "vnodes"):
                iv = fed.get(iname, 1)
                if not isinstance(iv, int) or isinstance(iv, bool) or \
                        iv <= 0:
                    errs.append(f"relay.federation.{iname} must be a "
                                f"positive integer")
            sc = fed.get("spillCells", 0)
            if not isinstance(sc, int) or isinstance(sc, bool) or sc < 0:
                errs.append("relay.federation.spillCells must be a "
                            "non-negative integer")
            hf = fed.get("headroomFloor", 0.1)
            if not isinstance(hf, (int, float)) or isinstance(hf, bool) \
                    or not 0.0 <= hf <= 1.0:
                errs.append("relay.federation.headroomFloor must be a "
                            "number in [0, 1]")
            cc = fed.get("cellClasses", [])
            if not isinstance(cc, list) or \
                    not all(isinstance(c, str) for c in cc):
                errs.append("relay.federation.cellClasses must be a list "
                            "of latency class strings (one per cell "
                            "ordinal)")
            for mname in ("tenantClassMap", "tenantHomes"):
                mv = fed.get(mname, {})
                if not isinstance(mv, dict):
                    errs.append(f"relay.federation.{mname} must be a "
                                f"map keyed by tenant")
        if not isinstance(rl.autoscaler, dict):
            errs.append("relay.autoscaler must be an object ({enabled, "
                        "minReplicas, maxReplicas, lowMarginFrac, "
                        "highMarginFrac, upAfter, downAfter, cooldown, "
                        "evalIntervalSeconds})")
        else:
            asc = rl.autoscaler
            for iname in ("minReplicas", "maxReplicas", "upAfter",
                          "downAfter", "evalIntervalSeconds"):
                iv = asc.get(iname, 1)
                if not isinstance(iv, int) or isinstance(iv, bool) or \
                        iv <= 0:
                    errs.append(f"relay.autoscaler.{iname} must be a "
                                f"positive integer")
            cd = asc.get("cooldown", 0)
            if not isinstance(cd, int) or isinstance(cd, bool) or cd < 0:
                errs.append("relay.autoscaler.cooldown must be a "
                            "non-negative integer")
            lo = asc.get("lowMarginFrac", 0.2)
            hi = asc.get("highMarginFrac", 0.6)
            for fname, fv in (("lowMarginFrac", lo),
                              ("highMarginFrac", hi)):
                if not isinstance(fv, (int, float)) or \
                        isinstance(fv, bool) or not (0.0 <= fv <= 1.0):
                    errs.append(f"relay.autoscaler.{fname} must be "
                                f"within [0, 1]")
            if isinstance(lo, (int, float)) and not isinstance(lo, bool) \
                    and isinstance(hi, (int, float)) and \
                    not isinstance(hi, bool) and lo >= hi:
                errs.append("relay.autoscaler.lowMarginFrac must be below "
                            "highMarginFrac (the hysteresis dead band)")
            mn = asc.get("minReplicas", 1)
            mx = asc.get("maxReplicas", 8)
            if isinstance(mn, int) and isinstance(mx, int) and \
                    not isinstance(mn, bool) and not isinstance(mx, bool) \
                    and mn > mx:
                errs.append("relay.autoscaler.minReplicas must not exceed "
                            "maxReplicas")
        if not isinstance(rl.qos, dict):
            errs.append("relay.qos must be an object ({enabled, classes, "
                        "tenantClassMap, defaultClass})")
        else:
            qc = rl.qos.get("classes", [])
            if not isinstance(qc, list):
                errs.append("relay.qos.classes must be a list of "
                            "{name, weight, rateMultiplier, priority}")
            else:
                names = set()
                for i, item in enumerate(qc):
                    if not isinstance(item, dict) or not item.get("name"):
                        errs.append(f"relay.qos.classes[{i}] must be "
                                    f"{{name, weight, rateMultiplier, "
                                    f"priority}}")
                        continue
                    if item["name"] in names:
                        errs.append(f"relay.qos.classes[{i}] duplicates "
                                    f"class {item['name']!r}")
                    names.add(item["name"])
                    for fname in ("weight", "rateMultiplier"):
                        fv = item.get(fname, 1.0)
                        if not isinstance(fv, (int, float)) or \
                                isinstance(fv, bool) or fv <= 0:
                            errs.append(f"relay.qos.classes[{i}].{fname} "
                                        f"must be a positive number")
                    pv = item.get("priority", 1)
                    if not isinstance(pv, int) or isinstance(pv, bool):
                        errs.append(f"relay.qos.classes[{i}].priority "
                                    f"must be an integer (lower = more "
                                    f"important)")
                tcm = rl.qos.get("tenantClassMap", {})
                if not isinstance(tcm, dict):
                    errs.append("relay.qos.tenantClassMap must be a map "
                                "of tenant to class name")
                elif names:
                    # names only known when classes are configured
                    # explicitly; the built-in trio resolves at runtime
                    for tenant, cname in tcm.items():
                        if cname not in names:
                            errs.append(
                                f"relay.qos.tenantClassMap[{tenant!r}] "
                                f"names unknown class {cname!r}")
                if names:
                    dc = rl.qos.get("defaultClass")
                    if dc is not None and dc not in names:
                        errs.append(f"relay.qos.defaultClass {dc!r} not "
                                    f"among the configured classes")
        if not isinstance(rl.utilization, dict):
            errs.append("relay.utilization must be an object ({enabled, "
                        "deviceKindModelsJson, burnRateFloor, "
                        "windowSeconds})")
        else:
            brf = rl.utilization.get("burnRateFloor", 0.5)
            if not isinstance(brf, (int, float)) or isinstance(brf, bool) \
                    or not 0 <= brf <= 1:
                errs.append("relay.utilization.burnRateFloor must be a "
                            "number in [0, 1]")
            ws = rl.utilization.get("windowSeconds", 1.0)
            if not isinstance(ws, (int, float)) or isinstance(ws, bool) \
                    or ws <= 0:
                errs.append("relay.utilization.windowSeconds must be a "
                            "positive number")
            dkm = rl.utilization.get("deviceKindModelsJson", "")
            if not isinstance(dkm, str):
                errs.append("relay.utilization.deviceKindModelsJson must "
                            "be a JSON string ({kind: {peakTflops, ...}})")
            elif dkm:
                try:
                    parsed = json.loads(dkm)
                    if not isinstance(parsed, dict):
                        raise ValueError("not an object")
                except ValueError:
                    errs.append("relay.utilization.deviceKindModelsJson "
                                "must parse as a JSON object")
        if not isinstance(rl.spmd, dict):
            errs.append("relay.spmd must be an object ({enabled, "
                        "partitionRules, maxConcurrentShards})")
        else:
            rules = rl.spmd.get("partitionRules", [])
            if not isinstance(rules, list):
                errs.append("relay.spmd.partitionRules must be a list of "
                            "{pattern, axes} entries")
            else:
                for i, rule in enumerate(rules):
                    if not isinstance(rule, dict) or \
                            not isinstance(rule.get("pattern"), str) or \
                            not rule.get("pattern"):
                        errs.append(f"relay.spmd.partitionRules[{i}] needs "
                                    f"a non-empty string pattern")
                        continue
                    try:
                        re.compile(rule["pattern"])
                    except re.error:
                        errs.append(f"relay.spmd.partitionRules[{i}]."
                                    f"pattern is not a valid regex")
                    axes = rule.get("axes", [])
                    if not isinstance(axes, list) or \
                            any(a not in ("data", "model") for a in axes):
                        errs.append(f"relay.spmd.partitionRules[{i}].axes "
                                    f"must be a list drawn from "
                                    f"['data', 'model']")
            mcs = rl.spmd.get("maxConcurrentShards", 8)
            if not isinstance(mcs, int) or isinstance(mcs, bool) or mcs < 1:
                errs.append("relay.spmd.maxConcurrentShards must be an "
                            "integer >= 1")
        if not isinstance(rl.sessions, dict):
            errs.append("relay.sessions must be an object ({enabled, "
                        "maxSessions, pageBytes, spillDir, classMap, "
                        "idleTimeoutSeconds})")
        else:
            ms = rl.sessions.get("maxSessions", 64)
            if not isinstance(ms, int) or isinstance(ms, bool) or ms < 1:
                errs.append("relay.sessions.maxSessions must be an "
                            "integer >= 1")
            pb = rl.sessions.get("pageBytes", 4096)
            if not isinstance(pb, int) or isinstance(pb, bool) or pb < 64:
                errs.append("relay.sessions.pageBytes must be an "
                            "integer >= 64")
            sd = rl.sessions.get("spillDir", "")
            if not isinstance(sd, str):
                errs.append("relay.sessions.spillDir must be a string path")
            elif rl.sessions.get("enabled") and not sd:
                # preemption with nowhere to spill would LOSE a KV cache;
                # enabled sessions therefore require a spill dir up front
                errs.append("relay.sessions.spillDir is required when "
                            "relay.sessions.enabled is true (preempted "
                            "KV caches must have somewhere to spill)")
            cm = rl.sessions.get("classMap", {})
            if not isinstance(cm, dict):
                errs.append("relay.sessions.classMap must map request "
                            "classes to QoS class names")
            else:
                for k, v in cm.items():
                    if k not in ("prefill", "decode") or \
                            not isinstance(v, str) or not v:
                        errs.append(f"relay.sessions.classMap[{k!r}] must "
                                    f"map 'prefill' or 'decode' to a "
                                    f"non-empty QoS class name")
            its = rl.sessions.get("idleTimeoutSeconds", 300.0)
            if isinstance(its, bool) or \
                    not isinstance(its, (int, float)) or its < 0:
                errs.append("relay.sessions.idleTimeoutSeconds must be a "
                            "number >= 0")
        if not isinstance(rl.warm_start, list):
            errs.append("relay.warmStart must be a list of "
                        "{op, shape, dtype} entries")
        else:
            for i, item in enumerate(rl.warm_start):
                if not isinstance(item, dict) or not item.get("op") or \
                        not isinstance(item.get("shape"), list) or \
                        not all(isinstance(d, int) and not isinstance(d, bool)
                                and d > 0 for d in item.get("shape", [])):
                    errs.append(f"relay.warmStart[{i}] must be "
                                f"{{op, shape: [positive ints], dtype}}")
        if self.psa.enforce not in ("privileged", "baseline", "restricted"):
            errs.append(f"psa.enforce {self.psa.enforce!r} not one of "
                        f"privileged|baseline|restricted")
        if not isinstance(self.driver.version_map, dict):
            errs.append("driver.versionMap must be a map of GPU product "
                        "to driver version")
        else:
            for product, ver in self.driver.version_map.items():
                if not product or not isinstance(ver, str) or not ver:
                    errs.append(f"driver.versionMap[{product!r}] must map a "
                                f"GPU product to a non-empty version "
                                f"string")
        for name in _SPEC_TYPES:
            spec = getattr(self, name)
            pp = getattr(spec, "image_pull_policy", None)
            if pp and pp not in ("Always", "IfNotPresent", "Never"):
                errs.append(f"{_camel(name)}.imagePullPolicy {pp!r} invalid")
        return errs


# env-var fallback per component (reference: imagePath() CR→env fallback,
# clusterpolicy_types.go:1464-1493 and ImagePath type switch :1496-1549)
_IMAGE_ENV = {
    "driver": "DRIVER_IMAGE",
    "container_toolkit": "CONTAINER_TOOLKIT_IMAGE",
    "device_plugin": "DEVICE_PLUGIN_IMAGE",
    "feature_discovery": "FEATURE_DISCOVERY_IMAGE",
    "slice_manager": "SLICE_MANAGER_IMAGE",
    "metrics_agent": "METRICS_AGENT_IMAGE",
    "metrics_exporter": "METRICS_EXPORTER_IMAGE",
    "node_status_exporter": "VALIDATOR_IMAGE",   # reuses validator image,
    "validator": "VALIDATOR_IMAGE",              # like the reference
    "multinode": "CONTAINER_TOOLKIT_IMAGE",
    # ships in the shared operands image alongside the slice manager
    "health_monitor": "SLICE_MANAGER_IMAGE",
    "relay": "SLICE_MANAGER_IMAGE",
}


@dataclass
class GPUClusterPolicy:
    """The cluster-scoped singleton CR (reference: ClusterPolicy,
    clusterpolicy_types.go:1437-1443)."""
    name: str = "gpu-cluster-policy"
    spec: GPUClusterPolicySpec = field(default_factory=GPUClusterPolicySpec)
    metadata: dict = field(default_factory=dict)
    status: dict = field(default_factory=dict)

    KIND = "GPUClusterPolicy"
    API_VERSION = "nvidia.com/v1alpha1"

    @classmethod
    def from_obj(cls, raw: dict) -> "GPUClusterPolicy":
        meta = dict(raw.get("metadata", {}))
        return cls(name=meta.get("name", "gpu-cluster-policy"),
                   spec=GPUClusterPolicySpec.from_dict(raw.get("spec")),
                   metadata=meta,
                   status=dict(raw.get("status", {})))

    def to_obj(self) -> dict:
        meta = dict(self.metadata)
        meta["name"] = self.name
        out = {"apiVersion": self.API_VERSION, "kind": self.KIND,
               "metadata": meta, "spec": self.spec.to_dict()}
        if self.status:
            out["status"] = self.status
        return out

    def image_path(self, component: str) -> str:
        """Resolve the operand image: CR image > repository+image+version >
        operator env var > error (reference precedence,
        clusterpolicy_types.go:1464-1493)."""
        spec = self.spec.component(component)
        img = getattr(spec, "image", None)
        if img and ("/" in img or ":" in img):
            return img
        repo = getattr(spec, "repository", None)
        ver = getattr(spec, "version", None)
        if repo and img and ver:
            return f"{repo}/{img}:{ver}"
        env = _IMAGE_ENV.get(component)
        if env and os.environ.get(env):
            return os.environ[env]
        raise ValidationError(
            f"no image for component {component!r}: set spec.{_camel(component)}"
            f".image (or repository+image+version), or operator env {env}")
