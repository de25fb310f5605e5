"""Per-kind apply logic and per-operand transforms.

The port of ``tpu_operator/controllers/object_controls.py``. Reference
analogue: controllers/object_controls.go (4138 lines of per-kind
controlFuncs + per-DaemonSet Transform* functions), collapsed to one
generic idempotent apply (hash annotation, owner ref, namespace) plus a
transform table keyed by DaemonSet name. Kind-specific behavior lives in
exactly two places: ``apply_state`` (disabled→delete, no-GPU-nodes→skip,
readiness aggregation) and ``TRANSFORMS``.

The transforms set exactly the environment the port's operands read (the
validator, the device plugin, feature discovery, the health monitor, the
slice manager, the metrics exporter and the native agents);
``tests/test_torch_operand_contract.py`` holds every name to a reader.
Variables the reference set that no operand of either package reads
(``RUNTIME``, ``RUNTIME_CLASS``, ``CONTAINERD_SOCKET``, ``CDI_ENABLED``, the
compat resource names) are not set.

Idempotency: ``nvidia.com/last-applied-hash`` annotation over the canonical
JSON of the desired object (reference: object_controls.go:107,
isDaemonsetSpecChanged :3637-3666) — the 5 s requeue walk stays read-only
once converged.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os

from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy, State
from tpu_operator_torch.kube.client import KubeClient, KubeError
from tpu_operator_torch.kube.objects import Obj, containers, set_env

log = logging.getLogger("gpu-operator")

HASH_ANNOTATION = "nvidia.com/last-applied-hash"
VALIDATIONS_DIR = "/run/nvidia/validations"
#: the volume through which the driver's install dir reaches a container
INSTALL_DIR_VOLUME = "host-install-dir"
#: the host directories the policy configures; each is mounted at its own
#: path, so a variable naming one means the same file in the container as
#: on the host (fault F8: the reference mounted them elsewhere —
#: /host-install-dir, /host-cdi, /host-etc/containerd — while passing the
#: host paths, so its installer and toolkit wrote into their containers'
#: own filesystems)
HOST_PATH_VOLUMES = (INSTALL_DIR_VOLUME, "cdi-dir", "containerd-config",
                     "device-plugin-dir")

# which status files an operand blocks on before starting (reference:
# transformValidationInitContainer injects a toolkit-validation gate into
# every operand, object_controls.go:2895-2934)
WAIT_GATES = {
    "gpu-device-plugin": ["driver", "container-toolkit"],
    "gpu-metrics-agent": ["driver"],
    "gpu-metrics-exporter": ["driver"],
    "gpu-feature-discovery": ["driver"],
    "gpu-slice-manager": ["driver", "plugin"],
    "gpu-health-monitor": ["driver"],
    "gpu-node-status-exporter": [],
    "gpu-operator-validator": [],      # it IS the barrier
    "gpu-driver-installer": [],        # first in the chain
    "gpu-container-toolkit": [],       # only needs the host dirs
}

# which state's operand writes each gate's status file — the edge source
# the DAG scheduler (state_manager.build_state_dag) derives from WAIT_GATES
GATE_STATES = {
    "driver": "state-driver",
    "container-toolkit": "state-container-toolkit",
    "plugin": "state-device-plugin",
}

# state dir → its operand DaemonSet (the STATES component column joined
# with _component_for_daemonset, written out so the DAG derivation has no
# import-order dance)
STATE_DAEMONSETS = {
    "state-driver": "gpu-driver-installer",
    "state-container-toolkit": "gpu-container-toolkit",
    "state-operator-validation": "gpu-operator-validator",
    "state-device-plugin": "gpu-device-plugin",
    "state-metrics-agent": "gpu-metrics-agent",
    "state-metrics-exporter": "gpu-metrics-exporter",
    "state-feature-discovery": "gpu-feature-discovery",
    "state-slice-manager": "gpu-slice-manager",
    "state-health-monitor": "gpu-health-monitor",
    "state-node-status-exporter": "gpu-node-status-exporter",
}


class ControlContext:
    """What a state's compile reads beside its assets. The reference's
    runtime and server-version facts fed only ``RUNTIME`` and
    ``CDI_ENABLED``, which no operand reads, so no transform here takes
    them."""

    def __init__(self, client: KubeClient, policy: GPUClusterPolicy,
                 cr_obj: Obj, namespace: str,
                 has_gpu_nodes: bool = True,
                 products: set[str] | None = None,
                 unlabeled_gpu_nodes: int = 0):
        self.client = client
        self.policy = policy
        self.cr_obj = cr_obj
        self.namespace = namespace
        self.has_gpu_nodes = has_gpu_nodes
        # the nvidia.com/gpu.product values of the GPU nodes (the driver
        # fan-out's key) and how many GPU nodes lack the label
        self.products = products or set()
        self.unlabeled_gpu_nodes = unlabeled_gpu_nodes


# ---------------------------------------------------------------------------
# hashing / idempotent apply


_DROP_META = frozenset({"resourceVersion", "uid", "creationTimestamp",
                        "generation", "managedFields"})


def _jcopy(v):
    """Plain-JSON deep copy: dicts/lists copied, scalars shared — manifests
    contain nothing else, and it beats ``copy.deepcopy``'s generic dispatch
    by a wide margin on the hot canonicalization path."""
    if isinstance(v, dict):
        return {k: _jcopy(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_jcopy(x) for x in v]
    return v


def _canonical(raw: dict) -> dict:
    """Canonical form for hashing/diffing: one walk that copies as it
    filters — status dropped, volatile metadata dropped, the hash annotation
    excluded so it never feeds back into its own input."""
    out = {k: _jcopy(v) for k, v in raw.items()
           if k not in ("status", "metadata")}
    meta = {}
    for k, v in (raw.get("metadata") or {}).items():
        if k in _DROP_META:
            continue
        if k == "annotations":
            ann = {ak: av for ak, av in (v or {}).items()
                   if ak != HASH_ANNOTATION}
            if ann:
                meta["annotations"] = ann
            continue
        meta[k] = _jcopy(v)
    out["metadata"] = meta
    # the injected template hash must not feed back into the hash itself
    tmpl_ann = (out.get("spec", {}).get("template", {})
                .get("metadata", {}).get("annotations"))
    if tmpl_ann:
        tmpl_ann.pop(HASH_ANNOTATION, None)
    return out


def _canonical_blob(raw: dict) -> str:
    return json.dumps(_canonical(raw), sort_keys=True,
                      separators=(",", ":"))


def _hash_blob(blob: str) -> str:
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def spec_hash(obj: Obj) -> str:
    """Hash of the canonical spec. Reads the compile-time memo
    (``obj._spec_hash``) when one is present so an unchanged object is
    never canonicalized twice in a pass; only the compile stage stamps the
    memo (it owns the object and never mutates it afterwards), and
    ``Obj.deepcopy`` propagates it."""
    cached = getattr(obj, "_spec_hash", None)
    if cached is not None:
        return cached
    return _hash_blob(_canonical_blob(obj.raw))


def apply_idempotent(ctx: ControlContext, obj: Obj) -> Obj:
    """Create, or update only when the desired hash differs from the live
    object's annotation.

    For DaemonSets the hash also goes into the pod template annotations so
    every kubelet-created pod carries the hash of the spec that produced it —
    the upgrade controller compares pod hash vs DaemonSet hash to find nodes
    running an outdated installer."""
    h = spec_hash(obj)
    obj.annotations[HASH_ANNOTATION] = h
    if obj.kind in ("DaemonSet", "Deployment"):
        tmpl_meta = obj.get("spec", "template").setdefault("metadata", {})
        tmpl_meta.setdefault("annotations", {})[HASH_ANNOTATION] = h
    existing = ctx.client.get_or_none(obj.kind, obj.name, obj.namespace)
    if existing is None:
        return ctx.client.create(obj)
    if existing.annotations.get(HASH_ANNOTATION) == \
            obj.annotations[HASH_ANNOTATION]:
        return existing
    obj.metadata["resourceVersion"] = existing.resource_version
    return ctx.client.update(obj)


# ---------------------------------------------------------------------------
# common daemonset plumbing


def _fill_images(ds: Obj, image: str):
    for c in containers(ds) + containers(ds, init=True):
        if c.get("image") == "FILLED_BY_OPERATOR":
            c["image"] = image


def _component_for_daemonset(name: str) -> str:
    return {
        "gpu-driver-installer": "driver",
        "gpu-container-toolkit": "container_toolkit",
        "gpu-operator-validator": "validator",
        "gpu-device-plugin": "device_plugin",
        "gpu-metrics-agent": "metrics_agent",
        "gpu-metrics-exporter": "metrics_exporter",
        "gpu-feature-discovery": "feature_discovery",
        "gpu-slice-manager": "slice_manager",
        "gpu-health-monitor": "health_monitor",
        "gpu-node-status-exporter": "node_status_exporter",
    }[name]


def apply_common_daemonset_config(ds: Obj, ctx: ControlContext):
    """Daemonsets-spec knobs stamped on every operand (reference:
    applyCommonDaemonsetConfig + applyCommonDaemonsetMetadata)."""
    d = ctx.policy.spec.daemonsets
    tmpl_spec = ds.get("spec", "template", "spec")
    tmpl_spec["priorityClassName"] = d.priority_class_name
    tols = tmpl_spec.setdefault("tolerations", [])
    for t in d.tolerations:
        if t not in tols:
            tols.append(t)
    tmpl_meta = ds.get("spec", "template").setdefault("metadata", {})
    for k, v in d.labels.items():
        tmpl_meta.setdefault("labels", {})[k] = v
        ds.labels[k] = v
    for k, v in d.annotations.items():
        tmpl_meta.setdefault("annotations", {})[k] = v
    if ds.get("spec", "updateStrategy", "type") == "RollingUpdate" \
            and d.rolling_update:
        ds.set("spec", "updateStrategy", "rollingUpdate", dict(d.rolling_update))

    comp_name = _component_for_daemonset(ds.name)
    comp = ctx.policy.spec.component(comp_name)
    _fill_images(ds, ctx.policy.image_path(comp_name))
    for c in containers(ds):
        for e in comp.env:
            set_env(c, e["name"], str(e["value"]))
        if comp.resources:
            c["resources"] = comp.resources
        if comp.args:
            c.setdefault("args", []).extend(comp.args)
        if comp.image_pull_policy:
            c["imagePullPolicy"] = comp.image_pull_policy
    if comp.image_pull_secrets:
        tmpl_spec["imagePullSecrets"] = [
            {"name": s} for s in comp.image_pull_secrets]


def inject_wait_gate(ds: Obj, ctx: ControlContext):
    """Prepend the readiness-barrier init container (reference:
    transformValidationInitContainer, object_controls.go:2895-2934)."""
    gates = WAIT_GATES.get(ds.name, [])
    if not gates:
        return
    init = {
        "name": "validation-gate",
        "image": ctx.policy.image_path("validator"),
        "imagePullPolicy": ctx.policy.spec.validator.image_pull_policy,
        "command": ["gpu-validator", "--component", "gate",
                    "--gates", ",".join(gates), "--wait"],
        "volumeMounts": [{"name": "validations",
                          "mountPath": VALIDATIONS_DIR}],
    }
    inits = containers(ds, init=True)
    inits[:] = [c for c in inits if c.get("name") != "validation-gate"]
    inits.insert(0, init)


# ---------------------------------------------------------------------------
# per-operand transforms (reference: the Transform* table,
# object_controls.go:641-656)


def _set_host_path(ds: Obj, volume: str, path: str):
    for v in ds.get("spec", "template", "spec", "volumes", default=[]):
        if v.get("name") == volume:
            v["hostPath"]["path"] = path


def _mounts(c: dict, volume: str) -> bool:
    return any(m.get("name") == volume for m in c.get("volumeMounts", []))


def mount_host_paths(ds: Obj):
    """Mount each of ``HOST_PATH_VOLUMES`` at its host path (F8)."""
    host = {v["name"]: v["hostPath"]["path"]
            for v in ds.get("spec", "template", "spec", "volumes", default=[])
            if v.get("name") in HOST_PATH_VOLUMES and "hostPath" in v}
    for c in containers(ds) + containers(ds, init=True):
        for m in c.get("volumeMounts", []):
            if m.get("name") in host:
                m["mountPath"] = host[m["name"]]


def transform_driver(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.driver
    for c in containers(ds):
        set_env(c, "DRIVER_INSTALL_DIR", spec.install_dir)
        set_env(c, "GPU_DEVICE_GLOB", spec.device_glob)
        if spec.required_version:
            set_env(c, "DRIVER_REQUIRED_VERSION", spec.required_version)
    # host install dir is configurable → rewrite the hostPath volume
    _set_host_path(ds, INSTALL_DIR_VOLUME, spec.install_dir)


def transform_container_toolkit(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.container_toolkit
    mn = ctx.policy.spec.multinode
    # init containers too: oci-hook-install bakes this env into the hooks.d
    # entry so the runtime-exec'd hook sees the operator's config
    for c in containers(ds) + containers(ds, init=True):
        set_env(c, "CONTAINERD_CONFIG", spec.containerd_config)
        set_env(c, "CDI_SPEC_DIR", spec.cdi_spec_dir)
        # the host path: the CDI spec and the hook mount it into workloads
        set_env(c, "DRIVER_INSTALL_DIR", ctx.policy.spec.driver.install_dir)
        if mn.is_enabled():
            # worker identity and the rendezvous port injected into
            # workload pods (common/util.h WorkloadEnv)
            set_env(c, "MULTINODE_ENABLED", "true")
            set_env(c, "MASTER_PORT", str(mn.coordinator_port))
    _set_host_path(ds, "containerd-socket", spec.containerd_socket)
    _set_host_path(ds, "cdi-dir", spec.cdi_spec_dir)
    _set_host_path(ds, "containerd-config",
                   os.path.dirname(spec.containerd_config))


def transform_device_plugin(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.device_plugin
    slice_spec = ctx.policy.spec.slice_manager
    for c in containers(ds):
        set_env(c, "GPU_RESOURCE_NAME", spec.resource_name)
        set_env(c, "DEVICE_PLUGIN_DIR", spec.plugin_dir)
        if slice_spec.is_enabled():
            # plugin republishes resources per slice partition (MIG-strategy
            # analogue: applyMIGConfiguration, object_controls.go:2010)
            set_env(c, "SLICE_AWARE", "true")
        if ctx.policy.spec.health_monitor.is_enabled():
            # health monitor publishes unhealthy GPU indices here; the
            # plugin's ListAndWatch marks those devices Unhealthy
            set_env(c, "GPU_HEALTH_FILE",
                    ctx.policy.spec.health_monitor.health_file)
    _set_host_path(ds, "device-plugin-dir", spec.plugin_dir)


def transform_validator(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.validator
    dp = ctx.policy.spec.device_plugin
    keep = []
    for c in containers(ds, init=True):
        comp = c["command"][2] if len(c.get("command", [])) > 2 else ""
        if comp == "workload" and spec.workload_enabled is False:
            continue
        if comp == "plugin" and spec.plugin_enabled is False:
            continue
        if comp == "plugin" and not ctx.policy.spec.device_plugin.is_enabled():
            continue  # nothing will ever advertise the resource
        if comp == "fabric":
            if spec.fabric_enabled is False:
                continue
            set_env(c, "MESH_PORT", str(spec.fabric_mesh_port))
        for e in spec.env:
            set_env(c, e["name"], str(e["value"]))
        set_env(c, "WORKLOAD_MATMUL_DIM", str(spec.workload_matmul_dim))
        set_env(c, "WORKLOAD_COLLECTIVE_MB", str(spec.workload_collective_mb))
        set_env(c, "MIN_EFFICIENCY", str(spec.min_efficiency))
        if spec.peak_tflops:
            set_env(c, "PEAK_TFLOPS", str(spec.peak_tflops))
        if spec.peak_hbm_gbps:
            set_env(c, "PEAK_HBM_GBPS", str(spec.peak_hbm_gbps))
        set_env(c, "GPU_RESOURCE_NAME", dp.resource_name)
        # the device checks load the operator-installed libcuda, and the
        # toolkit check reads the CDI spec, where the host keeps them
        if _mounts(c, INSTALL_DIR_VOLUME):
            set_env(c, "DRIVER_INSTALL_DIR",
                    ctx.policy.spec.driver.install_dir)
        if _mounts(c, "cdi-dir"):
            set_env(c, "CDI_SPEC_DIR",
                    ctx.policy.spec.container_toolkit.cdi_spec_dir)
        keep.append(c)
    inits = containers(ds, init=True)
    inits[:] = keep
    # keep the hostPaths in step with the CR
    _set_host_path(ds, INSTALL_DIR_VOLUME, ctx.policy.spec.driver.install_dir)
    _set_host_path(ds, "cdi-dir",
                   ctx.policy.spec.container_toolkit.cdi_spec_dir)


def transform_feature_discovery(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.feature_discovery
    for c in containers(ds):
        set_env(c, "GFD_INTERVAL_SECONDS", str(spec.interval_seconds))
        if spec.nfd_feature_dir:
            # publish through NFD's local-feature mechanism as well: mount
            # the host features.d and point the operand at it
            set_env(c, "NFD_FEATURE_DIR", "/nfd-features")
            mounts = c.setdefault("volumeMounts", [])
            if not any(m.get("name") == "nfd-features" for m in mounts):
                mounts.append({"name": "nfd-features",
                               "mountPath": "/nfd-features"})
    if spec.nfd_feature_dir:
        vols = ds.get("spec", "template", "spec").setdefault("volumes", [])
        if not any(v.get("name") == "nfd-features" for v in vols):
            vols.append({"name": "nfd-features",
                         "hostPath": {"path": spec.nfd_feature_dir,
                                      "type": "DirectoryOrCreate"}})


def transform_slice_manager(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.slice_manager
    for c in containers(ds):
        set_env(c, "SLICE_CONFIG_FILE", "/etc/gpu-slice-manager/config.yaml")
        set_env(c, "DEFAULT_SLICE_PROFILE", spec.default_profile)
        set_env(c, "GPU_RESOURCE_NAME",
                ctx.policy.spec.device_plugin.resource_name)
    for v in ds.get("spec", "template", "spec", "volumes", default=[]):
        if v.get("name") == "slice-config":
            v["configMap"]["name"] = spec.config_map


def transform_health_monitor(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.health_monitor
    for c in containers(ds):
        set_env(c, "HEALTH_INTERVAL_S", str(spec.interval_seconds))
        set_env(c, "HEALTH_UNHEALTHY_AFTER_S",
                str(spec.unhealthy_after_seconds))
        set_env(c, "HEALTH_HEALTHY_AFTER_S", str(spec.healthy_after_seconds))
        set_env(c, "GPU_HEALTH_FILE", spec.health_file)
        if spec.counter_thresholds:
            set_env(c, "HEALTH_COUNTER_THRESHOLDS",
                    json.dumps(spec.counter_thresholds, sort_keys=True))
        if spec.hbm_sweep_enabled():
            # the whole object, not just the enable bit: sizeMb/minGbps
            # must reach HbmSweepProbe or the configured floor is a no-op
            set_env(c, "HEALTH_HBM_SWEEP_JSON",
                    json.dumps(spec.hbm_sweep, sort_keys=True))


def transform_metrics_agent(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.metrics_agent
    for c in containers(ds):
        set_env(c, "GPU_METRICS_AGENT_PORT", str(spec.port))
        for p in c.get("ports", []):
            if p.get("name") == "agent":
                p["containerPort"] = spec.port


def transform_metrics_exporter(ds: Obj, ctx: ControlContext):
    spec = ctx.policy.spec.metrics_exporter
    agent = ctx.policy.spec.metrics_agent
    for c in containers(ds):
        # the agent runs hostNetwork on its node; reach it via the node IP
        # (remote-agent override — reference: DCGM_REMOTE_HOSTENGINE_INFO,
        # object_controls.go:94-97)
        set_env(c, "GPU_METRICS_AGENT_ADDR", f"$(NODE_IP):{agent.port}")
        set_env(c, "GPU_METRICS_EXPORTER_PORT", str(spec.port))
        for p in c.get("ports", []):
            if p.get("name") == "metrics":
                p["containerPort"] = spec.port


def transform_exporter_service(svc: Obj, ctx: ControlContext):
    port = ctx.policy.spec.metrics_exporter.port
    for p in svc.get("spec", "ports", default=[]):
        if p.get("name") == "metrics":
            p["port"] = port
            p["targetPort"] = port


def transform_relay_deployment(dep: Obj, ctx: ControlContext):
    """The relay operand is a Deployment, not a DaemonSet — it never takes
    the apply_common_daemonset_config path, so image/env/resources are
    stamped here. Every RelaySpec knob rides in as RELAY_* env, the same
    projection style as the health monitor's HEALTH_*."""
    spec = ctx.policy.spec.relay
    dep.set("spec", "replicas", spec.replicas)
    _fill_images(dep, ctx.policy.image_path("relay"))
    for c in containers(dep):
        set_env(c, "RELAY_PORT", str(spec.port))
        set_env(c, "RELAY_POOL_MAX_CHANNELS", str(spec.pool_max_channels))
        set_env(c, "RELAY_POOL_MAX_STREAMS", str(spec.pool_max_streams))
        set_env(c, "RELAY_POOL_IDLE_TIMEOUT_S",
                str(spec.pool_idle_timeout_seconds))
        set_env(c, "RELAY_ADMISSION_RATE", str(spec.admission_rate))
        set_env(c, "RELAY_ADMISSION_BURST", str(spec.admission_burst))
        set_env(c, "RELAY_ADMISSION_QUEUE_DEPTH",
                str(spec.admission_queue_depth))
        set_env(c, "RELAY_BATCH_MAX_SIZE", str(spec.batch_max_size))
        set_env(c, "RELAY_BATCH_WINDOW_MS", str(spec.batch_window_ms))
        set_env(c, "RELAY_BYPASS_BYTES", str(spec.bypass_bytes))
        set_env(c, "RELAY_TENANT_IDLE_S", str(spec.tenant_idle_seconds))
        set_env(c, "RELAY_SCHEDULER", spec.scheduler)
        set_env(c, "RELAY_SLO_MS", str(spec.slo_ms))
        set_env(c, "RELAY_SHAPE_BUCKETING",
                "true" if spec.shape_bucketing else "false")
        set_env(c, "RELAY_COMPILE_CACHE_ENTRIES",
                str(spec.compile_cache_entries))
        set_env(c, "RELAY_COMPILE_CACHE_DIR", spec.compile_cache_dir)
        # structured knob rides as a JSON blob, like HEALTH_HBM_SWEEP_JSON
        set_env(c, "RELAY_WARM_START_JSON",
                json.dumps(spec.warm_start, sort_keys=True))
        set_env(c, "RELAY_TRACING_ENABLED",
                "true" if spec.tracing_enabled() else "false")
        set_env(c, "RELAY_TRACING_SAMPLE_RATE",
                str(spec.tracing_sample_rate()))
        set_env(c, "RELAY_TRACING_SLOW_THRESHOLD_MS",
                str(spec.tracing_slow_threshold_ms()))
        set_env(c, "RELAY_TRACING_RECORDER_ENTRIES",
                str(spec.tracing_recorder_entries()))
        set_env(c, "RELAY_TRACING_KEEP_TRACES",
                str(spec.tracing_keep_traces()))
        # hot-path memory discipline: the pinned-buffer arena
        # behind buffer donation and zero-copy dispatch
        set_env(c, "RELAY_ARENA_ENABLED",
                "true" if spec.arena_enabled() else "false")
        set_env(c, "RELAY_ARENA_BLOCK_BYTES", str(spec.arena_block_bytes()))
        set_env(c, "RELAY_ARENA_MAX_BLOCKS", str(spec.arena_max_blocks()))
        # multi-tenant QoS: class table + tenant map ride as
        # JSON blobs, the same style as RELAY_WARM_START_JSON
        set_env(c, "RELAY_QOS_ENABLED",
                "true" if spec.qos_enabled() else "false")
        set_env(c, "RELAY_QOS_CLASSES_JSON",
                json.dumps(spec.qos_classes(), sort_keys=True))
        set_env(c, "RELAY_QOS_TENANT_CLASS_MAP_JSON",
                json.dumps(spec.qos_tenant_class_map(), sort_keys=True))
        set_env(c, "RELAY_QOS_DEFAULT_CLASS", spec.qos_default_class())
        # utilization ledger: roofline-attributed capacity
        # accounting; the per-kind model overrides ride as a JSON blob
        set_env(c, "RELAY_UTIL_ENABLED",
                "true" if spec.utilization_enabled() else "false")
        set_env(c, "RELAY_UTIL_DEVICE_KIND_MODELS_JSON",
                spec.utilization_device_kind_models_json())
        set_env(c, "RELAY_UTIL_BURN_RATE_FLOOR",
                str(spec.utilization_burn_rate_floor()))
        set_env(c, "RELAY_UTIL_WINDOW_SECONDS",
                str(spec.utilization_window_seconds()))
        # SPMD sharded dispatch: the (data, model) plan the
        # PlanWatcher feeds becomes the execution decomposition; the
        # partition rules ride as a JSON blob
        set_env(c, "RELAY_SPMD_ENABLED",
                "true" if spec.spmd_enabled() else "false")
        set_env(c, "RELAY_SPMD_PARTITION_RULES_JSON",
                json.dumps(spec.spmd_partition_rules(), sort_keys=True))
        set_env(c, "RELAY_SPMD_MAX_CONCURRENT_SHARDS",
                str(spec.spmd_max_concurrent_shards()))
        # stateful sessions: KV-cache residency + prefill/
        # decode QoS split; the class map rides as a JSON blob
        set_env(c, "RELAY_SESSIONS_ENABLED",
                "true" if spec.sessions_enabled() else "false")
        set_env(c, "RELAY_SESSIONS_MAX_SESSIONS",
                str(spec.sessions_max_sessions()))
        set_env(c, "RELAY_SESSIONS_PAGE_BYTES",
                str(spec.sessions_page_bytes()))
        set_env(c, "RELAY_SESSIONS_SPILL_DIR", spec.sessions_spill_dir())
        set_env(c, "RELAY_SESSIONS_CLASS_MAP_JSON",
                json.dumps(spec.sessions_class_map(), sort_keys=True))
        set_env(c, "RELAY_SESSIONS_IDLE_TIMEOUT_S",
                str(spec.sessions_idle_timeout_seconds()))
        # replication: each replica divides the tier-wide
        # tenant budget by this count so aggregate admits stay at the
        # configured rate; write-through spill makes the shared
        # compileCacheDir a tier-wide warm store for scale-ups
        set_env(c, "RELAY_REPLICA_COUNT", str(spec.replicas))
        set_env(c, "RELAY_COMPILE_CACHE_WRITE_THROUGH",
                "true" if spec.replicas > 1 and spec.compile_cache_dir
                else "false")
        # elastic resharding: point the replica at the reshard
        # controller's plan file so each new (data, model) generation cuts
        # the compile cache over (pre-warm → retire) without a restart;
        # empty disables the watcher
        resharding = ctx.policy.spec.resharding
        set_env(c, "RELAY_PLAN_FILE",
                resharding.plan_file if resharding.enabled else "")
        if spec.image_pull_policy:
            c["imagePullPolicy"] = spec.image_pull_policy
        for e in spec.env:
            set_env(c, e["name"], str(e["value"]))
        if spec.resources:
            c["resources"] = spec.resources
        if spec.args:
            c.setdefault("args", []).extend(spec.args)
        for p in c.get("ports", []):
            if p.get("name") == "relay":
                p["containerPort"] = spec.port


def transform_relay_service(svc: Obj, ctx: ControlContext):
    port = ctx.policy.spec.relay.port
    for p in svc.get("spec", "ports", default=[]):
        if p.get("name") == "relay":
            p["port"] = port
            p["targetPort"] = port


def transform_relay_router_deployment(dep: Obj, ctx: ControlContext):
    """The relay-tier front door: one router Deployment
    consistent-hashing requests over the relay replicas. Routing,
    spillover, and autoscaler knobs ride in as RELAY_ROUTER_* env; the
    router reuses the relay image (same package, different entrypoint)."""
    spec = ctx.policy.spec.relay
    _fill_images(dep, ctx.policy.image_path("relay"))
    for c in containers(dep):
        set_env(c, "RELAY_ROUTER_PORT", str(spec.router_port()))
        set_env(c, "RELAY_ROUTER_REPLICAS", str(spec.replicas))
        set_env(c, "RELAY_ROUTER_VNODES", str(spec.router_vnodes()))
        set_env(c, "RELAY_ROUTER_CAPACITY_PER_REPLICA",
                str(spec.router_capacity_per_replica()))
        set_env(c, "RELAY_ROUTER_SPILLOVER",
                "true" if spec.router_spillover() else "false")
        set_env(c, "RELAY_ROUTER_SPILLOVER_DEPTH",
                str(spec.router_spillover_depth()))
        # the router dials replicas through the relay Service; SLO rides
        # along so margin tracking feeds the autoscaler signal
        set_env(c, "RELAY_ROUTER_UPSTREAM", "gpu-relay-service")
        set_env(c, "RELAY_ROUTER_UPSTREAM_PORT", str(spec.port))
        set_env(c, "RELAY_SLO_MS", str(spec.slo_ms))
        set_env(c, "RELAY_COMPILE_CACHE_DIR", spec.compile_cache_dir)
        set_env(c, "RELAY_AUTOSCALER_ENABLED",
                "true" if spec.autoscaler_enabled() else "false")
        set_env(c, "RELAY_AUTOSCALER_MIN_REPLICAS",
                str(spec.autoscaler_min_replicas()))
        set_env(c, "RELAY_AUTOSCALER_MAX_REPLICAS",
                str(spec.autoscaler_max_replicas()))
        set_env(c, "RELAY_AUTOSCALER_LOW_MARGIN_FRAC",
                str(spec.autoscaler_low_margin_frac()))
        set_env(c, "RELAY_AUTOSCALER_HIGH_MARGIN_FRAC",
                str(spec.autoscaler_high_margin_frac()))
        set_env(c, "RELAY_AUTOSCALER_UP_AFTER",
                str(spec.autoscaler_up_after()))
        set_env(c, "RELAY_AUTOSCALER_DOWN_AFTER",
                str(spec.autoscaler_down_after()))
        set_env(c, "RELAY_AUTOSCALER_COOLDOWN",
                str(spec.autoscaler_cooldown()))
        set_env(c, "RELAY_AUTOSCALER_EVAL_INTERVAL_S",
                str(spec.autoscaler_eval_interval_s()))
        if spec.image_pull_policy:
            c["imagePullPolicy"] = spec.image_pull_policy
        for p in c.get("ports", []):
            if p.get("name") == "router":
                p["containerPort"] = spec.router_port()


def transform_relay_router_service(svc: Obj, ctx: ControlContext):
    port = ctx.policy.spec.relay.router_port()
    for p in svc.get("spec", "ports", default=[]):
        if p.get("name") == "router":
            p["port"] = port
            p["targetPort"] = port


def transform_relay_federation_deployment(dep: Obj, ctx: ControlContext):
    """The multi-cell front door: one federation Deployment
    homing tenants onto N full relay cells. Federation knobs ride in as
    RELAY_FED_* env (maps and lists as JSON blobs, the
    RELAY_WARM_START_JSON style); the federation reuses the relay image
    (same package, different entrypoint) and derives each cell's spill
    dir from the shared compileCacheDir."""
    spec = ctx.policy.spec.relay
    _fill_images(dep, ctx.policy.image_path("relay"))
    for c in containers(dep):
        set_env(c, "RELAY_FED_PORT", str(spec.federation_port()))
        set_env(c, "RELAY_FED_CELLS", str(spec.federation_cells()))
        set_env(c, "RELAY_FED_VNODES", str(spec.federation_vnodes()))
        set_env(c, "RELAY_FED_SPILL_CELLS",
                str(spec.federation_spill_cells()))
        set_env(c, "RELAY_FED_HEADROOM_FLOOR",
                str(spec.federation_headroom_floor()))
        set_env(c, "RELAY_FED_REPLICATE_CACHE",
                "true" if spec.federation_replicate_cache() else "false")
        set_env(c, "RELAY_FED_CELL_CLASSES_JSON",
                json.dumps(spec.federation_cell_classes(), sort_keys=True))
        set_env(c, "RELAY_FED_TENANT_CLASS_MAP_JSON",
                json.dumps(spec.federation_tenant_class_map(),
                           sort_keys=True))
        set_env(c, "RELAY_FED_TENANT_HOMES_JSON",
                json.dumps(spec.federation_tenant_homes(), sort_keys=True))
        # each cell is a full router tier: the per-cell knobs are the
        # router tier's own (replicas, capacity, spillover depth), and
        # per-cell spill dirs hang off the shared compileCacheDir
        set_env(c, "RELAY_ROUTER_REPLICAS", str(spec.replicas))
        set_env(c, "RELAY_ROUTER_VNODES", str(spec.router_vnodes()))
        set_env(c, "RELAY_ROUTER_CAPACITY_PER_REPLICA",
                str(spec.router_capacity_per_replica()))
        set_env(c, "RELAY_ROUTER_SPILLOVER",
                "true" if spec.router_spillover() else "false")
        set_env(c, "RELAY_ROUTER_SPILLOVER_DEPTH",
                str(spec.router_spillover_depth()))
        set_env(c, "RELAY_SLO_MS", str(spec.slo_ms))
        set_env(c, "RELAY_COMPILE_CACHE_DIR", spec.compile_cache_dir)
        if spec.image_pull_policy:
            c["imagePullPolicy"] = spec.image_pull_policy
        for p in c.get("ports", []):
            if p.get("name") == "federation":
                p["containerPort"] = spec.federation_port()


def transform_relay_federation_service(svc: Obj, ctx: ControlContext):
    port = ctx.policy.spec.relay.federation_port()
    for p in svc.get("spec", "ports", default=[]):
        if p.get("name") == "federation":
            p["port"] = port
            p["targetPort"] = port


def transform_exporter_servicemonitor(sm: Obj, ctx: ControlContext):
    interval = ctx.policy.spec.metrics_exporter.service_monitor.get("interval")
    if interval:
        for ep in sm.get("spec", "endpoints", default=[]):
            ep["interval"] = interval


# transforms for non-DaemonSet objects, keyed (kind, name)
OBJECT_TRANSFORMS = {
    ("Service", "gpu-metrics-exporter"): transform_exporter_service,
    ("ServiceMonitor", "gpu-metrics-exporter"): transform_exporter_servicemonitor,
    ("Deployment", "gpu-relay-service"): transform_relay_deployment,
    ("Service", "gpu-relay-service"): transform_relay_service,
    ("Deployment", "gpu-relay-router"): transform_relay_router_deployment,
    ("Service", "gpu-relay-router"): transform_relay_router_service,
    ("Deployment", "gpu-relay-federation"): transform_relay_federation_deployment,
    ("Service", "gpu-relay-federation"): transform_relay_federation_service,
}

TRANSFORMS = {
    "gpu-driver-installer": transform_driver,
    "gpu-container-toolkit": transform_container_toolkit,
    "gpu-device-plugin": transform_device_plugin,
    "gpu-operator-validator": transform_validator,
    "gpu-feature-discovery": transform_feature_discovery,
    "gpu-slice-manager": transform_slice_manager,
    "gpu-health-monitor": transform_health_monitor,
    "gpu-metrics-agent": transform_metrics_agent,
    "gpu-metrics-exporter": transform_metrics_exporter,
}


# ---------------------------------------------------------------------------
# per-product driver fan-out (reference: precompiled-driver-per-kernel
# daemonsets, object_controls.go:3142-3173, stale cleanup :3100-3136,:3359)

DRIVER_DS = "gpu-driver-installer"
FANOUT_LABEL = "nvidia.com/driver.fanout"
PRODUCT_DS_LABEL = "nvidia.com/driver.product"


def _fanout_name(product: str) -> str:
    safe = "".join(c if c.isalnum() or c == "-" else "-"
                   for c in product.lower()).strip("-")
    return f"{DRIVER_DS}-{safe}"[:63].rstrip("-")


def gc_driver_fanout(ctx: ControlContext, keep: set[str]):
    """Delete fan-out installer DaemonSets for GPU products no longer in
    the cluster (or all of them when fan-out is off)."""
    for d in ctx.client.list("DaemonSet", ctx.namespace,
                             label_selector={FANOUT_LABEL: "true"}):
        if d.name not in keep:
            log.info("GC stale driver installer %s", d.name)
            ctx.client.delete("DaemonSet", d.name, ctx.namespace)


def _compile_driver_fanout(ctx: ControlContext, base: Obj, ops: list):
    """Compile one installer DaemonSet per GPU product, each pinned to its
    ``driver.versionMap`` entry and nodeSelected onto its nodes.

    ``base`` is the decoded asset DaemonSet, already namespaced/owned. GPU
    nodes WITHOUT the product label stay covered by the single-name
    DaemonSet, which gains a DoesNotExist node-affinity term so it never
    double-schedules onto fanned-out nodes; when every GPU node is labeled
    the single-name DaemonSet is removed. Version changes still roll out
    node-by-node: the installer uses updateStrategy OnDelete and the node
    agent refuses to swap an in-use library, so DaemonSet churn here never
    yanks libcuda from under a running job."""
    from tpu_operator_torch.controllers.state_manager import PRODUCT_LABEL
    vm = ctx.policy.spec.driver.version_map
    desired: set[str] = set()
    if ctx.unlabeled_gpu_nodes > 0:
        keep = base.deepcopy()
        preprocess_daemonset(keep, ctx)
        tmpl_spec = keep.get("spec", "template", "spec")
        terms = (tmpl_spec.setdefault("affinity", {})
                 .setdefault("nodeAffinity", {})
                 .setdefault("requiredDuringSchedulingIgnoredDuringExecution",
                             {})
                 .setdefault("nodeSelectorTerms", []))
        terms[:] = [{"matchExpressions": [
            {"key": PRODUCT_LABEL, "operator": "DoesNotExist"}]}]
        ops.append(("apply", _compile_obj(keep)))
    else:
        ops.append(("prune_single_driver",))
    for product in sorted(ctx.products):
        clone = base.deepcopy()
        preprocess_daemonset(clone, ctx)
        clone.metadata["name"] = _fanout_name(product)
        clone.labels[FANOUT_LABEL] = "true"
        clone.labels[PRODUCT_DS_LABEL] = product
        clone.get("spec", "selector", "matchLabels")[PRODUCT_DS_LABEL] = \
            product
        tmpl = clone.get("spec", "template")
        tmpl.setdefault("metadata", {}).setdefault(
            "labels", {})[PRODUCT_DS_LABEL] = product
        tmpl.get("spec").setdefault("nodeSelector", {})[PRODUCT_LABEL] = \
            product
        ver = vm.get(product)
        if ver:
            for c in containers(clone):
                set_env(c, "DRIVER_REQUIRED_VERSION", ver)
        ops.append(("apply", _compile_obj(clone)))
        desired.add(clone.name)
    ops.append(("gc_fanout", frozenset(desired)))


# ---------------------------------------------------------------------------
# readiness + state application


def is_daemonset_ready(ds: Obj | None) -> bool:
    """NumberUnavailable == 0 (reference: isDaemonSetReady,
    object_controls.go:2961-2976)."""
    if ds is None:
        return False
    return (ds.get("status", "numberUnavailable", default=0) or 0) == 0


def preprocess_daemonset(ds: Obj, ctx: ControlContext):
    apply_common_daemonset_config(ds, ctx)
    fn = TRANSFORMS.get(ds.name)
    if fn:
        fn(ds, ctx)
    mount_host_paths(ds)
    inject_wait_gate(ds, ctx)


def _monitoring_kind(obj: Obj) -> bool:
    return obj.api_version.startswith("monitoring.coreos.com/")


class CompiledObj:
    """One fully-transformed desired object, frozen at compile time: the
    pristine ``obj`` (namespaced, owned, transformed, hash-annotated) plus
    its precomputed spec hash. The apply stage treats it as immutable —
    drift pays a deepcopy-on-write; the converged path never copies."""

    __slots__ = ("obj", "hash", "is_daemonset", "tolerate_missing_crd")

    def __init__(self, obj: Obj, h: str, tolerate_missing_crd: bool = False):
        self.obj = obj
        self.hash = h
        self.is_daemonset = obj.kind == "DaemonSet"
        self.tolerate_missing_crd = tolerate_missing_crd


class CompiledState:
    """A state's compiled op list, in exact legacy apply order:
    ``("apply", CompiledObj)`` interleaved with the bookkeeping ops
    ``("delete", kind, name, namespaced)``, ``("gc_fanout", keep_names)``
    and ``("prune_single_driver",)``."""

    __slots__ = ("ops", "enabled")

    def __init__(self, ops: list, enabled: bool):
        self.ops = ops
        self.enabled = enabled


def _compile_obj(obj: Obj, tolerate_missing_crd: bool = False) -> CompiledObj:
    h = _hash_blob(_canonical_blob(obj.raw))
    obj.annotations[HASH_ANNOTATION] = h
    if obj.kind in ("DaemonSet", "Deployment"):
        # pod-template annotation too: every kubelet-created pod carries the
        # hash of the spec that produced it (upgrade controller compares
        # pod hash vs DaemonSet hash to find outdated nodes)
        tmpl_meta = obj.get("spec", "template").setdefault("metadata", {})
        tmpl_meta.setdefault("annotations", {})[HASH_ANNOTATION] = h
    obj._spec_hash = h  # memo: spec_hash(obj) is O(1) from here on
    return CompiledObj(obj, h, tolerate_missing_crd)


def compile_state(ctx: ControlContext, objs: list[Obj],
                  enabled: bool = True) -> CompiledState:
    """The pure compile stage: deepcopy → namespace/owner → transform →
    canonicalize → hash every object of a state, producing an op list that
    ``apply_compiled`` replays with zero recomputation.

    Everything here is a function of the compile inputs — policy spec,
    node-topology fingerprint, enabled flag — which is exactly what lets
    StateManager memoize the result per state and skip this stage entirely
    when nothing changed."""
    ops: list = []
    if not enabled:
        for o in objs:
            ops.append(("delete", o.kind, o.name, _namespaced(o)))
            if o.kind == "DaemonSet" and o.name == DRIVER_DS:
                ops.append(("gc_fanout", frozenset()))
        return CompiledState(ops, enabled=False)

    for src in objs:
        obj = src.deepcopy()
        if obj.kind == "ServiceMonitor" and obj.name == "gpu-metrics-exporter" \
                and not ctx.policy.spec.metrics_exporter.service_monitor_enabled():
            ops.append(("delete", obj.kind, obj.name, _namespaced(obj)))
            continue
        if obj.name == "gpu-relay-router" \
                and not ctx.policy.spec.relay.router_enabled():
            # router objects ride in the relay state but are their own
            # opt-in: single-replica deployments need no front door
            ops.append(("delete", obj.kind, obj.name, _namespaced(obj)))
            continue
        if obj.name == "gpu-relay-federation" \
                and not ctx.policy.spec.relay.federation_enabled():
            # federation objects ride in the relay state but are their
            # own opt-in above the router's: one cell needs no federation
            ops.append(("delete", obj.kind, obj.name, _namespaced(obj)))
            continue
        if obj.kind == "ConfigMap" and obj.name == "default-slice-config" \
                and ctx.policy.spec.slice_manager.config_map != "default-slice-config":
            continue  # user supplies their own profile ConfigMap
        obj.set_namespace(ctx.namespace)
        if _namespaced(obj):
            obj.set_owner(ctx.cr_obj)
        if obj.kind == "DaemonSet":
            if not ctx.has_gpu_nodes:
                # nothing to roll out; don't create noise on non-GPU clusters
                # (reference: object_controls.go:3500-3507)
                continue
            if obj.name == DRIVER_DS:
                if ctx.policy.spec.driver.version_map and ctx.products:
                    _compile_driver_fanout(ctx, obj, ops)
                    continue
                ops.append(("gc_fanout", frozenset()))  # fan-out switched off
            preprocess_daemonset(obj, ctx)
            ops.append(("apply", _compile_obj(obj)))
        else:
            fn = OBJECT_TRANSFORMS.get((obj.kind, obj.name))
            if fn:
                fn(obj, ctx)
            # prometheus-operator CRDs absent on many clusters; the operand
            # still works without scrape config, so monitoring applies
            # tolerate a KubeError
            ops.append(("apply", _compile_obj(
                obj, tolerate_missing_crd=_monitoring_kind(obj))))
    return CompiledState(ops, enabled=True)


def _apply_compiled_obj(ctx: ControlContext, co: CompiledObj) -> Obj:
    """Create-or-update one compiled object. The converged path (live hash
    matches the compiled hash) is a zero-copy cached read; the compiled
    object is never mutated — drift pays one deepcopy for the API body."""
    client = ctx.client
    desired = co.obj
    ro = getattr(client, "get_readonly", None)
    raw = ro(desired.kind, desired.name, desired.namespace) \
        if ro is not None else None
    if raw is not None:
        # read the annotation defensively: Obj accessors would setdefault
        # into the shared cached raw
        if ((raw.get("metadata") or {}).get("annotations") or {}) \
                .get(HASH_ANNOTATION) == co.hash:
            return Obj(raw)
        existing = Obj(raw)
    else:
        # None from get_readonly means "not cached", NOT "absent" — only a
        # live read may conclude the object needs creating
        existing = client.get_or_none(desired.kind, desired.name,
                                      desired.namespace)
        if existing is not None and \
                existing.annotations.get(HASH_ANNOTATION) == co.hash:
            return existing
    if existing is None:
        return client.create(desired.deepcopy())
    out = desired.deepcopy()
    out.metadata["resourceVersion"] = existing.resource_version
    return client.update(out)


def apply_compiled(ctx: ControlContext, compiled: CompiledState) -> str:
    """Replay a compiled op list; worst status wins (reference: step(),
    state_manager.go:930-948)."""
    status = State.READY
    for op in compiled.ops:
        tag = op[0]
        if tag == "apply":
            co = op[1]
            try:
                applied = _apply_compiled_obj(ctx, co)
            except KubeError as e:
                if co.tolerate_missing_crd:
                    log.warning("skipping %s %s: %s",
                                co.obj.kind, co.obj.name, e)
                    continue
                raise
            if co.is_daemonset and not is_daemonset_ready(applied):
                status = State.NOT_READY
        elif tag == "delete":
            _, kind, name, namespaced = op
            ctx.client.delete(kind, name,
                              ctx.namespace if namespaced else None)
        elif tag == "gc_fanout":
            gc_driver_fanout(ctx, keep=set(op[1]))
        elif tag == "prune_single_driver":
            if ctx.client.get_or_none("DaemonSet", DRIVER_DS, ctx.namespace):
                ctx.client.delete("DaemonSet", DRIVER_DS, ctx.namespace)
    return status if compiled.enabled else State.DISABLED


def apply_state(ctx: ControlContext, objs: list[Obj],
                enabled: bool = True) -> str:
    """Apply one state's objects in manifest order; worst status wins.
    Compile-then-apply in one breath — the memoizing caller (StateManager)
    drives the two stages separately so a converged pass skips compilation
    entirely."""
    return apply_compiled(ctx, compile_state(ctx, objs, enabled=enabled))


def _namespaced(obj: Obj) -> bool:
    from tpu_operator_torch.kube.objects import gvr_for
    return gvr_for(obj.kind).namespaced
