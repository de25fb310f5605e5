"""Ordered state machine + GPU node discovery and labeling.

The port of ``tpu_operator/controllers/state_manager.py``. Reference
analogue: controllers/state_manager.go. The ordered state list is the proven
operator idiom (driver → container toolkit → validation → plugin → aux). A
node is a GPU node when any detection label is present — node-feature-
discovery's PCI vendor label ``feature.node.kubernetes.io/pci-10de.present``
(the upstream rule, state_manager.go:96-100), GKE's
``cloud.google.com/gke-accelerator`` or our own feature discovery's
``nvidia.com/gpu.present`` — or when it advertises an ``nvidia.com/gpu``
resource. The driver fans out per ``nvidia.com/gpu.product`` value.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import threading
import time
from concurrent.futures import FIRST_COMPLETED, ThreadPoolExecutor, wait
from dataclasses import dataclass

from tpu_operator_torch.api.v1alpha1 import (_IMAGE_ENV, GPUClusterPolicy,
                                              State)
from tpu_operator_torch.kube.client import KubeClient
from tpu_operator_torch.kube.objects import Obj
from tpu_operator_torch.utils import trace
from .object_controls import ControlContext, apply_compiled, compile_state
from .resource_manager import DEFAULT_ASSETS_DIR, load_all_states
from .sharding import MAX_SHARDS, HashRing, pick_shard_count

log = logging.getLogger("gpu-operator")

GPU_PRESENT_LABEL = "nvidia.com/gpu.present"
WORKLOAD_CONFIG_LABEL = "nvidia.com/gpu.workload.config"
SLICE_CONFIG_LABEL = "nvidia.com/slice.config"
SLICE_STATE_LABEL = "nvidia.com/slice.state"
OPERANDS_LABEL = "nvidia.com/gpu.deploy.operands"
#: the driver fan-out's key: feature discovery's product label
PRODUCT_LABEL = "nvidia.com/gpu.product"
NFD_PCI_LABEL = "feature.node.kubernetes.io/pci-10de.present"
GKE_ACCEL_LABEL = "cloud.google.com/gke-accelerator"
PSA_LABEL_FMT = "pod-security.kubernetes.io/{}"
PSA_MODES = ("enforce", "audit", "warn")
# records the PSA label values the operator last wrote (ownership marker:
# a live label differing from this record is admin-set and never clobbered)
PSA_APPLIED_ANNOTATION = "nvidia.com/psa-labels-applied"

# labels that identify a GPU node before our own discovery has run: NFD's
# NVIDIA PCI vendor label (SURVEY.md §1) and GKE's GPU node-pool label
DETECTION_LABELS = (
    NFD_PCI_LABEL,
    GKE_ACCEL_LABEL,
    GPU_PRESENT_LABEL,
)
GPU_RESOURCE_PREFIXES = ("nvidia.com/gpu",)


class WorkloadConfig:
    CONTAINER = "container"
    NONE = "none"
    VALID = (CONTAINER, NONE)


# (state dir, deploy-label suffix, CR component) — order is the dependency
# chain (reference list: state_manager.go:783-799)
STATES: list[tuple[str, str | None, str | None]] = [
    ("pre-requisites", None, None),
    ("state-operator-metrics", None, None),
    ("state-driver", "driver", "driver"),
    ("state-container-toolkit", "container-toolkit", "container_toolkit"),
    ("state-operator-validation", "operator-validator", "validator"),
    ("state-device-plugin", "device-plugin", "device_plugin"),
    ("state-metrics-agent", "metrics-agent", "metrics_agent"),
    ("state-metrics-exporter", "metrics-exporter", "metrics_exporter"),
    ("state-feature-discovery", "feature-discovery", "feature_discovery"),
    ("state-slice-manager", "slice-manager", "slice_manager"),
    ("state-health-monitor", "health-monitor", "health_monitor"),
    ("state-node-status-exporter", "node-status-exporter",
     "node_status_exporter"),
    # serving data plane: a Deployment (no deploy label — not node-pinned)
    ("state-relay-service", None, "relay"),
]

DEPLOY_LABEL_FMT = "nvidia.com/gpu.deploy.{}"

# bounded fan-out for the DAG walk: the widest antichain (the five operand
# states behind the validation barrier, plus operator-metrics riding next
# to the spine) never exceeds this, so 8 keeps every ready state in flight
# without unbounded thread growth on a busy apiserver
DEFAULT_STATE_WORKERS = 8


def build_state_dag() -> dict[str, set[str]]:
    """State-name → prerequisite-state-names, derived from the WAIT_GATES
    barrier semantics rather than re-encoded by hand:

    - every state needs ``pre-requisites`` (namespace/RBAC/CRD scaffolding);
    - the spine ``driver → container-toolkit → validation`` is the gate-file
      producer chain: the runtime hook bakes the installed library's paths
      into its OCI hook, and the validator IS the barrier that checks both;
    - each operand depends on the states named by its WAIT_GATES entries
      (the same init-container gates its pods block on) plus the validation
      barrier that writes the gate files' directory;
    - states without a gated operand (``state-operator-metrics``) only need
      pre-requisites and run beside the spine.

    The STATES list order is one valid linearization of this DAG, which is
    what keeps ``run_all(max_workers=1)`` byte-identical to the historical
    serial walk.
    """
    from .object_controls import GATE_STATES, STATE_DAEMONSETS, WAIT_GATES
    barrier = "state-operator-validation"
    spine = ("state-driver", "state-container-toolkit", barrier)
    deps: dict[str, set[str]] = {name: set() for name, _, _ in STATES}
    for name in deps:
        if name != "pre-requisites":
            deps[name].add("pre-requisites")
    deps["state-container-toolkit"].add("state-driver")
    deps[barrier].update(("state-driver", "state-container-toolkit"))
    for name, _, _ in STATES:
        ds = STATE_DAEMONSETS.get(name)
        if ds is None or name in spine:
            continue
        deps[name].add(barrier)
        for gate in WAIT_GATES.get(ds, ()):
            deps[name].add(GATE_STATES[gate])
    return deps


def is_gpu_node(node: Obj) -> bool:
    labels = node.get("metadata", "labels", default={}) or {}
    if labels.get(GPU_PRESENT_LABEL) == "false":
        return False
    if any(lbl in labels for lbl in DETECTION_LABELS):
        return True
    capacity = node.get("status", "capacity", default={}) or {}
    return any(r.startswith(p) for r in capacity for p in GPU_RESOURCE_PREFIXES)


@dataclass(frozen=True)
class ServerInfo:
    """Parsed control-plane facts (reference: OpenShift/k8s version
    detection gating PSP and entitlements, state_manager.go:169-210,
    resource_manager.go:169). flavor is derived from gitVersion's vendor
    suffix; major/minor of 0 means "unknown server"."""
    major: int = 0
    minor: int = 0
    git_version: str = ""
    flavor: str = "unknown"

    @staticmethod
    def detect(client: KubeClient) -> "ServerInfo":
        raw = client.server_version()
        if not raw:
            return ServerInfo()
        gv = raw.get("gitVersion", "") or ""
        flavor = "vanilla"
        for vendor in ("gke", "eks", "aks"):
            if f"-{vendor}" in gv or f"+{vendor}" in gv:
                flavor = vendor
                break

        def num(v):
            digits = "".join(c for c in str(v) if c.isdigit())
            return int(digits) if digits else 0

        return ServerInfo(major=num(raw.get("major", 0)),
                          minor=num(raw.get("minor", 0)),
                          git_version=gv, flavor=flavor)

    @property
    def known(self) -> bool:
        return self.major > 0

    def at_least(self, major: int, minor: int) -> bool:
        """Feature gate: an UNKNOWN server is assumed modern (failing open
        matches the repo's pre-detection behavior; failing closed would turn
        off PSA/CDI on any /version hiccup)."""
        if not self.known:
            return True
        return (self.major, self.minor) >= (major, minor)


def get_runtime(node: Obj) -> str:
    """containerd/docker/crio from nodeInfo (reference: getRuntimeString,
    state_manager.go:703-740)."""
    ver = node.get("status", "nodeInfo", "containerRuntimeVersion",
                   default="") or ""
    for rt in ("containerd", "docker", "cri-o"):
        if ver.startswith(rt + ":"):
            return "crio" if rt == "cri-o" else rt
    return ""


class StateManager:
    """init() once, then step() through states; idempotent on re-runs
    (reference: ClusterPolicyController init/step/last,
    state_manager.go:742,930,954)."""

    def __init__(self, client: KubeClient, namespace: str = "gpu-operator",
                 assets_dir: str | None = None,
                 max_workers: int = DEFAULT_STATE_WORKERS,
                 metrics=None):
        self.client = client
        self.namespace = namespace
        self.assets_dir = assets_dir or DEFAULT_ASSETS_DIR
        self.assets: dict[str, list] = {}
        self.policy: GPUClusterPolicy | None = None
        self.cr_obj: Obj | None = None
        self.runtime = "containerd"
        self.gpu_node_count = 0
        self.products: set[str] = set()
        self.unlabeled_gpu_nodes = 0
        self.has_detection_labels = False
        self.server = ServerInfo()
        self._server_detected = False
        self.idx = 0
        self.max_workers = max_workers
        self.metrics = metrics
        self.state_statuses: dict[str, str] = {}
        self.state_durations: dict[str, float] = {}
        # state name → error string from the last pass: apply failures and
        # "skipped: dependency X failed" markers (degraded-mode reconcile)
        self.state_errors: dict[str, str] = {}
        # DAG-walk observability from the last run_all(): peak states in
        # flight and the wall clock of the whole walk (vs the serial sum
        # of state_durations)
        self.last_concurrency = 0
        self.last_dag_wall_s = 0.0
        # -- desired-state compilation cache (the steady-state fast path):
        # state name → (input fingerprint, CompiledState). On a fingerprint
        # hit the whole deepcopy → transform → canonicalize → sha256 stage
        # is skipped; an input change invalidates only the states whose
        # fingerprint actually covers that input (see _fingerprint).
        self.desired_cache_enabled = os.environ.get(
            "GPU_OPERATOR_DESIRED_CACHE", "1").lower() not in ("0", "false")
        self._compiled: dict[str, tuple] = {}
        self._counters_lock = threading.Lock()
        self.desired_cache_hits = 0       # lifetime
        self.desired_cache_misses = 0
        self.last_compile_hits = 0        # reset each init()
        self.last_compile_misses = 0
        self.last_label_patches = 0
        self._policy_fp = ""
        self._policy_fp_key: tuple | None = None
        self._last_pass_noop = False
        # per-node label-walk memos, one dict per shard: node name →
        # (raw, folded result). Only used for cache-served raws, which are
        # replaced wholesale on any change — ``entry_raw is raw`` therefore
        # proves the node is byte-identical to the last walk. Policy-derived
        # walk inputs are the memo key; any policy change clears them.
        # Ownership follows the consistent-hash ring (controllers/
        # sharding.py), so each shard worker is the single writer of its
        # own dict and a shard-count change remaps only ~K/N entries.
        self._walk_shards: list[dict[str, tuple]] = [{}]
        self._walk_ring: HashRing | None = None
        self._walk_memo_inputs: tuple | None = None
        # fleet-scale knobs/observability: shard_override pins the walk to
        # N shards (1 = the historical serial path, exactly); None
        # autotunes from fleet size via pick_shard_count()
        self.shard_override: int | None = None
        self.last_walk_shards = 1
        self.last_walk_wall_s = 0.0
        # runtime folded out of the label walk: None = walk hasn't run
        # (detect_runtime LISTs, the legacy path); "" = walk ran and no GPU
        # node reported one (fall back to the policy default)
        self._detected_runtime: str | None = None

    # -- discovery / labeling --------------------------------------------
    @property
    def _walk_memo(self) -> dict:
        """Back-compat view of the per-shard walk memos: the single dict in
        serial mode, a merged copy in sharded mode (tests and diagnostics
        read it; the walk itself always goes through ``_walk_shards``)."""
        if len(self._walk_shards) == 1:
            return self._walk_shards[0]
        merged: dict = {}
        for d in self._walk_shards:
            merged.update(d)
        return merged

    @_walk_memo.setter
    def _walk_memo(self, value: dict):
        self._walk_shards = [dict(value)]
        self._walk_ring = None

    def _plan_shards(self, n_nodes: int) -> int:
        """Decide this walk's shard count (override > autotune) and
        redistribute the memos along the new ring when it changed."""
        if self.shard_override is not None:
            shards = max(1, min(MAX_SHARDS, self.shard_override))
        else:
            shards = pick_shard_count(n_nodes, self.max_workers)
        if shards != len(self._walk_shards):
            self._reshard(shards)
        return shards

    def _reshard(self, shards: int):
        """Repartition memo entries by the new ring. Consistent hashing
        keeps most entries on their old shard; the moved count feeds
        ``shard_rebalance_total``."""
        ring = HashRing(shards) if shards > 1 else None
        new: list[dict] = [{} for _ in range(shards)]
        moved = 0
        for old_shard, d in enumerate(self._walk_shards):
            for name, ent in d.items():
                dest = ring.owner(name) if ring is not None else 0
                if dest != old_shard:
                    moved += 1
                new[dest][name] = ent
        self._walk_shards = new
        self._walk_ring = ring
        if self.metrics is not None and moved:
            self.metrics.shard_rebalance_total.inc(moved)

    def label_gpu_nodes(self) -> int:
        """Label every GPU node with gpu.present + per-state deploy labels
        per its workload config (reference: labelGPUNodes + gpuStateLabels,
        state_manager.go:472-571, :72-94). Returns GPU node count.

        Incremental: each node's desired label set is diffed against its
        live labels and only drifted nodes get a merge patch, so a converged
        pass writes nothing. When the client keeps a watch-maintained cache
        the walk reads shared cached raws (``list_readonly``) instead of
        paying a LIST + deepcopy per pass. The walk also collects the node
        runtime, so ``detect_runtime()`` needs no second LIST.

        Fleet-scale: above the serial threshold the walk partitions the
        fleet by consistent-hash ownership over node names and runs one
        batch per shard on a bounded pool — patch round-trips overlap
        across shards while each shard keeps single-writer access to its
        own memo dict. One shard reproduces the historical serial walk
        byte-for-byte (same iteration order, same patches)."""
        t0 = time.monotonic()
        self.products = set()
        self.unlabeled_gpu_nodes = 0
        self.has_detection_labels = False
        self._detected_runtime = ""
        # per-node slice reconcile state for CR status.slices, collected
        # here so the ready path needs no second Node LIST
        self.slice_states: dict[str, str] = {}
        ro = getattr(self.client, "list_readonly", None)
        nodes = ro("Node") if ro is not None else None
        from_cache = nodes is not None
        if nodes is None:
            nodes = self.client.list("Node")
        # node-invariant parts of the desired set, hoisted: the per-state
        # deploy keys and their component-enabled bits don't change across
        # a 100-node walk
        deploy_keys = [(DEPLOY_LABEL_FMT.format(suffix),
                        self._component_enabled(comp))
                       for _, suffix, comp in STATES if suffix is not None]
        slices_on = bool(self.policy
                         and self.policy.spec.slice_manager.is_enabled())
        slice_profile = self.policy.spec.slice_manager.default_profile \
            if slices_on else None
        # every policy-derived input the per-node delta depends on: a change
        # to any of them invalidates the whole walk memo
        walk_inputs = (tuple(deploy_keys), slices_on, slice_profile)
        if walk_inputs != self._walk_memo_inputs:
            self._walk_shards = [{} for _ in self._walk_shards]
            self._walk_memo_inputs = walk_inputs
        shards = self._plan_shards(len(nodes))
        if shards == 1:
            batches = [list(enumerate(nodes))]
            accs = [self._walk_batch(batches[0], self._walk_shards[0],
                                     from_cache, deploy_keys, slices_on,
                                     slice_profile)]
        else:
            ring = self._walk_ring
            batches = [[] for _ in range(shards)]
            for item in enumerate(nodes):
                batches[ring.owner(item[1].name)].append(item)
            workers = min(shards, max(2, self.max_workers or shards))
            with ThreadPoolExecutor(max_workers=workers,
                                    thread_name_prefix="node-shard") as ex:
                futs = [ex.submit(self._walk_batch, batches[s],
                                  self._walk_shards[s], from_cache,
                                  deploy_keys, slices_on, slice_profile)
                        for s in range(shards)]
                accs = [f.result() for f in futs]
        count = patches = 0
        best_idx, best_rt = None, ""
        for (b_count, b_patches, b_accels, b_unlabeled, b_slices,
             b_detected, b_rt_idx, b_rt) in accs:
            count += b_count
            patches += b_patches
            self.products |= b_accels
            self.unlabeled_gpu_nodes += b_unlabeled
            self.slice_states.update(b_slices)
            if b_detected:
                self.has_detection_labels = True
            if b_rt and (best_idx is None or b_rt_idx < best_idx):
                best_idx, best_rt = b_rt_idx, b_rt
        self._detected_runtime = best_rt
        self.last_label_patches = patches
        # churn hygiene: memo entries for vanished nodes must not accumulate
        # across passes (10k-node churn would otherwise leak memory); a size
        # comparison alone misses churn where adds offset removes, so always
        # reconcile against the live name set — O(n), same as the walk itself
        if from_cache and sum(len(d) for d in self._walk_shards) > 0:
            live = {n.name for n in nodes}
            for d in self._walk_shards:
                for stale in [k for k in d if k not in live]:
                    del d[stale]
        self.last_walk_shards = shards
        self.last_walk_wall_s = time.monotonic() - t0
        if self.metrics is not None:
            for s, batch in enumerate(batches):
                self.metrics.reconcile_shard_nodes.labels(str(s)).set(
                    len(batch))
            self.metrics.node_walk_duration_seconds.labels(
                "sharded" if shards > 1 else "serial").observe(
                self.last_walk_wall_s)
        return count

    def _walk_batch(self, items, memo: dict, from_cache: bool,
                    deploy_keys, slices_on, slice_profile) -> tuple:
        """One shard's slice of the label walk: fold every (index, node) in
        ``items`` against this shard's memo, patch drifted nodes, and
        return local accumulators — (count, patches, products,
        unlabeled, slice_states, detected, rt_idx, rt). ``rt_idx`` is the
        global index of the first node that reported a runtime, so the
        merged ``_detected_runtime`` is list-order-deterministic no matter
        how shards interleave."""
        count = patches = unlabeled = 0
        accels: set[str] = set()
        slice_states: dict[str, str] = {}
        detected_any = False
        rt_idx, rt_first = None, ""
        for idx, node in items:
            raw = node.raw
            ent = memo.get(node.name) if from_cache else None
            if ent is not None and ent[0] is raw:
                # identical raw + identical policy inputs: replay the folded
                # result without touching the label dict at all
                _, is_gpu, rt, accel, slice_st, detected = ent
                if slice_st:
                    slice_states[node.name] = slice_st
                if detected:
                    detected_any = True
                if is_gpu:
                    count += 1
                    if not rt_first and rt:
                        rt_idx, rt_first = idx, rt
                    if accel:
                        accels.add(accel)
                    else:
                        unlabeled += 1
                continue
            # defensive reads only: readonly raws are shared with the cache
            # and Obj accessors would setdefault into them. The walk never
            # copies the label dict — only the managed keys (deploy labels,
            # gpu.present, slice config) can drift, so the delta is built
            # by comparing those directly against the live labels.
            labels = (raw.get("metadata") or {}).get("labels") or {}
            delta: dict = {}
            rt = ""
            accel = None
            memoable = from_cache
            slice_st = labels.get(SLICE_STATE_LABEL)
            if slice_st:
                profile = labels.get(SLICE_CONFIG_LABEL)
                if profile:
                    slice_st = f"{profile}:{slice_st}"
                slice_states[node.name] = slice_st
            detected = any(lbl in labels for lbl in DETECTION_LABELS)
            if detected:
                # discovery signal present somewhere (reference:
                # hasNFDLabels / reconciliation_has_nfd_labels gauge)
                detected_any = True
            # is_gpu_node() inlined against the labels already in hand so a
            # 100-node walk doesn't re-read metadata per node
            is_gpu = labels.get(GPU_PRESENT_LABEL) != "false" and (
                detected or any(
                    r.startswith(p)
                    for r in ((raw.get("status") or {})
                              .get("capacity") or {})
                    for p in GPU_RESOURCE_PREFIXES))
            if is_gpu:
                count += 1
                rt = get_runtime(node)
                if not rt_first and rt:
                    rt_idx, rt_first = idx, rt
                accel = labels.get(PRODUCT_LABEL)
                if accel:
                    accels.add(accel)
                else:
                    unlabeled += 1
                cfg = labels.get(WORKLOAD_CONFIG_LABEL, WorkloadConfig.CONTAINER)
                if cfg not in WorkloadConfig.VALID:
                    log.warning("node %s: invalid %s=%r, treating as %r",
                                node.name, WORKLOAD_CONFIG_LABEL, cfg,
                                WorkloadConfig.CONTAINER)
                    cfg = WorkloadConfig.CONTAINER
                    memoable = False  # keep warning on every pass
                operands_off = labels.get(OPERANDS_LABEL) == "false"
                deploys_on = (cfg == WorkloadConfig.CONTAINER
                              and not operands_off)
                for key, comp_on in deploy_keys:
                    if deploys_on and comp_on:
                        if labels.get(key) != "true":
                            delta[key] = "true"
                    elif key in labels:
                        delta[key] = None
                if labels.get(GPU_PRESENT_LABEL) != "true":
                    delta[GPU_PRESENT_LABEL] = "true"
                # default slice profile (reference: default MIG config label,
                # state_manager.go:529-536)
                if slices_on and SLICE_CONFIG_LABEL not in labels:
                    delta[SLICE_CONFIG_LABEL] = slice_profile
            else:
                for key, _ in deploy_keys:
                    if key in labels:
                        delta[key] = None
                if GPU_PRESENT_LABEL in labels:
                    delta[GPU_PRESENT_LABEL] = None
            if delta:
                # merge patch carrying only the drifted keys (None deletes)
                self.client.patch("Node", node.name,
                                  patch={"metadata": {"labels": delta}})
                patches += 1
                memo.pop(node.name, None)
            elif memoable:
                # converged node: next pass replays this folded result as
                # long as the cached raw keeps its identity
                memo[node.name] = (raw, is_gpu, rt, accel, slice_st,
                                   detected)
        return (count, patches, accels, unlabeled, slice_states,
                detected_any, rt_idx, rt_first)

    def _component_enabled(self, comp: str | None) -> bool:
        if comp is None or self.policy is None:
            return True
        return self.policy.spec.component(comp).is_enabled()

    def apply_psa_labels(self):
        """Stamp Pod Security Admission labels on the operand namespace so the
        privileged node agents admit under a restricted cluster default
        (reference: PSA/PSP namespace labeling, state_manager.go:589-637)."""
        psa = self.policy.spec.psa if self.policy else None
        if psa is None or not psa.enabled:
            return
        if not self.server.at_least(1, 23):
            # PSA admission does not exist below 1.23 — labels would be
            # inert noise (reference inverse: PSP skipped on k8s>=1.25,
            # resource_manager.go:169)
            log.info("server %s.%s predates Pod Security Admission; "
                     "skipping PSA labels", self.server.major,
                     self.server.minor)
            return
        ro = getattr(self.client, "get_readonly", None)
        raw = ro("Namespace", self.namespace) if ro is not None else None
        if raw is None:
            ns = self.client.get_or_none("Namespace", self.namespace)
            if ns is None:
                return  # nothing to label; deployment tooling owns the ns
            raw = ns.raw
        # defensive reads: a cached raw is shared and must not be mutated
        meta = raw.get("metadata") or {}
        live = dict(meta.get("labels") or {})
        desired = dict(live)
        # Ownership tracking: the annotation records the values WE last
        # wrote. A label that is absent, or still carries our recorded
        # value, is ours to (re)set — so a changed spec.psa propagates. A
        # label whose value differs from our record was set by an admin
        # (e.g. a deliberately stricter enforce=baseline) and must not be
        # clobbered back on every reconcile.
        try:
            applied = json.loads((meta.get("annotations") or {}).get(
                PSA_APPLIED_ANNOTATION, "{}"))
        except ValueError:
            applied = {}
        values = {}
        for mode in PSA_MODES:
            values[PSA_LABEL_FMT.format(mode)] = psa.enforce
            values[PSA_LABEL_FMT.format(mode + "-version")] = psa.version
        for label, want in values.items():
            current = desired.get(label)
            if current is None or current == applied.get(label):
                desired[label] = want
        if desired != live or applied != values:
            delta = {k: v for k, v in desired.items() if live.get(k) != v}
            self.client.patch("Namespace", self.namespace, patch={
                "metadata": {
                    "labels": delta,
                    "annotations": {PSA_APPLIED_ANNOTATION: json.dumps(
                        values, sort_keys=True)},
                }})

    def detect_runtime(self) -> str:
        # the label walk already saw every GPU node and folded the runtime
        # out of it — no second LIST when it ran this process
        if self._detected_runtime is not None:
            if self._detected_runtime:
                return self._detected_runtime
            return self.policy.spec.operator.default_runtime if self.policy \
                else "containerd"
        for node in self.client.list(
                "Node", label_selector={GPU_PRESENT_LABEL: "true"}):
            rt = get_runtime(node)
            if rt:
                return rt
        return self.policy.spec.operator.default_runtime if self.policy \
            else "containerd"

    # -- lifecycle --------------------------------------------------------
    def init(self, policy: GPUClusterPolicy, cr_obj: Obj):
        self.policy = policy
        self.cr_obj = cr_obj
        if not self.assets:
            self.assets = load_all_states(self.assets_dir,
                                          [s[0] for s in STATES])
        if not self._server_detected:
            self.server = ServerInfo.detect(self.client)
            # only latch on success: a transient /version failure must not
            # leave the operator blind (fail-open gates) for its whole
            # lifetime — retry on the next reconcile instead
            self._server_detected = self.server.known
            if self.server.known:
                log.info("server version %s.%s (%s, flavor=%s)",
                         self.server.major, self.server.minor,
                         self.server.git_version, self.server.flavor)
        self.gpu_node_count = self.label_gpu_nodes()
        self.apply_psa_labels()
        self.runtime = self.detect_runtime()
        self.idx = 0
        self.state_statuses = {}
        self.state_durations = {}
        self.state_errors = {}
        # memoized on (CR resourceVersion, image env): the spec cannot
        # change without a resourceVersion bump, and the env vars are the
        # only other image_path input. An rv-less CR (hand-built in tests)
        # always recomputes.
        rv = self.cr_obj.resource_version if self.cr_obj else ""
        env_imgs = tuple(os.environ.get(v, "")
                         for v in sorted(set(_IMAGE_ENV.values())))
        if not rv or (rv, env_imgs) != self._policy_fp_key:
            self._policy_fp = self._policy_fingerprint()
            self._policy_fp_key = (rv, env_imgs)
        with self._counters_lock:
            self.last_compile_hits = 0
            self.last_compile_misses = 0

    def _ctx(self) -> ControlContext:
        return ControlContext(self.client, self.policy, self.cr_obj,
                              self.namespace,
                              has_gpu_nodes=self.gpu_node_count > 0,
                              products=self.products,
                              unlabeled_gpu_nodes=self.unlabeled_gpu_nodes)

    # -- desired-state compilation cache ----------------------------------
    def _policy_fingerprint(self) -> str:
        """Hash of every compile input that flows from the CR: the full
        spec (the transforms read many corners of it) plus the resolved
        operand images (image_path falls back to operator env vars, so the
        spec alone does not pin them)."""
        spec = self.policy.spec.to_dict() if self.policy else {}
        images = []
        for _, _, comp in STATES:
            if comp is None:
                continue
            try:
                images.append(self.policy.image_path(comp))
            except Exception:
                images.append("")
        blob = json.dumps([spec, images], sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()

    def _fingerprint(self, name: str, enabled: bool) -> tuple:
        """The compile inputs that can change one state's output: the
        shared core (policy/images, namespace, CR identity, enabled flag,
        any-GPU-nodes) plus per-state narrowing — only state-driver
        consumes the node-topology fingerprint (the per-product fan-out).
        Everything else recompiles only when the shared core moves."""
        cr_meta = self.cr_obj.raw.get("metadata", {}) if self.cr_obj else {}
        fp: tuple = (self._policy_fp, self.namespace,
                     cr_meta.get("name", ""), cr_meta.get("uid", ""),
                     enabled, self.gpu_node_count > 0)
        if name == "state-driver":
            fp += (tuple(sorted(self.products)),
                   self.unlabeled_gpu_nodes > 0)
        return fp

    def _compile(self, name: str, ctx: ControlContext, enabled: bool):
        """Memoized compile stage: fingerprint hit returns the cached
        CompiledState with zero recomputation; miss recompiles and caches.
        Gate: GPU_OPERATOR_DESIRED_CACHE=0 disables memoization (the
        benchmark's uncached leg)."""
        fp = self._fingerprint(name, enabled)
        if self.desired_cache_enabled:
            hit = self._compiled.get(name)
            if hit is not None and hit[0] == fp:
                with self._counters_lock:
                    self.desired_cache_hits += 1
                    self.last_compile_hits += 1
                if self.metrics is not None:
                    self.metrics.desired_cache_hits_total.inc()
                return hit[1]
        compiled = compile_state(ctx, self.assets[name], enabled=enabled)
        with self._counters_lock:
            self.desired_cache_misses += 1
            self.last_compile_misses += 1
            if self.desired_cache_enabled:
                self._compiled[name] = (fp, compiled)
        if self.metrics is not None:
            self.metrics.desired_cache_misses_total.inc()
        return compiled

    def step(self) -> str:
        name, _, comp = STATES[self.idx]
        enabled = self._component_enabled(comp)
        t0 = time.monotonic()
        ctx = self._ctx()
        status = apply_compiled(ctx, self._compile(name, ctx, enabled))
        # per-state apply cost: feeds gpu_operator_state_apply_seconds and
        # the time-to-ready breakdown (BASELINE.md north-star budget)
        self.state_durations[name] = time.monotonic() - t0
        self.state_statuses[name] = status
        self.idx += 1
        return status

    def last(self) -> bool:
        return self.idx >= len(STATES)

    def _apply_one(self, name: str, comp: str | None) -> tuple[str, float]:
        """One state's apply, off the STATES index — the DAG worker body.
        Returns (status, duration); statuses/durations are recorded by the
        collecting thread so those dicts stay single-writer."""
        enabled = self._component_enabled(comp)
        t0 = time.monotonic()
        ctx = self._ctx()
        status = apply_compiled(ctx, self._compile(name, ctx, enabled))
        return status, time.monotonic() - t0

    def _apply_traced(self, name: str, comp: str | None,
                      span) -> tuple[str, float]:
        """Executor entry: re-activate the state's trace span on the worker
        thread (the thread hop) around the untraced ``_apply_one`` body —
        kept separate so tests can stub ``_apply_one`` without caring about
        tracing."""
        with trace.use(span if span is not None else trace.NULL_SPAN):
            return self._apply_one(name, comp)

    def run_all(self, max_workers: int | None = None) -> dict[str, str]:
        """Walk every state respecting build_state_dag(), running ready
        states concurrently on a bounded pool (``max_workers<=1`` falls back
        to the historical serial walk in STATES order — a valid
        linearization of the same DAG, used by the equivalence tests).

        Degraded-mode failure semantics (both paths): a state that raises
        is recorded NOT_READY with its error in ``state_errors``; only its
        TRANSITIVE dependents are skipped (NOT_READY with a "skipped:"
        error); every independent state still runs and the pass completes —
        one flaky apply must not mask the health of the other ten states.
        Nothing re-raises: the caller inspects ``state_errors`` to publish
        a partial statesStatus plus a Degraded condition."""
        workers = self.max_workers if max_workers is None else max_workers
        if workers > 1 and self._last_pass_noop:
            # steady-state fast path: the previous pass compiled nothing and
            # patched nothing, so every apply this pass is expected to be a
            # cached-read hash check — thread-pool fan-out would cost more
            # than it buys. If something DID change, this serial pass still
            # applies it correctly (just linearly) and the next pass returns
            # to the parallel walk until converged again.
            workers = 1
        t0 = time.monotonic()
        self.state_errors = {}
        deps = build_state_dag()
        if workers <= 1:
            self.idx = 0
            self.last_concurrency = 1
            blocked: set[str] = set()   # failed or transitively skipped
            for name, _, comp in STATES:
                with trace.span(f"state:{name}") as sp:
                    blockers = deps[name] & blocked
                    if blockers:
                        # STATES order is a valid linearization of the DAG,
                        # so an in-order dep check sees every upstream
                        # failure before its dependents run
                        blocked.add(name)
                        self.state_statuses[name] = State.NOT_READY
                        self.state_errors[name] = (
                            "skipped: dependency "
                            + ", ".join(sorted(blockers)) + " failed")
                        sp.set(status="skipped")
                        continue
                    try:
                        status, dur = self._apply_one(name, comp)
                    except Exception as e:
                        log.error("state %s failed: %s", name, e)
                        blocked.add(name)
                        self.state_statuses[name] = State.NOT_READY
                        self.state_errors[name] = str(e)
                        sp.set(error=str(e))
                    else:
                        self.state_durations[name] = dur
                        self.state_statuses[name] = status
                        sp.set(status=status)
            self.idx = len(STATES)
            self.last_dag_wall_s = time.monotonic() - t0
            self._note_pass_end()
            return dict(self.state_statuses)

        completed: set[str] = set()
        scheduled: set[str] = set()
        skipped: set[str] = set()
        failed: set[str] = set()
        self.last_concurrency = 0
        # trace bookkeeping (no-ops when no reconcile span is active on
        # this thread): a state's span opens the moment the walk first
        # looks at it — blocked states get a "gate-wait" child that closes
        # at submit, so the span tree shows wait vs apply, not just apply
        state_spans: dict[str, object] = {}
        gate_spans: dict[str, object] = {}

        def _state_span(name):
            sp = state_spans.get(name)
            if sp is None:
                sp = state_spans[name] = trace.span(f"state:{name}")
            return sp

        def _finish(name, **attrs):
            gsp = gate_spans.pop(name, None)
            if gsp is not None:
                gsp.finish()
            sp = state_spans.get(name)
            if sp is not None:
                sp.set(**attrs).finish()

        with ThreadPoolExecutor(max_workers=workers,
                                thread_name_prefix="state-apply") as ex:
            in_flight: dict = {}

            def submit_ready():
                moved = True
                while moved:
                    moved = False
                    for name, _, comp in STATES:
                        if name in scheduled or name in skipped:
                            continue
                        blockers = deps[name] & (failed | skipped)
                        if blockers:
                            skipped.add(name)   # transitively blocked
                            self.state_statuses[name] = State.NOT_READY
                            self.state_errors[name] = (
                                "skipped: dependency "
                                + ", ".join(sorted(blockers)) + " failed")
                            _finish(name, status="skipped")
                            moved = True
                        elif deps[name] <= completed:
                            sp = _state_span(name)
                            gsp = gate_spans.pop(name, None)
                            if gsp is not None:
                                gsp.finish()
                            fut = ex.submit(self._apply_traced, name, comp,
                                            sp)
                            in_flight[fut] = name
                            scheduled.add(name)
                        elif name not in state_spans:
                            sp = _state_span(name)
                            if isinstance(sp, trace.Span):
                                gate_spans[name] = sp.tracer.child_of(
                                    sp, "gate-wait",
                                    deps=sorted(deps[name] - completed))
                self.last_concurrency = max(self.last_concurrency,
                                            len(in_flight))

            submit_ready()
            while in_flight:
                done, _ = wait(in_flight, return_when=FIRST_COMPLETED)
                for fut in done:
                    name = in_flight.pop(fut)
                    try:
                        status, dur = fut.result()
                    except Exception as e:
                        log.error("state %s failed: %s", name, e)
                        failed.add(name)
                        self.state_statuses[name] = State.NOT_READY
                        self.state_errors[name] = str(e)
                        _finish(name, error=str(e))
                    else:
                        self.state_durations[name] = dur
                        self.state_statuses[name] = status
                        completed.add(name)
                        _finish(name, status=status)
                submit_ready()
        self.idx = len(STATES)   # step()/last() compat: the walk is done
        self.last_dag_wall_s = time.monotonic() - t0
        self._note_pass_end()
        return dict(self.state_statuses)

    def _note_pass_end(self):
        """Remember whether this pass did zero work — the signal that lets
        the NEXT converged pass skip the thread-pool fan-out entirely."""
        self._last_pass_noop = (
            self.desired_cache_enabled
            and self.last_compile_hits > 0
            and self.last_compile_misses == 0
            and self.last_label_patches == 0
            and not self.state_errors)
