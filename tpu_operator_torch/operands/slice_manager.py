"""The NVLink slice manager — the MIG-manager analogue (SURVEY.md §2.3).

The port of ``tpu_operator/operands/slice_manager.py``. The reference's
mig-manager watches ``nvidia.com/mig.config`` on its node, drains GPU
clients, applies the mig-parted profile, and reports progress via
``nvidia.com/mig.config.state`` (state_manager.go:32-37). The TPU operator
split a host's chips into groups of whole, ICI-neighbouring chips; here a
host's cards are split into groups of whole cards joined by NVLink, each
advertised by the device plugin as one ``nvidia.com/gpu`` unit:

  desired profile:  node label ``nvidia.com/slice.config``   (set by admin/operator)
  progress:         node label ``nvidia.com/slice.state``    pending|success|failed
  applied state:    /run/nvidia/slice-manager/state.json     (host-local)
  partition plan:   /run/nvidia/slice-partitions.json        (read by device plugin)

Profiles come from the mounted ConfigMap
(``tpu_operator_torch/assets/state-slice-manager/0400_configmap.yaml``):
``partitions: N`` splits the host's cards into N groups of equal size in
which every pair of cards is NVLink-P2P capable (read from NVML);
``gpusPerPartition: M`` asks for groups of M cards; ``partitions: per-gpu``
makes every card its own unit and ``partitions: 1`` one unit of all cards,
neither needing the topology. The reference's ``"WxH"`` rectangle form
names an ICI tile and has no GPU meaning: it is refused.

MIG is the reverse operation (one card cut into instances) and stays a
separate item: this manager never changes MIG mode or any device setting.

Repartitioning is disruptive, so the state machine drains GPU-consuming
pods before switching — the direct analogue of mig-manager's gpu-clients
drain. Cards are those ``GpuDiscovery`` finds present (NVML's minor
numbers where NVML loads): a node the container cannot open never enters
a plan.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time

import yaml

from tpu_operator_torch.deviceplugin.discovery import (
    DEFAULT_PARTITIONS_FILE, DEVICE_GLOB_ENV, HEALTH_FILE_ENV, GpuDiscovery)
from tpu_operator_torch.kube.client import KubeClient, KubeError
from tpu_operator_torch.utils.nvml import NvmlSource

log = logging.getLogger("gpu-slice-manager")

CONFIG_LABEL = "nvidia.com/slice.config"
STATE_LABEL = "nvidia.com/slice.state"

STATE_PENDING = "pending"
STATE_SUCCESS = "success"
STATE_FAILED = "failed"

PER_GPU = "per-gpu"


class SliceConfigError(Exception):
    pass


def load_profiles(config_file: str) -> dict:
    with open(config_file) as f:
        doc = yaml.safe_load(f) or {}
    profiles = doc.get("profiles")
    if not isinstance(profiles, dict) or not profiles:
        raise SliceConfigError(f"{config_file}: no profiles defined")
    return profiles


def nvlink_groups(minors: list[int], peers: dict[int, set[int]] | None,
                  k: int) -> list[list[int]] | None:
    """Split ``minors`` into ``k`` groups of equal size in which every pair
    is an NVLink peer; the first such partition in lexicographic order
    (groups ordered by their first card, members ascending), or None where
    there is none. On an all-to-all NVSwitch board that gives contiguous
    blocks. A backtracking search: hosts hold at most 16 cards."""
    n = len(minors)
    if k < 1 or n % k:
        return None
    size = n // k
    links = {m: set((peers or {}).get(m, ())) for m in minors}

    def cliques(first, others):
        # every group of ``size`` that starts with ``first`` and draws the
        # rest from ``others`` ascending, all pairs linked, in order
        def rec(group, start):
            if len(group) == size:
                yield group
                return
            for i in range(start, len(others)):
                if all(others[i] in links[g] for g in group):
                    yield from rec(group + [others[i]], i + 1)
        yield from rec([first], 0)

    def solve(rest):
        if not rest:
            return []
        for group in cliques(rest[0], rest[1:]):
            tail = solve([c for c in rest[1:] if c not in group])
            if tail is not None:
                return [group] + tail
        return None

    return solve(sorted(minors))


def _minor(path: str) -> int:
    m = re.search(r"(\d+)$", path)
    if m is None:
        raise SliceConfigError(f"{path}: not a card's device node")
    return int(m.group(1))


def partition_devices(devices: list[str], profile: dict,
                      peers: dict[int, set[int]] | None) -> list[list[str]]:
    """Split the cards (device node paths) into NVLink groups.

    Profile forms: ``partitions: per-gpu`` (every card its own unit),
    ``partitions: N`` (N groups of equal size) or ``gpusPerPartition: M``
    (groups of M cards, all linked). ``peers`` is NVML's NVLink map by
    minor number (``NvmlSource.nvlink_peers``); None means the topology is
    unknown, and then only ``partitions: 1`` (the whole host as one unit,
    as in the reference) and ``per-gpu`` are formed."""
    n = len(devices)
    if "gpusPerPartition" in profile:
        try:
            m = int(profile["gpusPerPartition"])
        except (TypeError, ValueError):
            raise SliceConfigError(
                f"bad gpusPerPartition value: "
                f"{profile['gpusPerPartition']!r}") from None
        if m < 1 or n % m:
            raise SliceConfigError(
                f"cannot split {n} GPU(s) into groups of {m}")
        spec = n // m
    else:
        spec = profile.get("partitions", 1)
    if spec == PER_GPU:
        return [[d] for d in devices]
    if isinstance(spec, str) and "x" in spec.lower():
        raise SliceConfigError(
            f"partitions {spec!r}: a WxH tile names an ICI rectangle of a "
            f"TPU host and has no GPU meaning; use partitions: N, "
            f"gpusPerPartition: M or partitions: {PER_GPU}")
    try:
        k = int(spec)
    except (TypeError, ValueError):
        raise SliceConfigError(f"bad partitions value: {spec!r}") from None
    if k < 1 or k > max(n, 1) or n % k:
        raise SliceConfigError(
            f"cannot split {n} GPU(s) into {k} equal partitions")
    if k == 1 and "gpusPerPartition" not in profile:
        return [list(devices)]  # the whole host, as the reference's
    if peers is None:
        raise SliceConfigError(
            f"NVLink topology unknown (NVML did not load): cannot form "
            f"{k} NVLink groups")
    by_minor = {_minor(d): d for d in devices}
    groups = nvlink_groups(list(by_minor), peers, k)
    if groups is None:
        viable = [k2 for k2 in range(1, n + 1) if n % k2 == 0 and (
            k2 == 1 or nvlink_groups(list(by_minor), peers, k2) is not None)]
        raise SliceConfigError(
            f"no split of {n} GPU(s) into {k} groups of NVLink peers — "
            f"viable partition counts: {viable}")
    return [[by_minor[m] for m in g] for g in groups]


def unhealthy_partition_indices(partitions: list[list[str]],
                                bad_gpus: set[int]) -> list[int]:
    """Partition indices containing at least one unhealthy card (by each
    device node's trailing number) — one bad card poisons its whole NVLink
    group: a job spanning the group cannot run its collectives."""
    out = []
    for i, group in enumerate(partitions):
        for dev in group:
            m = re.search(r"(\d+)$", str(dev))
            if m and int(m.group(1)) in bad_gpus:
                out.append(i)
                break
    return out


class SliceManager:
    def __init__(self, client: KubeClient, node_name: str | None = None,
                 config_file: str | None = None,
                 state_dir: str | None = None,
                 partitions_file: str | None = None,
                 device_glob: str | None = None,
                 resource_name: str | None = None,
                 default_profile: str | None = None,
                 health_file: str | None = None,
                 nvml: NvmlSource | None = None):
        self.client = client
        self.node_name = node_name or os.environ.get("NODE_NAME", "")
        self.config_file = config_file or os.environ.get(
            "SLICE_CONFIG_FILE", "/etc/gpu-slice-manager/config.yaml")
        self.state_dir = state_dir or os.environ.get(
            "SLICE_STATE_DIR", "/run/nvidia/slice-manager")
        self.partitions_file = partitions_file or os.environ.get(
            "SLICE_PARTITIONS_FILE", DEFAULT_PARTITIONS_FILE)
        self.device_glob = device_glob or os.environ.get(
            DEVICE_GLOB_ENV, "/dev/nvidia[0-9]*")
        self.resource_name = resource_name or os.environ.get(
            "GPU_RESOURCE_NAME", "nvidia.com/gpu")
        self.default_profile = default_profile or os.environ.get(
            "DEFAULT_SLICE_PROFILE", "full")
        # written by the health monitor (one unhealthy GPU index per line);
        # partitions containing those cards are marked invalid
        self.health_file = health_file or os.environ.get(
            HEALTH_FILE_ENV, "/run/nvidia/gpu-health")
        self.nvml = nvml if nvml is not None else NvmlSource()
        # optional invalidation observer (invalid: list[int]), called only
        # when the plan's invalid list actually changed — the reshard
        # controller's partition-invalidation push path hangs here
        self.on_invalidate = None

    # -- host-local state -------------------------------------------------
    @property
    def state_file(self) -> str:
        return os.path.join(self.state_dir, "state.json")

    def applied_profile(self) -> str | None:
        try:
            with open(self.state_file) as f:
                return json.load(f).get("profile")
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _discovery(self) -> GpuDiscovery:
        return GpuDiscovery(dev_root=os.path.dirname(self.device_glob),
                            device_glob=os.path.basename(self.device_glob),
                            health_file=self.health_file, nvml=self.nvml)

    def devices(self) -> list[str]:
        """The present cards' device nodes (F7: NVML's list, where NVML
        loads; a node the container cannot open is not a card of its)."""
        return [path for path, _, present in self._discovery().nodes()
                if present]

    def _unhealthy_gpus(self) -> set[int]:
        return self._discovery()._unhealthy_indices()

    def _write_partitions(self, plan: dict):
        # tmp + rename: the device plugin's SliceAwareDiscovery reads this
        # file concurrently; an in-place rewrite can tear mid-read
        tmp = f"{self.partitions_file}.tmp"
        with open(tmp, "w") as f:
            json.dump(plan, f)
        os.replace(tmp, self.partitions_file)

    def invalidate_unhealthy_partitions(self) -> list[int]:
        """Stamp the partition plan's ``invalid`` list with the indices of
        partitions containing health-monitor-flagged cards (the slice-aware
        device plugin stops advertising them; re-stamps to [] on recovery).
        Level-triggered: rewrites the file only when the list changes."""
        try:
            with open(self.partitions_file) as f:
                plan = json.load(f)
        except (FileNotFoundError, json.JSONDecodeError, OSError):
            return []
        invalid = unhealthy_partition_indices(
            plan.get("partitions") or [], self._unhealthy_gpus())
        if plan.get("invalid", []) == invalid:
            return invalid
        plan["invalid"] = invalid
        plan["ts"] = time.time()
        self._write_partitions(plan)
        if self.on_invalidate is not None:
            self.on_invalidate(invalid)
        if invalid:
            log.warning("invalidated slice partition(s) %s: member GPU(s) "
                        "unhealthy", invalid)
        else:
            log.info("all slice partitions healthy again")
        return invalid

    # -- drain (mig-manager gpu-clients analogue) -------------------------
    def drain_gpu_pods(self) -> int:
        """Evict every pod on this node that consumes the GPU resource.
        Operator-owned operands don't request cards, so they survive."""
        from tpu_operator_torch.kube.objects import consumes_gpu
        count = 0
        for pod in self.client.list("Pod"):
            if pod.get("spec", "nodeName") != self.node_name:
                continue
            if consumes_gpu(pod, self.resource_name):
                log.info("evicting GPU pod %s/%s", pod.namespace, pod.name)
                self.client.delete("Pod", pod.name, pod.namespace)
                count += 1
        return count

    # -- label FSM --------------------------------------------------------
    def _set_state(self, state: str):
        node = self.client.get("Node", self.node_name)
        if node.labels.get(STATE_LABEL) != state:
            node.labels[STATE_LABEL] = state
            self.client.update(node)

    def _failed_profile(self) -> str | None:
        try:
            with open(os.path.join(self.state_dir, "failed.json")) as f:
                return json.load(f).get("profile")
        except (FileNotFoundError, json.JSONDecodeError):
            return None

    def _record_failure(self, profile: str):
        os.makedirs(self.state_dir, exist_ok=True)
        with open(os.path.join(self.state_dir, "failed.json"), "w") as f:
            json.dump({"profile": profile, "ts": time.time()}, f)

    def reconcile_once(self) -> str | None:
        """One pass of the FSM; returns the new state label (or None if
        nothing to do)."""
        node = self.client.get("Node", self.node_name)
        desired = node.labels.get(CONFIG_LABEL, self.default_profile)
        if desired == self.applied_profile():
            # converged on the profile, but the healthy-card set is
            # dynamic: keep the plan's invalid-partition list current
            self.invalidate_unhealthy_partitions()
            self._set_state(STATE_SUCCESS)
            return STATE_SUCCESS
        if desired == self._failed_profile():
            # don't re-drain/re-fail every interval for the same bad
            # profile; a changed label clears the backoff
            self._set_state(STATE_FAILED)
            return STATE_FAILED

        self._set_state(STATE_PENDING)
        try:
            profiles = load_profiles(self.config_file)
            if desired not in profiles:
                raise SliceConfigError(
                    f"profile {desired!r} not in config "
                    f"({', '.join(sorted(profiles))})")
            devices = self.devices()
            if not devices:
                raise SliceConfigError(
                    f"no GPU devices present at {self.device_glob}")
            partitions = partition_devices(devices, profiles[desired] or {},
                                           self.nvml.nvlink_peers())
            drained = self.drain_gpu_pods()
            os.makedirs(self.state_dir, exist_ok=True)
            os.makedirs(os.path.dirname(self.partitions_file) or ".",
                        exist_ok=True)
            self._write_partitions(
                {"profile": desired, "resource": self.resource_name,
                 "partitions": partitions, "ts": time.time()})
            with open(self.state_file, "w") as f:
                json.dump({"profile": desired, "drained_pods": drained,
                           "ts": time.time()}, f)
            self.invalidate_unhealthy_partitions()
            self._set_state(STATE_SUCCESS)
            log.info("applied slice profile %r: %d partition(s), "
                     "%d pod(s) drained", desired, len(partitions), drained)
            return STATE_SUCCESS
        except (SliceConfigError, OSError) as e:
            log.error("slice reconfiguration failed: %s", e)
            self._record_failure(desired)
            self._set_state(STATE_FAILED)
            return STATE_FAILED

    def run(self, interval: float = 15.0, stop=None):
        while stop is None or not stop.is_set():
            try:
                self.reconcile_once()
            except KubeError as e:
                log.warning("slice reconcile error: %s", e)
            if stop is not None:
                stop.wait(interval)
            else:  # pragma: no cover
                time.sleep(interval)
