"""GPU discovery for the device plugin and the health monitor.

The port of ``tpu_operator/deviceplugin/discovery.py`` (``ChipDiscovery``,
``TpuChip`` → ``GpuDiscovery``, ``GpuDevice``). The NVIDIA driver exposes
one character device per card (``/dev/nvidia0`` … ``/dev/nvidiaN``) beside
its control nodes (``nvidiactl``, ``nvidia-uvm``, ``nvidia-uvm-tools``,
``nvidia-modeset``), so the glob is ``nvidia[0-9]*``: a bare ``nvidia*``
would advertise the control nodes as cards. A card is healthy when it is
present and the health monitor's health file does not name it.

Presence: where ``libnvidia-ml.so.1`` loads, a node is present when NVML
lists its minor number; without NVML, when the node is readable and
writable (``os.access``), the reference's rule. Permission bits alone
pass a node of a card the container's device cgroup refuses (mode
``crw-rw-rw-``, ``open`` fails with ``EPERM``), which NVML does not list.
No node is opened on a scan: an open may initialise a card that is not in
persistence mode, on every poll.

Left out of the reference, on purpose:

- the ICI grid helpers (``chips_per_host_bounds``, ``host_position``,
  ``allocation_bounds``): they compute ``TPU_CHIPS_PER_HOST_BOUNDS``, and
  no CUDA runtime reads a bounds variable;
- the VFIO fallback glob, which serves PCI-passthrough TPU VMs.

``SliceAwareDiscovery`` advertises each group of the slice manager's plan
(NVLink groups of whole cards, ``operands/slice_manager.py``) as one unit.
"""

from __future__ import annotations

import glob
import os
import re
from dataclasses import dataclass

from tpu_operator_torch.utils.nvml import NvmlSource

HEALTHY = "Healthy"
UNHEALTHY = "Unhealthy"

#: the env variable that overrides the device glob, shared with the
#: validator's driver component and feature discovery
DEVICE_GLOB_ENV = "GPU_DEVICE_GLOB"
#: the env variable that names the health monitor's health file
HEALTH_FILE_ENV = "GPU_HEALTH_FILE"
#: where the slice manager writes its partition plan
DEFAULT_PARTITIONS_FILE = "/run/nvidia/slice-partitions.json"


@dataclass(frozen=True)
class GpuDevice:
    """One advertisable unit: a single card, or (slice-aware mode) one
    NVLink group of several cards — ``paths``/``indices`` carry the
    members; empty means the single card described by ``path``/``index``."""
    id: str            # device-plugin device ID, e.g. "nvidia0" / "slice-0"
    path: str          # host device node, e.g. "/dev/nvidia0"
    index: int         # the card's minor number (first member for groups)
    health: str = HEALTHY
    paths: tuple = ()
    indices: tuple = ()

    @property
    def member_paths(self) -> tuple:
        return self.paths or (self.path,)

    @property
    def member_indices(self) -> tuple:
        return self.indices or (self.index,)


class GpuDiscovery:
    """Enumerate cards from device nodes under ``dev_root``.

    ``dev_root`` defaults to ``/dev`` and is overridable (tests point it at a
    fixture directory; the DaemonSet mounts the host's /dev there). The glob
    follows the ``GPU_DEVICE_GLOB`` convention shared with the validator; an
    absolute value under ``/dev/`` is taken relative to ``dev_root``.
    """

    DEFAULT_GLOB = "nvidia[0-9]*"

    def __init__(self, dev_root: str = "/dev",
                 device_glob: str | None = None,
                 health_file: str | None = None,
                 nvml: NvmlSource | None = None):
        self.dev_root = dev_root
        self.nvml = nvml if nvml is not None else NvmlSource()
        env_glob = os.environ.get(DEVICE_GLOB_ENV)
        if device_glob is None and env_glob:
            # env convention uses absolute paths (e.g. /dev/nvidia[0-9]*);
            # make it relative to dev_root so the DaemonSet's host-/dev
            # mount works
            device_glob = os.path.relpath(env_glob, "/dev") \
                if env_glob.startswith("/dev/") else env_glob
        self.device_glob = device_glob or self.DEFAULT_GLOB
        # written by the health monitor; format: one GPU index per line
        self.health_file = health_file

    def _unhealthy_indices(self) -> set[int]:
        if not self.health_file or not os.path.exists(self.health_file):
            return set()
        out: set[int] = set()
        try:
            with open(self.health_file) as f:
                for line in f:
                    line = line.strip()
                    if line.isdigit():
                        out.add(int(line))
        except OSError:
            pass
        return out

    def nodes(self) -> list[tuple[str, int, bool]]:
        """(path, minor number, present) of every node the glob matches."""
        listed = self.nvml.minor_numbers()
        out = []
        for path in sorted(glob.glob(os.path.join(self.dev_root,
                                                  self.device_glob))):
            m = re.search(r"(\d+)$", path)
            if not m:
                continue
            idx = int(m.group(1))
            present = idx in listed if listed is not None \
                else os.access(path, os.R_OK | os.W_OK)
            out.append((path, idx, present))
        return out

    def scan(self) -> list[GpuDevice]:
        bad = self._unhealthy_indices()
        return [GpuDevice(id=os.path.basename(path), path=path, index=idx,
                          health=HEALTHY if present and idx not in bad
                          else UNHEALTHY)
                for path, idx, present in self.nodes()]


class SliceAwareDiscovery:
    """Partition-aware view over ``GpuDiscovery`` — the MIG-strategy
    analogue (reference: applyMIGConfiguration, object_controls.go:2010).

    When the slice manager has written a partition plan
    (``/run/nvidia/slice-partitions.json``), each NVLink group is advertised
    as ONE schedulable unit (``slice-N``) whose members are its cards;
    without a plan (or with a stale plan naming a missing device) it
    degrades to plain per-card advertising, so a slice-manager restart
    never blanks the node's capacity."""

    def __init__(self, inner: GpuDiscovery,
                 partitions_file: str | None = None):
        self.inner = inner
        self.partitions_file = partitions_file or os.environ.get(
            "SLICE_PARTITIONS_FILE", DEFAULT_PARTITIONS_FILE)

    def _plan(self) -> tuple[list, set] | None:
        import json
        try:
            with open(self.partitions_file) as f:
                plan = json.load(f)
            parts = plan.get("partitions")
        except (FileNotFoundError, json.JSONDecodeError, OSError,
                AttributeError):
            return None
        if not isinstance(parts, list) or not parts or \
                not all(isinstance(g, list) and g for g in parts):
            return None
        # groups the slice manager invalidated (a member card flagged by
        # the health monitor) advertise Unhealthy even if the cards look
        # fine from here — the manager's verdict is authoritative
        invalid = plan.get("invalid")
        bad = {i for i in invalid if isinstance(i, int)} \
            if isinstance(invalid, list) else set()
        return parts, bad

    def scan(self) -> list[GpuDevice]:
        devices = self.inner.scan()
        plan = self._plan()
        if plan is None:
            return devices
        parts, invalid = plan
        by_path = {d.path: d for d in devices}
        if not all(p in by_path for g in parts for p in g):
            return devices  # stale plan (device vanished): per-card fallback
        if all(len(g) == 1 for g in parts) and not invalid:
            return devices  # per-gpu profile == plain advertising
        out = []
        for i, group in enumerate(parts):
            members = [by_path[p] for p in group]
            health = HEALTHY if i not in invalid and all(
                m.health == HEALTHY for m in members) else UNHEALTHY
            out.append(GpuDevice(
                id=f"slice-{i}", path=members[0].path,
                index=members[0].index, health=health,
                paths=tuple(m.path for m in members),
                indices=tuple(m.index for m in members)))
        return out

    # dev_root, _unhealthy_indices, … delegate to the inner discovery
    def __getattr__(self, name):
        return getattr(self.inner, name)
