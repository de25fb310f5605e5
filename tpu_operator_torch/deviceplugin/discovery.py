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
- the VFIO fallback glob, which serves PCI-passthrough TPU VMs;
- ``SliceAwareDiscovery``, which lands with the MIG manager.
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


@dataclass(frozen=True)
class GpuDevice:
    """One advertisable card."""
    id: str            # device-plugin device ID, e.g. "nvidia0"
    path: str          # host device node, e.g. "/dev/nvidia0"
    index: int         # the card's minor number on this host
    health: str = HEALTHY


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

    def scan(self) -> list[GpuDevice]:
        bad = self._unhealthy_indices()
        listed = self.nvml.minor_numbers()
        paths = sorted(glob.glob(os.path.join(self.dev_root,
                                              self.device_glob)))
        devices = []
        for path in paths:
            m = re.search(r"(\d+)$", path)
            if not m:
                continue
            idx = int(m.group(1))
            present = idx in listed if listed is not None \
                else os.access(path, os.R_OK | os.W_OK)
            ok = present and idx not in bad
            devices.append(GpuDevice(id=os.path.basename(path), path=path,
                                     index=idx,
                                     health=HEALTHY if ok else UNHEALTHY))
        return devices
