"""GPU feature discovery — the GFD analogue.

The port of ``tpu_operator/operands/feature_discovery.py`` with GPU
Feature Discovery's own label names. A node's facts come from the GKE
node-pool label, NVML, the worker environment and the device tree
(``/dev/nvidia[0-9]*``, ``libcuda.so.1``), and are patched straight onto
the Node object, optionally also written as an NFD local-feature file.

Published labels:

  nvidia.com/gpu.present   "true"
  nvidia.com/gpu.product   the GKE label ``cloud.google.com/gke-accelerator``
                           when the node has one (taken first, as the
                           reference takes its GKE label), else NVML's name
                           of the first card with spaces as ``-``
  nvidia.com/gpu.count     device nodes on this host
  nvidia.com/worker-id     this host's index within a multi-node job
                           (``WORKER_ID``)
  nvidia.com/hosts         number of hosts in the job (``WORKER_HOSTNAMES``)
  nvidia.com/cuda.driver   "true" if ``libcuda.so.1`` under the driver root
                           exports ``cuInit``

The reference's ``tpu.dev/topology`` (the ICI slice shape) has no GPU
counterpart. No memory label is published: the reference publishes none,
and the product name carries it.
"""

from __future__ import annotations

import ctypes
import logging
import os
import time

from tpu_operator_torch.deviceplugin.discovery import (DEVICE_GLOB_ENV,
                                                       GpuDiscovery)
from tpu_operator_torch.kube.client import KubeClient, KubeError
from tpu_operator_torch.utils.nvml import (NvmlError, NvmlSource,
                                           find_driver_library)

log = logging.getLogger("gpu-feature-discovery")

GKE_ACCELERATOR_LABEL = "cloud.google.com/gke-accelerator"
PREFIX = "nvidia.com/"
#: the worker-identity variables the fabric validator reads
WORKER_ENV = ("WORKER_ID", "WORKER_HOSTNAMES")


def product_label(name: str) -> str:
    """A product name as a label value: spaces become ``-``."""
    return "-".join(name.split())


def libcuda_exports_cuinit(driver_root: str) -> bool:
    path = find_driver_library(driver_root, "libcuda.so.1")
    if path is None:
        return False
    try:
        return ctypes.CDLL(path).cuInit is not None
    except (OSError, AttributeError):
        return False


class FeatureDiscovery:
    def __init__(self, client: KubeClient, node_name: str | None = None,
                 device_glob: str | None = None,
                 driver_root: str | None = None,
                 env: dict | None = None,
                 nfd_feature_dir: str | None = None,
                 worker_env_file: str | None = None,
                 nvml: NvmlSource | None = None):
        self.client = client
        self.node_name = node_name or os.environ.get("NODE_NAME", "")
        self.device_glob = device_glob or os.environ.get(
            DEVICE_GLOB_ENV, os.path.join("/dev", GpuDiscovery.DEFAULT_GLOB))
        self.driver_root = driver_root or os.environ.get(
            "NVIDIA_DRIVER_ROOT", "/")
        self.env = env if env is not None else dict(os.environ)
        self.nvml = nvml if nvml is not None else NvmlSource()
        # optional GFD-style publishing path: write a local-feature file for
        # node-feature-discovery to pick up — useful when the cluster
        # already runs NFD and label writes should go through it
        self.nfd_feature_dir = nfd_feature_dir if nfd_feature_dir is not None \
            else os.environ.get("NFD_FEATURE_DIR", "")
        # worker-identity staging file for the container toolkit's
        # injection paths (CDI spec, OCI hook) — closes the multi-node env
        # chain: CR → runtime hook → workload pods → the fabric validator
        self.worker_env_file = worker_env_file if worker_env_file is not None \
            else os.environ.get("WORKER_ENV_FILE", "")

    # -- fact gathering ---------------------------------------------------
    def nvml_product(self) -> str:
        """NVML's name of the first card, or "" where NVML is absent or
        fails."""
        try:
            devices = self.nvml.attributes()
        except NvmlError as e:
            log.warning("NVML unavailable: %s", e)
            return ""
        return devices[min(devices)].get("name", "") if devices else ""

    def present_devices(self) -> list[str]:
        """The device nodes of the cards present (F7's rule: NVML's minor
        numbers where NVML loads, else readable and writable) — a node the
        container cannot open is not a card of this node (F9)."""
        scan = GpuDiscovery(dev_root=os.path.dirname(self.device_glob),
                            device_glob=os.path.basename(self.device_glob),
                            nvml=self.nvml)
        return [path for path, _, present in scan.nodes() if present]

    def discover(self, node_labels: dict) -> dict:
        """Compute the desired nvidia.com/* label set for this node."""
        devices = self.present_devices()
        product = node_labels.get(GKE_ACCELERATOR_LABEL) \
            or self.nvml_product()

        out = {}
        if devices or product:
            out[PREFIX + "gpu.present"] = "true"
        if product:
            out[PREFIX + "gpu.product"] = product_label(product)
        if devices:
            out[PREFIX + "gpu.count"] = str(len(devices))
        worker_id = self.env.get("WORKER_ID")
        if worker_id is not None and worker_id != "":
            out[PREFIX + "worker-id"] = str(worker_id)
        hostnames = self.env.get("WORKER_HOSTNAMES", "")
        if hostnames:
            out[PREFIX + "hosts"] = str(len(hostnames.split(",")))
        if libcuda_exports_cuinit(self.driver_root):
            out[PREFIX + "cuda.driver"] = "true"
        return out

    # -- reconcile one pass ----------------------------------------------
    MANAGED = ("gpu.present", "gpu.product", "gpu.count", "worker-id",
               "hosts", "cuda.driver")

    def apply_once(self) -> dict:
        node = self.client.get("Node", self.node_name)
        labels = dict(node.labels)
        desired = self.discover(labels)
        changed = dict(labels)
        for key in self.MANAGED:
            full = PREFIX + key
            if full in desired:
                changed[full] = desired[full]
            elif full in changed and key != "gpu.present":
                # facts gone (e.g. devices vanished) → retract stale labels,
                # but leave gpu.present to the operator's opt-out semantics
                del changed[full]
        if changed != labels:
            node.metadata["labels"] = changed
            self.client.update(node)
            log.info("node %s labels updated: %s", self.node_name, desired)
        if self.nfd_feature_dir:
            self.write_nfd_features(desired)
        if self.worker_env_file:
            self.write_worker_env(self.worker_env_facts())
        return desired

    def write_nfd_features(self, desired: dict):
        """Publish the same facts as an NFD local-feature file
        (`<dir>/gpu-operator`, `key=value` lines; NFD prefixes them
        `feature.node.kubernetes.io/` unless the key carries its own
        namespace, as nvidia.com/* does)."""
        os.makedirs(self.nfd_feature_dir, exist_ok=True)
        path = os.path.join(self.nfd_feature_dir, "gpu-operator")
        body = "".join(f"{k}={v}\n" for k, v in sorted(desired.items()))
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, path)

    def worker_env_facts(self) -> dict:
        """Worker identity for multi-node jobs, from the environment. The
        reference also stages the accelerator type, the ICI topology and
        the ``MEGASCALE_*`` variables, which libtpu reads; no CUDA program
        reads a counterpart of them."""
        return {k: str(self.env[k]) for k in WORKER_ENV
                if self.env.get(k) not in (None, "")}

    def write_worker_env(self, facts: dict):
        """Stage worker identity as KEY=VALUE lines for the container
        toolkit's CDI/OCI injection paths (an empty fact set still writes
        the file — truthfully empty beats stale)."""
        os.makedirs(os.path.dirname(self.worker_env_file) or ".",
                    exist_ok=True)
        body = "# written by gpu-feature-discovery\n" + \
            "".join(f"{k}={v}\n" for k, v in sorted(facts.items()))
        tmp = self.worker_env_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(body)
        os.replace(tmp, self.worker_env_file)

    def run(self, interval: float = 60.0, stop=None):
        while stop is None or not stop.is_set():
            try:
                self.apply_once()
            except KubeError as e:
                log.warning("label update failed: %s", e)
            if stop is not None:
                stop.wait(interval)
            else:  # pragma: no cover
                time.sleep(interval)
