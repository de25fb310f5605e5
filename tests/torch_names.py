"""The name map of the cluster-policy API and the state pipeline: how the
reference's names (``tpu.dev/``, ``TPUClusterPolicy``, ``libtpu``, the
TPU operands' environment) read in the port. The node agents' map is
``torch_native.NAME_MAP``; this one covers the policy, its CRD, the
kube ``REGISTRY`` and every object the state pipeline renders.

``to_port`` applies ``POLICY_NAME_MAP`` in order to the reference's output
(text, or anything JSON holds, dumped with sorted keys). Three kinds of
difference are not names and are applied as functions on the rendered
objects (``port_render``):

- ``DEAD_ENV``: variables the reference's transforms and assets set that no
  reference operand reads (the tests check that against the reference's
  sources); the port does not set them, since every variable it sets is
  one a port operand reads (``tests/test_torch_operand_contract.py``);
- fault F8: the host directories the policy configures (the driver's
  install dir, the CDI and containerd config dirs, the device-plugin dir)
  are mounted at their host paths, the variables naming them are those
  paths, and the validator's checks get them (the reference mounted them
  at ``/host-install-dir``, ``/host-cdi``, ``/host-etc/containerd`` while
  passing the host paths);
- the slice manager's profiles, which are the GPU's (NVLink groups).
"""

from __future__ import annotations

import json
import re

#: the reference's names → the port's, applied in order
POLICY_NAME_MAP = (
    # policy kind, group and CRD
    (r"TPUClusterPolicy", "GPUClusterPolicy"),
    (r"tpuclusterpolic", "gpuclusterpolic"),
    (r'"tcp", "tpupolicy"', '"gpucp", "gpupolicy"'),
    (r"tpu-cluster-policy", "gpu-cluster-policy"),
    (r"tpu\.dev_", "nvidia.com_"),
    # labels, taints and resources
    (r"tpu\.dev/chip\.present", "nvidia.com/gpu.present"),
    (r"tpu\.dev/chip\.count", "nvidia.com/gpu.count"),
    (r"tpu\.dev/tpu\.workload\.config", "nvidia.com/gpu.workload.config"),
    (r"tpu\.dev/deploy\.", "nvidia.com/gpu.deploy."),
    (r"tpu\.dev/chip", "nvidia.com/gpu"),
    # tolerations, a recorded decision: the GPU counterpart of the
    # reference's two NoSchedule taints is the one GPU node taint,
    # nvidia.com/gpu (tpu.dev/tpu maps to it); google.com/tpu has none and
    # is dropped, in the pipeline's defaults and the chart's values alike
    # (tests/test_torch_packaging.py::test_operands_tolerate_the_gpu_node_taint)
    (r"tpu\.dev/tpu\b", "nvidia.com/gpu"),
    (r', \{"effect": "NoSchedule", "key": "google\.com/tpu", '
     r'"operator": "Exists"\}', ""),
    (r'\["google\.com/tpu"\]', "[]"),
    (r"cloud\.google\.com/gke-tpu-accelerator", "nvidia.com/gpu.product"),
    (r"cloud\.google\.com/gke-tpu-topology",
     "feature.node.kubernetes.io/pci-10de.present"),
    (r"tpu\.dev/libtpu\.accelerator", "nvidia.com/driver.product"),
    # the reconciler's slice: the health condition, goodput's slice label
    # (its own key, not the slice manager's slice.config/.state) and the
    # node-count families
    (r"TPUHealthy", "GPUHealthy"),
    (r"tpu\.dev/slice(?![.\w-])", "nvidia.com/gpu.slice"),
    (r"_tpu_nodes_total", "_gpu_nodes_total"),
    (r"has_tpu_labels", "has_gpu_labels"),
    (r"tpu\.dev/", "nvidia.com/"),
    (r"\btpu\.dev\b", "nvidia.com"),
    # paths
    (r"/run/tpu/chip-health", "/run/nvidia/gpu-health"),
    (r"/run/tpu\b", "/run/nvidia"),
    (r"\brun-tpu\b", "run-nvidia"),
    (r"/dev/accel\*", "/dev/nvidia[0-9]*"),
    # the RuntimeClasses and the handler the toolkit registers
    (r'"handler": "tpu-cdi"', '"handler": "nvidia-cdi"'),
    (r'"handler": "tpu"', '"handler": "nvidia"'),
    (r'"name": "tpu-cdi"', '"name": "nvidia-cdi"'),
    (r'"name": "tpu"', '"name": "nvidia"'),
    (r'"runtimeClass": \{"default": "tpu"', '"runtimeClass": {"default": '
     '"nvidia"'),
    (r'"runtimeClass": "tpu"', '"runtimeClass": "nvidia"'),
    # spec keys and component names
    (r"libtpu\.versionMap\[", "driver.versionMap["),
    (r"runtimeHook", "containerToolkit"),
    (r"runtime_hook", "container_toolkit"),
    (r"runtime-hook", "container-toolkit"),
    (r"multislice", "multinode"),
    (r"per-chip", "per-gpu"),
    (r"LIBTPU_INSTALLER_IMAGE", "DRIVER_IMAGE"),
    (r"RUNTIME_HOOK_IMAGE", "CONTAINER_TOOLKIT_IMAGE"),
    (r"libtpu-install", "driver-install"),
    (r"libtpu", "driver"),
    # the operands' environment (PRs 6-9 renamed it)
    (r"LIBTPU_INSTALL_DIR", "DRIVER_INSTALL_DIR"),
    (r"LIBTPU_REQUIRED_VERSION", "DRIVER_REQUIRED_VERSION"),
    (r"TPU_DEVICE_GLOB", "GPU_DEVICE_GLOB"),
    (r"TPU_RESOURCE_NAME", "GPU_RESOURCE_NAME"),
    (r"TPU_HEALTH_FILE", "GPU_HEALTH_FILE"),
    (r'"name": "TPU_MESH_PORT", "value": "8471"',
     '"name": "MESH_PORT", "value": "29500"'),
    (r"TPU_MESH_PORT", "MESH_PORT"),
    (r'("fabricMeshPort": (\{"default": )?)8471', r"\g<1>29500"),
    (r"TFD_INTERVAL_SECONDS", "GFD_INTERVAL_SECONDS"),
    (r"TPU_METRICS_", "GPU_METRICS_"),
    (r"REQUIRE_TPU_PLATFORM", "REQUIRE_GPU_PLATFORM"),
    (r"MULTISLICE_ENABLED", "MULTINODE_ENABLED"),
    (r"MEGASCALE_COORDINATOR_PORT", "MASTER_PORT"),
    # metric families, alerts and prose
    (r"tpu_operator_", "gpu_operator_"),
    (r"TPU_OPERATOR_", "GPU_OPERATOR_"),
    (r"TPUOperator", "GPUOperator"),
    (r"TPUNode", "GPUNode"),
    (r"no Cloud TPU equivalent", "no counterpart in this operator"),
    (r"an accelerator type to a non-empty version string",
     "a GPU product to a non-empty version string"),
    (r"accelerator type to libtpu version",
     "GPU product to driver version"),
    (r"TPU ", "GPU "),
    # operand, object and container names
    (r"\btpu-", "gpu-"),
)


def to_port(obj, extra=()):
    """``obj`` (a string, or anything JSON holds) with the reference's
    names replaced by the port's; ``extra`` pairs run first (a test's own
    values, such as the accelerator types of its nodes)."""
    text = obj if isinstance(obj, str) else json.dumps(obj, sort_keys=True)
    for pat, repl in (*extra, *POLICY_NAME_MAP):
        text = re.sub(pat, repl, text)
    return text if isinstance(obj, str) else json.loads(text)


#: variables the reference's transforms set that no reference operand
#: reads; the port sets none of them
DEAD_ENV = ("RUNTIME", "RUNTIME_CLASS", "CONTAINERD_SOCKET", "CDI_ENABLED",
            "TPU_COMPAT_RESOURCE_NAMES")

#: the reference's slice-manager profiles (TPU tiles) → the port's
SLICE_PROFILES = (
    "version: v1alpha1\nprofiles:\n"
    "  full:            # whole slice as one resource\n    partitions: 1\n"
    "  halves:\n    partitions: 2\n  quarters:\n    partitions: 4\n"
    "  chips:           # every chip individually schedulable\n"
    "    partitions: per-chip\n",
    "version: v1alpha1\nprofiles:\n"
    "  full:            # every card of the node as one resource\n"
    "    partitions: 1\n"
    "  per-gpu:         # every card individually schedulable\n"
    "    partitions: per-gpu\n"
    "  nvlink-pairs:    # groups of two NVLink-linked cards\n"
    "    gpusPerPartition: 2\n")


def _containers(raw: dict) -> list:
    spec = (raw.get("spec") or {}).get("template", {}).get("spec") or {}
    return list(spec.get("initContainers") or []) + \
        list(spec.get("containers") or [])


HOST_PATH_VOLUMES = ("host-install-dir", "cdi-dir", "containerd-config",
                     "device-plugin-dir")


def _f8(raw: dict, cdi_dir: str):
    """Fault F8's repair on a reference-rendered DaemonSet, in the
    reference's names; ``cdi_dir`` is the policy's CDI dir, which the
    validator's toolkit check reads."""
    tmpl = (raw.get("spec") or {}).get("template", {}).get("spec") or {}
    host = {}
    for v in tmpl.get("volumes") or []:
        if v.get("name") in HOST_PATH_VOLUMES and "hostPath" in v:
            host[v["name"]] = v["hostPath"]
    if "cdi-dir" in host:
        host["cdi-dir"]["path"] = cdi_dir
    for c in _containers(raw):
        config = next((e["value"] for e in c.get("env", [])
                       if e["name"] == "CONTAINERD_CONFIG"), None)
        if config and "containerd-config" in host:
            host["containerd-config"]["path"] = config.rsplit("/", 1)[0]
    for c in _containers(raw):
        mounted = {m["name"] for m in c.get("volumeMounts", [])}
        for m in c.get("volumeMounts", []):
            if m["name"] in host:
                m["mountPath"] = host[m["name"]]["path"]
        env = c.get("env")
        if env is None or raw["metadata"]["name"] != "tpu-operator-validator":
            continue            # the validator's checks get the paths too
        for name, volume, old in (
                ("LIBTPU_INSTALL_DIR", "host-install-dir",
                 "TPU_LIBRARY_PATH"),
                ("CDI_SPEC_DIR", "cdi-dir", None)):
            if volume not in mounted:
                continue
            value = host[volume]["path"]
            for e in env:
                if e["name"] in (name, old):
                    e.clear()
                    e.update(name=name, value=value)
                    break
            else:
                env.append({"name": name, "value": value})


def port_render(raw: dict, extra=(), spec=None) -> dict:
    """A reference-rendered object as the port renders it: ``DEAD_ENV``
    dropped, fault F8 repaired, then the name map, then the GPU's slice
    profiles. ``spec`` is the reference's policy spec the object was
    rendered from."""
    raw = json.loads(json.dumps(raw))
    for c in _containers(raw):
        if "env" in c:
            c["env"] = [e for e in c["env"] if e.get("name") not in DEAD_ENV]
    if raw.get("kind") == "DaemonSet":
        _f8(raw, ((spec or {}).get("runtimeHook") or {}).get(
            "cdiSpecDir", "/etc/cdi"))
    out = to_port(raw, extra)
    data = out.get("data") or {}
    if out.get("kind") == "ConfigMap" and "config.yaml" in data:
        assert data["config.yaml"] == to_port(SLICE_PROFILES[0]), data
        data["config.yaml"] = SLICE_PROFILES[1]
    return out


#: the bench's device lines, the reference's metric names → the port's:
#: a card's figure never stands under a TPU's name (the harness lines,
#: which measure no device, keep theirs)
BENCH_METRIC_NAMES = {
    "validator_burnin_matmul_bf16": "gpu_validator_burnin_matmul_bf16",
    "hbm_read_gbps": "gpu_hbm_read_gbps",
    "flash_attention_causal_bf16": "gpu_flash_attention_causal_bf16",
    "ici_allreduce_busbw_gbps": "gpu_allreduce_busbw_gbps",
    "tpu_smoke_pjrt": "gpu_smoke_cuda",
}
