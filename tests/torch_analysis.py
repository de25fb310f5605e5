"""The name map of the invariant analyzer and its docs: how the reference's
``tests/test_analysis.py`` and ``tests/test_metrics_docs.py`` read on the
port, and how the reference's ``docs/metrics.md`` and dashboards read as
the port's ``tpu_operator_torch/docs/``.

Both test files run on both copies through ``tests/torch_relay.py``
(``run_case``): their strings go through ``to_port`` with
``METRIC_NAMES`` first, then through ``torch_relay.PATHS`` and ``POST`` —
fixture paths under ``tpu_operator/`` land under ``tpu_operator_torch/``,
the chart's and CRDs' paths under the port's package, ``tpucheck`` is
``gpucheck`` — and the records the reference's side takes go through the
same maps.

``port_text`` is the port's copy of a reference doc through the same
maps, whose ``DOC_DECISIONS`` are the differences that are not names,
each a stated decision.
``tests/test_torch_metrics_docs.py`` holds the port's docs equal to it.
"""

from __future__ import annotations

from torch_relay import port_string

#: metric families and paths the policy map does not cover, applied before
#: it (the agent's and the exporter's as ``torch_native.NAME_MAP`` maps
#: them)
METRIC_NAMES = (
    (r"tpu_health_chips_unhealthy", "gpu_health_gpus_unhealthy"),
    (r"tpu_health_", "gpu_health_"),
    (r"tpu_apiserver_", "gpu_apiserver_"),
    (r"tpu_exporter_", "gpu_exporter_"),
    (r"tpu_operator_node_libtpu_", "gpu_operator_node_driver_"),
    (r"tpu_operator_node_tpu_devices_total",
     "gpu_operator_node_gpu_devices_total"),
    (r"tpu_agent_libtpu_loadable", "gpu_agent_driver_loadable"),
    (r"tpu_agent_libtpu_build_epoch", "gpu_agent_driver_build_epoch"),
    (r"tpu_agent_libtpu_skew", "gpu_agent_driver_skew"),
    (r"tpu_agent_libtpu_info", "gpu_agent_driver_info"),
    (r"tpu_agent_", "gpu_agent_"),
)

#: the differences between the reference's docs and the port's that are
#: not names: (reference text after the name map, the port's), each a
#: decision
DOC_DECISIONS = (
    # the port's own test and its own docs directory
    (r"tests/test_metrics_docs\.py", "tests/test_torch_metrics_docs.py"),
    (r"`docs/dashboards/", "`tpu_operator_torch/docs/dashboards/"),
    (r"\(docs/metrics\.md documents", "(tpu_operator_torch/docs/metrics.md "
     "documents"),
    # the port has no bench.py yet; the sessions harness sweeps the curve
    (r"the capacity curve in `bench\.py relay_sessions` sweeps against",
     "the capacity curve of `e2e/sessions.py` sweeps against"),
    # the relay's backend is simulated in the port; there is no PJRT
    (r"Pooled relay-PJRT serving data plane", "Pooled relay serving data "
     "plane"),
    # the port's probes (health/probes.py) and its unit, the card
    (r"\(device-presence, ici-link, counters, hbm-sweep\)",
     "(device-presence, nvlink, counter-threshold, hbm-sweep)"),
    (r"\| chips currently debounced-unhealthy", "| GPUs currently "
     "debounced-unhealthy"),
    # the native agent reads NVML (attribute files without it), and reports
    # the driver's facts; the PJRT API version has no counterpart family:
    # the CUDA driver API version is a fact of gpu_agent_driver_info
    (r"sysfs counters under `/sys/class/accel/\*/device/` where the "
     r"platform exposes them",
     "per-card attributes from NVML, or from `<attr-root>/nvidia<N>/<attr>` "
     "files where NVML is absent"),
    (r"\| `gpu_agent_pjrt_api_version\{component=major\\\|minor\}` \| PJRT "
     r"C API version the installed driver implements \|\n", ""),
    (r"driver plugin attributes \(xla_version, stablehlo versions\) as an "
     r"info gauge",
     "driver facts (`cuda_driver_version` from `cuDriverGetVersion`, "
     "`driver_version` from NVML) as an info gauge"),
    (r"driver build epoch of the staged library \(stamp scanned from the "
     r"`\.so`\) and of the running runtime \(recorded by workload validation "
     r"from a live client's `platform_version`\)",
     "driver version as major × 10⁶ + minor × 10³ + patch, of the staged "
     "user-space library and of the running kernel module (recorded by "
     "workload validation)"),
    (r"1 when staged and runtime builds differ — the pairing driver "
     r"hard-fails at dispatch \(`FAILED_PRECONDITION: driver version "
     r"mismatch`\); emitted only when BOTH builds are known",
     "1 when the staged library and the running kernel module differ — "
     "every CUDA call on the node then fails (`Driver/library version "
     "mismatch`); emitted only when BOTH versions are known"),
)

#: after the name map and ``torch_relay.PATHS``: the port's chart, CRD,
#: docs and baseline paths and its tool's name, then the doc decisions
POST = (
    (r"^(config|deployments)/", r"tpu_operator_torch/\1/"),
    (r"^docs$", "tpu_operator_torch/docs"),
    (r"\btpucheck-baseline\.json",
     "tpu_operator_torch/gpucheck-baseline.json"),
    (r"\btpucheck\b", "gpucheck"),
    *DOC_DECISIONS,
)

#: scenarios whose assertions must hold on the port but whose records hold
#: the text of a file the scenario doctors (the CRD, the transforms, a
#: CLI): those are the port's own, held by their own parity tests
#: (tests/test_torch_api.py, tests/test_torch_state_pipeline.py,
#: tests/test_torch_relay_*.py)
ASSERTIONS_ONLY = {
    "test_analysis.py::test_wiring_flags_drifted_crd_copy",
    "test_analysis.py::test_wiring_flags_unread_env_projection",
    "test_analysis.py::test_wiring_flags_stale_transform_attr",
    "test_analysis.py::test_wiring_flags_sessions_env_unread",
    "test_analysis.py::test_wiring_flags_sessions_crd_copy_drift",
}

MAPS = (METRIC_NAMES, POST)


def port_text(text: str) -> str:
    """A reference doc (Markdown or dashboard JSON) as the port's copy:
    what the maps make of any string of the two files and their records."""
    return port_string(text, MAPS)
