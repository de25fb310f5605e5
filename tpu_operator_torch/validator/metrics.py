"""Per-node validator metrics server (``--component metrics`` mode).

The port of ``tpu_operator/validator/metrics.py``. Reference analogue:
validator/metrics.go — a Prometheus endpoint per node that watches the
status files (30 s loop, :159-190), periodically re-runs the cheap
validation (:237-250), and counts devices. The cheap revalidation is the
driver check, as the reference re-runs ``nvidia-smi``; a full matmul would
disturb tenant workloads, so the workload gauges report the figures
recorded in the status file by the last full validation instead.

The families carry a ``gpu_operator_node_`` prefix where the reference's
carry ``tpu_operator_node_``, and ``driver`` stands for ``libtpu``:
``gpu_operator_node_driver_skew`` is 1 when the staged library and the
recorded kernel module differ, 0 when both are known and equal, -1 when
undeterminable.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time

from tpu_operator_torch.utils import prom
from .components import (DEFAULT_VALIDATIONS_DIR, VALID_COMPONENTS,
                         DriverComponent, ValidationFailed)

log = logging.getLogger("gpu-validator")

STATUS_WATCH_PERIOD_S = 30    # reference: validator/metrics.go:40-41
REVALIDATE_PERIOD_S = 60      # reference: validator/metrics.go:42-43
# the components that write a status file: all but the gate
COMPONENTS = tuple(c for c in VALID_COMPONENTS if c != "gate")


class NodeMetrics:
    def __init__(self, validations_dir: str = DEFAULT_VALIDATIONS_DIR,
                 port: int = 8000, node_name: str | None = None):
        self.dir = validations_dir
        self.port = port
        self.node = node_name or os.environ.get("NODE_NAME", "unknown")
        reg = prom.Registry()
        self.registry = reg
        self.ready = {
            c: prom.Gauge(
                f"gpu_operator_node_{c.replace('-', '_')}_ready",
                f"1 if {c} validation status file is present", registry=reg)
            for c in COMPONENTS
        }
        self.revalidation = prom.Gauge(
            "gpu_operator_node_driver_validation",
            "1 if the periodic driver revalidation passes", registry=reg)
        self.driver_skew = prom.Gauge(
            "gpu_operator_node_driver_skew",
            "1 when the staged user-space driver library and the recorded "
            "kernel module versions differ (every CUDA call fails with "
            "'Driver/library version mismatch'); 0 when both are known and "
            "equal; -1 when undeterminable",
            registry=reg)
        self.revalidation_ts = prom.Gauge(
            "gpu_operator_node_driver_validation_last_success_ts_seconds",
            "unix time of last successful revalidation", registry=reg)
        self.device_count = prom.Gauge(
            "gpu_operator_node_gpu_devices_total",
            "GPU device nodes visible on this node", registry=reg)
        self.workload_tflops = prom.Gauge(
            "gpu_operator_node_workload_matmul_tflops",
            "bf16 matmul TFLOP/s recorded by the last workload validation",
            registry=reg)
        self.workload_efficiency = prom.Gauge(
            "gpu_operator_node_workload_efficiency",
            "workload TFLOP/s as a fraction of card peak", registry=reg)
        self.workload_hbm_gbps = prom.Gauge(
            "gpu_operator_node_workload_hbm_read_gbps",
            "HBM read GB/s recorded by the last workload validation",
            registry=reg)

    # -- one scan pass ----------------------------------------------------
    def scan_status_files(self):
        for c in COMPONENTS:
            path = os.path.join(self.dir, f"{c}-ready")
            self.ready[c].set(1 if os.path.exists(path) else 0)
        # surface the measured numbers from the workload status file; reset
        # them when the file is gone so stale healthy values can't mask a
        # degraded node
        info = {}
        try:
            with open(os.path.join(self.dir, "workload-ready")) as f:
                info = json.load(f).get("info", {})
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        self.workload_tflops.set(info.get("matmul_tflops") or 0)
        self.workload_efficiency.set(info.get("efficiency") or 0)
        self.workload_hbm_gbps.set(info.get("hbm_read_gbps") or 0)

    def revalidate(self):
        # observer mode: this loop only WATCHES — it must not consume the
        # one-shot runtime-build record (that would self-clear the skew
        # alert within one poll period while the node is still broken); the
        # consuming path belongs to the validation pipeline, where workload
        # validation re-records
        comp = DriverComponent(validations_dir=self.dir, observer=True)
        try:
            info = comp.validate()
            self.revalidation.set(1)
            self.revalidation_ts.set(time.time())
            self.device_count.set(len(info.get("devices", [])))
            # both sides known → 0/1; else -1, never a false-confident 0
            known = (info.get("client_build_epoch") is not None
                     and info.get("runtime_build_epoch") is not None)
            self.driver_skew.set(int(info.get("skew", False)) if known
                                 else -1)
        except ValidationFailed as e:
            log.warning("driver revalidation failed: %s", e)
            self.revalidation.set(0)
            self.device_count.set(0)
            # skew surfaces as a ValidationFailed (check_skew raises), so
            # the alerting gauge is derived here
            self.driver_skew.set(1 if "version skew" in str(e) else -1)
            # retract the node's green status, not just this gauge: a
            # degraded driver (gone, unloadable, or version-skewed against
            # the loaded module) must re-gate dependents — the same "stale
            # healthy values can't mask a degraded node" rule the
            # status-file scan applies to the workload gauges
            comp.clear_status()

    # -- server loop ------------------------------------------------------
    def run(self, stop: threading.Event | None = None,
            scan_period: float = STATUS_WATCH_PERIOD_S,
            revalidate_period: float = REVALIDATE_PERIOD_S):
        srv = prom.serve(self.registry, self.port)
        log.info("node metrics on :%d", srv.server_address[1])
        last_reval = 0.0
        try:
            while stop is None or not stop.is_set():
                self.scan_status_files()
                if time.time() - last_reval >= revalidate_period:
                    self.revalidate()
                    last_reval = time.time()
                if stop is not None:
                    stop.wait(scan_period)
                else:  # pragma: no cover
                    time.sleep(scan_period)
        finally:
            srv.shutdown()
        return srv
