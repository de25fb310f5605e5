"""Node health monitor operand — probes → hysteresis → published state.

The port of ``tpu_operator/health/monitor.py`` with the GPU's names.
Publishes, per pass (level-triggered: converged passes write nothing):

- a ``nvidia.com/GPUHealthy`` NodeCondition (status/reason/message;
  lastTransitionTime moves only on an actual flip),
- ``nvidia.com/gpu.<N>.health`` annotations for unhealthy GPUs (removed
  when the GPU recovers),
- a health file (one unhealthy GPU index per line) consumed by the device
  plugin's GpuDiscovery — the path the remediation loop rides to get the
  GPUs marked Unhealthy in ListAndWatch,
- Prometheus families on its own registry (``gpu_health_*``).

Reference analogue: DCGM health checks + the node-status-exporter, fused
into one operand.
"""

from __future__ import annotations

import logging
import os
import time

from tpu_operator_torch.api.v1alpha1 import DEFAULT_HEALTH_FILE
from tpu_operator_torch.utils import trace
from tpu_operator_torch.utils.prom import Counter, Gauge, Histogram, Registry

from .hysteresis import Debouncer

log = logging.getLogger("gpu-operator")

NODE_CONDITION_TYPE = "nvidia.com/GPUHealthy"
GPU_ANNOTATION_FMT = "nvidia.com/gpu.{}.health"
GPU_ANNOTATION_PREFIX = "nvidia.com/gpu."
NODE_KEY = "node"  # debouncer key for node-scoped probe results

PROBE_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0)


def iso_ts(ts: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(ts))


def parse_iso_ts(s: str) -> float:
    try:
        import calendar
        return float(calendar.timegm(
            time.strptime(s, "%Y-%m-%dT%H:%M:%SZ")))
    except (TypeError, ValueError):
        return 0.0


class HealthMonitorMetrics:
    """Families served by the health monitor's /metrics (the reference's
    ``tpu_health_*`` as ``gpu_health_*``)."""

    def __init__(self, registry: Registry | None = None):
        reg = registry or Registry()
        self.registry = reg
        self.probe_runs_total = Counter(
            "gpu_health_probe_runs_total",
            "Probe executions, by probe", labelnames=("probe",), registry=reg)
        self.probe_failures_total = Counter(
            "gpu_health_probe_failures_total",
            "Probe executions that returned at least one unhealthy result, "
            "by probe", labelnames=("probe",), registry=reg)
        self.probe_duration_seconds = Histogram(
            "gpu_health_probe_duration_seconds",
            "Wall seconds per probe execution", labelnames=("probe",),
            registry=reg, buckets=PROBE_BUCKETS)
        self.gpus_unhealthy = Gauge(
            "gpu_health_gpus_unhealthy",
            "GPUs currently published unhealthy (post-hysteresis)",
            registry=reg)
        self.node_healthy = Gauge(
            "gpu_health_node_healthy",
            "Published node verdict: 1 healthy, 0 unhealthy "
            "(post-hysteresis — raw probe flaps do not move this)",
            registry=reg)
        self.condition_flips_total = Counter(
            "gpu_health_condition_flips_total",
            "Times the published node condition changed state", registry=reg)


class HealthMonitor:
    """One instance per node (the DaemonSet pod). ``probes`` and ``clock``
    are injectable — the mttr harness drives seeded fake probes through
    virtual time; production builds them from the spec via
    probes.probes_from_spec()."""

    def __init__(self, client, node_name: str, probes: list,
                 health_file: str = DEFAULT_HEALTH_FILE,
                 unhealthy_after_s: float = 60.0,
                 healthy_after_s: float = 120.0,
                 clock=time.time, metrics: HealthMonitorMetrics | None = None,
                 tracer: trace.Tracer | None = None,
                 monotonic=time.monotonic):
        self.client = client
        self.node_name = node_name
        self.probes = probes
        self.health_file = health_file
        self.clock = clock
        # duration timing (probe_duration_seconds) is monotonic so wall
        # steps can't skew it; injectable like ``clock`` for virtual time
        self.monotonic = monotonic
        self.metrics = metrics or HealthMonitorMetrics()
        # optional tracer: each reconcile_once becomes one "health.cycle"
        # trace with a child span per probe (served on /debug/traces)
        self.tracer = tracer
        self.debouncer = Debouncer(unhealthy_after_s, healthy_after_s,
                                   clock=clock)
        self._last_file: tuple | None = None

    # -- probe sweep ------------------------------------------------------
    def _sweep(self) -> tuple[dict, dict]:
        """Run every probe; fold results into raw per-key health:
        {key: healthy} plus {key: detail} for the bad ones. A key is a GPU
        index or NODE_KEY."""
        raw: dict = {}
        detail: dict = {}
        for probe in self.probes:
            pname = getattr(probe, "name", str(probe))
            t0 = self.monotonic()
            with trace.span("health.probe", probe=pname,
                            node=self.node_name) as sp:
                try:
                    results = probe.run()
                except Exception as e:  # a crashing probe is a skip,
                    #                     not a fail
                    log.warning("health probe %s crashed: %s", pname, e)
                    results = []
                sp.set(results=len(results),
                       unhealthy=sum(1 for r in results if not r.healthy))
            self.metrics.probe_runs_total.labels(pname).inc()
            self.metrics.probe_duration_seconds.labels(pname).observe(
                self.monotonic() - t0)
            if any(not r.healthy for r in results):
                self.metrics.probe_failures_total.labels(pname).inc()
            for r in results:
                key = NODE_KEY if r.gpu_index is None else r.gpu_index
                raw[key] = raw.get(key, True) and r.healthy
                if not r.healthy and r.detail:
                    detail.setdefault(key, f"{r.probe}: {r.detail}")
        return raw, detail

    # -- publication ------------------------------------------------------
    def _write_health_file(self, bad_gpus: list[int]):
        want = tuple(sorted(bad_gpus))
        if want == self._last_file:
            return
        tmp = f"{self.health_file}.tmp"
        try:
            os.makedirs(os.path.dirname(self.health_file) or ".",
                        exist_ok=True)
            with open(tmp, "w") as f:
                f.write("".join(f"{i}\n" for i in want))
            os.replace(tmp, self.health_file)
            self._last_file = want
        except OSError as e:
            log.warning("health file %s not writable: %s",
                        self.health_file, e)

    def _publish_node(self, healthy: bool, message: str,
                      bad_gpus: dict[int, str]):
        node = self.client.get("Node", self.node_name)
        now = self.clock()
        # annotations: one per unhealthy GPU; stale ones removed
        ann_patch: dict = {}
        want = {GPU_ANNOTATION_FMT.format(i): d or "unhealthy"
                for i, d in bad_gpus.items()}
        for k, v in want.items():
            if node.annotations.get(k) != v:
                ann_patch[k] = v
        for k in node.annotations:
            if k.startswith(GPU_ANNOTATION_PREFIX) and k.endswith(".health") \
                    and k not in want:
                ann_patch[k] = None
        if ann_patch:
            self.client.patch("Node", self.node_name,
                              patch={"metadata": {"annotations": ann_patch}})
        # condition: full list (merge patch replaces lists), ours swapped in
        conds = list(node.get("status", "conditions", default=[]) or [])
        ours = next((c for c in conds
                     if c.get("type") == NODE_CONDITION_TYPE), None)
        status = "True" if healthy else "False"
        reason = "ProbesPassed" if healthy else "ProbeFailed"
        if ours is not None and ours.get("status") == status and \
                ours.get("message") == message:
            return  # converged: no write
        flipped = ours is None or ours.get("status") != status
        cond = {"type": NODE_CONDITION_TYPE, "status": status,
                "reason": reason, "message": message,
                "lastTransitionTime":
                    iso_ts(now) if flipped
                    else ours.get("lastTransitionTime", iso_ts(now))}
        conds = [c for c in conds
                 if c.get("type") != NODE_CONDITION_TYPE] + [cond]
        self.client.patch("Node", self.node_name,
                          patch={"status": {"conditions": conds}},
                          subresource="status")
        if flipped:
            # first publication is not a state change — only count actual
            # transitions, so a freshly scheduled monitor pod reads 0
            if ours is not None:
                self.metrics.condition_flips_total.inc()
            log.info("node %s %s: %s", self.node_name,
                     NODE_CONDITION_TYPE + "=" + status, message)

    # -- loop -------------------------------------------------------------
    def reconcile_once(self) -> dict:
        """One probe→debounce→publish cycle, wrapped in a root span when a
        tracer is attached (probe spans then nest under it)."""
        root = (self.tracer.start_trace("health.cycle", node=self.node_name)
                if self.tracer is not None else trace.NULL_SPAN)
        with root:
            out = self._reconcile_once()
            root.set(healthy=out["healthy"],
                     unhealthy_gpus=len(out["unhealthy_gpus"]))
        return out

    def _reconcile_once(self) -> dict:
        raw, detail = self._sweep()
        # a GPU the debouncer has seen that NO probe reported this pass has
        # vanished outright (its device node is gone, so every per-GPU
        # probe skips it); absence is a bad observation, debounced like any
        # other so a transient enumeration hiccup can't quarantine
        for key in self.debouncer.keys():
            if key != NODE_KEY and key not in raw:
                raw[key] = False
                detail.setdefault(
                    key, "device-presence: GPU no longer observed")
        bad_gpus: dict[int, str] = {}
        node_ok = True
        for key, healthy in raw.items():
            published = self.debouncer.observe(key, healthy)
            if key == NODE_KEY:
                node_ok = node_ok and published
            elif not published:
                bad_gpus[key] = detail.get(key, "")
        healthy = node_ok and not bad_gpus
        if healthy:
            message = "all probes passed"
        elif bad_gpus:
            message = "; ".join(
                f"GPU {i}: {d or 'unhealthy'}"
                for i, d in sorted(bad_gpus.items()))
        else:
            message = detail.get(NODE_KEY, "node probe failed")
        self._write_health_file(sorted(bad_gpus))
        self._publish_node(healthy, message, bad_gpus)
        self.metrics.gpus_unhealthy.set(len(bad_gpus))
        self.metrics.node_healthy.set(1 if healthy else 0)
        return {"node": self.node_name, "healthy": healthy,
                "unhealthy_gpus": sorted(bad_gpus), "message": message}

    def run(self, interval_s: float = 30.0, stop=None):
        while stop is None or not stop.is_set():
            try:
                self.reconcile_once()
            except Exception as e:
                log.warning("health monitor pass failed: %s", e)
            if stop is not None:
                if stop.wait(interval_s):
                    break
            else:
                time.sleep(interval_s)
