"""Health probe engine — the DCGM-health-check analogue for GPU hosts.

The port of ``tpu_operator/health/probes.py``. Each probe returns
``ProbeResult`` rows scoped to a GPU index (the ``N`` of ``/dev/nvidiaN``)
or to the whole node (``gpu_index is None``). A probe that cannot measure
(NVML absent, an attribute the card does not report, no CUDA card for the
HBM sweep) returns nothing rather than a failure: "unknown" must never
quarantine a node, only a positive bad signal may.

The link and counter probes read per-device attributes from a source:
``NvmlSource()`` (the driver's own counters) by default, or a
``FileSource(root)`` in the reference's attribute-file layout.

Unlike the reference's, the HBM sweep compares the report's
``read_gbps`` with its floor: the reference compares the ``HbmReport``
itself, which raises ``TypeError`` outside its ``try``, so the monitor
logged it as a crashed probe and never judged a node by it.
"""

from __future__ import annotations

import logging
import time

from tpu_operator_torch.deviceplugin.discovery import HEALTHY, GpuDiscovery
from tpu_operator_torch.utils.nvml import FileSource, NvmlSource

log = logging.getLogger("gpu-operator")


class ProbeResult:
    """One observation: ``probe`` name, ``healthy`` verdict, free-text
    ``detail``, scoped to ``gpu_index`` (None = node-scoped)."""

    __slots__ = ("probe", "healthy", "detail", "gpu_index")

    def __init__(self, probe: str, healthy: bool, detail: str = "",
                 gpu_index: int | None = None):
        self.probe = probe
        self.healthy = healthy
        self.detail = detail
        self.gpu_index = gpu_index

    def __repr__(self):
        scope = "node" if self.gpu_index is None else f"gpu{self.gpu_index}"
        return (f"ProbeResult({self.probe}/{scope} "
                f"{'ok' if self.healthy else 'BAD'} {self.detail!r})")


class DevicePresenceProbe:
    """Device presence: every expected card's node exists and is openable
    (reference analogue: NVML device enumeration health).

    ``expected_gpus`` arms the vanished-card guard: fewer visible cards
    than expected is a node-scoped failure. When not given, the first
    non-empty scan arms it automatically — a node's card census is fixed
    hardware, so a later shrink is a card whose /dev node disappeared, not
    a node that legitimately has fewer cards."""

    name = "device-presence"

    def __init__(self, discovery: GpuDiscovery | None = None,
                 expected_gpus: int | None = None):
        self.discovery = discovery or GpuDiscovery()
        self.expected_gpus = expected_gpus

    def run(self) -> list[ProbeResult]:
        devices = self.discovery.scan()
        out = []
        if not devices:
            return [ProbeResult(self.name, False, "no GPU device nodes")]
        if self.expected_gpus is None:
            self.expected_gpus = len(devices)
        for d in devices:
            out.append(ProbeResult(
                self.name, d.health == HEALTHY,
                "" if d.health == HEALTHY else f"{d.path} not accessible",
                gpu_index=d.index))
        if self.expected_gpus and len(devices) < self.expected_gpus:
            out.append(ProbeResult(
                self.name, False,
                f"{len(devices)}/{self.expected_gpus} GPUs visible"))
        return out


class NvLinkProbe:
    """Per-card NVLink state (reference: ``IciLinkProbe``): ``nvlink_up``
    holding ``1`` (every link up) or ``0`` (a link down). A card without
    the attribute (no NVLink, NVML absent) is skipped, not failed."""

    name = "nvlink"
    attr = "nvlink_up"

    def __init__(self, source=None):
        self.source = source if source is not None else NvmlSource()

    def run(self) -> list[ProbeResult]:
        out = []
        for idx, attrs in self.source.attributes().items():
            value = attrs.get(self.attr)
            if value is None:
                continue
            up = value.strip() not in ("0", "down", "false")
            detail = ""
            if not up:
                detail = f"{self.source.where(idx, self.attr)} reports " \
                         f"link down"
                if attrs.get("nvlink_down"):
                    detail += f" (links {attrs['nvlink_down']})"
            out.append(ProbeResult(self.name, up, detail, gpu_index=idx))
        return out


class CounterThresholdProbe:
    """Per-card error-counter thresholds: a cumulative count above the
    configured threshold marks the card unhealthy (reference analogue:
    DCGM row-remap policies). NVML's counters: ``ecc_corrected_volatile``,
    ``ecc_uncorrected_volatile``, ``remapped_rows_pending``,
    ``remapped_rows_failure``."""

    name = "counter-threshold"

    def __init__(self, thresholds: dict, source=None):
        self.thresholds = dict(thresholds or {})
        self.source = source if source is not None else NvmlSource()

    def run(self) -> list[ProbeResult]:
        out = []
        if not self.thresholds:
            return out
        for idx, attrs in self.source.attributes().items():
            for counter, limit in self.thresholds.items():
                try:
                    value = float(attrs[counter].strip())
                except (KeyError, ValueError):
                    continue
                ok = value <= float(limit)
                out.append(ProbeResult(
                    self.name, ok,
                    "" if ok else f"{counter}={value:g} > {limit:g}",
                    gpu_index=idx))
        return out


class HbmSweepProbe:
    """Bounded HBM bandwidth sweep on K1 (``ops/hbm.py``). Node-scoped and
    opt-in (spec.healthMonitor.hbmSweep.enable): it touches the device, so
    it must only run on quiesced/quarantined cards. ``min_gbps`` of 0
    makes it a pure read-probe (any successful measurement passes).

    It skips only for the two unknowns: no CUDA card, and an allocation
    that fails. A bad checksum is a failed result. A kernel that does not
    build or launch raises, and the monitor logs it as a crashed probe.

    At the default 8 MiB the array sits in the H100's 50 MB L2 and a
    sweep takes microseconds, so the launch and the fetch set the rate:
    it is neither HBM's rate nor a stable floor for ``min_gbps``."""

    name = "hbm-sweep"

    def __init__(self, size_mb: int = 8, min_gbps: float = 0.0,
                 device: str = "cuda"):
        self.size_mb = max(1, int(size_mb))
        self.min_gbps = float(min_gbps)
        self.device = device

    def run(self) -> list[ProbeResult]:
        import torch

        from tpu_operator_torch.ops.hbm import ProbeError, hbm_read_gbps
        if torch.device(self.device).type == "cuda" and \
                not torch.cuda.is_available():
            return []
        t0 = time.monotonic()
        try:
            report = hbm_read_gbps(size_mb=self.size_mb, sweeps=2, iters=2,
                                   device=self.device)
        except ProbeError as e:
            return [ProbeResult(self.name, False, f"sweep failed: {e}")]
        except torch.cuda.OutOfMemoryError as e:
            log.debug("hbm sweep skipped: %s", e)
            return []
        gbps = report.read_gbps
        ok = gbps >= self.min_gbps
        return [ProbeResult(
            self.name, ok,
            f"{gbps:.1f} GB/s in {time.monotonic() - t0:.2f}s"
            + ("" if ok else f" < floor {self.min_gbps:g}"))]


def probes_from_spec(spec, dev_root: str = "/dev",
                     sysfs_root: str | None = None,
                     expected_gpus: int | None = None) -> list:
    """Build the probe set a HealthMonitorSpec asks for.

    ``sysfs_root`` gives the link and counter probes a ``FileSource`` over
    that root; None reads NVML. ``expected_gpus`` overrides the presence
    probe's self-armed card census (None/0 → learn from the first
    non-empty scan)."""
    source = FileSource(sysfs_root) if sysfs_root else NvmlSource()
    out = [DevicePresenceProbe(GpuDiscovery(dev_root=dev_root),
                               expected_gpus=expected_gpus or None),
           NvLinkProbe(source=source)]
    if spec.counter_thresholds:
        out.append(CounterThresholdProbe(spec.counter_thresholds,
                                         source=source))
    if spec.hbm_sweep_enabled():
        out.append(HbmSweepProbe(
            size_mb=spec.hbm_sweep.get("sizeMb", 8),
            min_gbps=spec.hbm_sweep.get("minGbps", 0.0)))
    return out
