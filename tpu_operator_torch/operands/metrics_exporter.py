"""gpu-metrics-exporter — node metrics relabeling proxy (tier-3 metrics).

The port of ``tpu_operator/operands/metrics_exporter.py``: the dcgm-exporter
analogue (SURVEY.md §2.3 row 'dcgm-exporter'), a DaemonSet that scrapes the
node-local agent and re-serves its samples to Prometheus with cluster
identity attached. It scrapes the C++ ``gpu-metrics-agent``
(``tpu_operator_torch/native/gpu_metrics_agent``, Prometheus text on
:9401), stamps every sample with ``node``/``accelerator`` labels, appends
the validator status files' readiness gauges, and serves the result on
:9400. Only the names change: ``gpu_exporter_*`` → ``gpu_exporter_*``, and
the component list is the port's validator's.

The agent already speaks exposition format, so the exporter is a relabeling
proxy, not a protocol translator: parse → stamp → re-render. A scrape of the
exporter always succeeds even when the agent is down — ``gpu_exporter_up 0``
plus stale-free output (no cached agent samples are re-served) is the signal,
as dcgm-exporter drops its DCGM_FI_* families when the host engine goes away
rather than serving stale values.
"""

from __future__ import annotations

import http.client
import logging
import os
import threading
import time
import urllib.error
import urllib.request
from dataclasses import dataclass, field

from tpu_operator_torch.utils import prom
from tpu_operator_torch.utils.prom import _escape

log = logging.getLogger("gpu-metrics-exporter")


@dataclass
class Sample:
    name: str
    labels: dict
    value: str  # kept verbatim (exposition allows +Inf, NaN, exponents)


@dataclass
class Family:
    name: str
    help: str | None = None
    type: str | None = None
    samples: list = field(default_factory=list)


def parse_exposition(text: str) -> list[Family]:
    """Parse Prometheus text exposition 0.0.4 into families.

    Handles HELP/TYPE comments, labeled and unlabeled samples, and escaped
    label values. Unknown/malformed lines are skipped (a half-written scrape
    from the agent must not take the exporter down).
    """
    families: dict[str, Family] = {}

    def fam(name: str) -> Family:
        # sysfs-attr families arrive sample-by-sample; group by metric name
        if name not in families:
            families[name] = Family(name)
        return families[name]

    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_ = rest.partition(" ")
            fam(name).help = help_
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, type_ = rest.partition(" ")
            fam(name).type = type_.strip()
            continue
        if line.startswith("#"):
            continue
        sample = _parse_sample(line)
        if sample is not None:
            fam(sample.name).samples.append(sample)
    return list(families.values())


def _valid_value(v: str) -> bool:
    try:
        float(v)  # accepts inf/nan/exponents, the exposition value grammar
        return True
    except ValueError:
        return False


def _parse_sample(line: str) -> Sample | None:
    brace = line.find("{")
    if brace == -1:
        parts = line.split(None, 1)
        if len(parts) != 2 or not _valid_value(parts[1].split()[0]):
            return None
        return Sample(parts[0], {}, parts[1].split()[0])
    name = line[:brace]
    end = line.rfind("}")
    if end == -1 or not line[end + 1:].strip():
        return None
    labels = _parse_labels(line[brace + 1:end])
    value = line[end + 1:].split()[0]
    if labels is None or not _valid_value(value):
        return None
    return Sample(name, labels, value)


def _parse_labels(body: str) -> dict | None:
    labels: dict[str, str] = {}
    i = 0
    while i < len(body):
        eq = body.find("=", i)
        if eq == -1:
            return labels if not body[i:].strip(", ") else None
        key = body[i:eq].strip().lstrip(",").strip()
        if len(body) <= eq + 1 or body[eq + 1] != '"':
            return None
        # scan the quoted value honoring backslash escapes
        j = eq + 2
        out = []
        while j < len(body):
            c = body[j]
            if c == "\\" and j + 1 < len(body):
                nxt = body[j + 1]
                out.append({"n": "\n", "\\": "\\", '"': '"'}.get(nxt, nxt))
                j += 2
                continue
            if c == '"':
                break
            out.append(c)
            j += 1
        else:
            return None
        labels[key] = "".join(out)
        i = j + 1
    return labels


def render(families: list[Family], extra_labels: dict) -> str:
    """Re-render families with ``extra_labels`` stamped on every sample.

    Sample-level labels win on collision so a future agent that already
    emits ``node`` is not clobbered.
    """
    out: list[str] = []
    for f in families:
        if f.help is not None:
            out.append(f"# HELP {f.name} {f.help}\n")
        if f.type is not None:
            out.append(f"# TYPE {f.name} {f.type}\n")
        for s in f.samples:
            merged = {**extra_labels, **s.labels}
            if merged:
                lbl = ",".join(
                    f'{k}="{_escape(v)}"' for k, v in merged.items())
                out.append(f"{s.name}{{{lbl}}} {s.value}\n")
            else:
                out.append(f"{s.name} {s.value}\n")
    return "".join(out)


class MetricsExporter:
    """Scrape the agent, relabel, re-serve; plus exporter meta-metrics and
    validator status-file readiness gauges (the node_status_exporter tier
    shares those files via the hostPath mount in
    the metrics exporter DaemonSet)."""

    def __init__(self, agent_addr: str, node_name: str = "",
                 accelerator: str = "", validations_dir: str | None = None,
                 timeout: float = 5.0):
        self.agent_addr = agent_addr
        self.node_name = node_name
        self.accelerator = accelerator
        self.validations_dir = validations_dir
        self.timeout = timeout
        self._lock = threading.Lock()
        self._relabeled = ""  # last successful scrape, already rendered

        self.registry = prom.Registry()
        self.up = prom.Gauge(
            "gpu_exporter_up", "1 if the last agent scrape succeeded",
            registry=self.registry)
        self.scrapes = prom.Counter(
            "gpu_exporter_scrapes_total", "agent scrape attempts",
            registry=self.registry)
        self.scrape_errors = prom.Counter(
            "gpu_exporter_scrape_errors_total", "failed agent scrapes",
            registry=self.registry)
        self.scrape_seconds = prom.Gauge(
            "gpu_exporter_last_scrape_duration_seconds",
            "duration of the last agent scrape", registry=self.registry)
        self.last_success = prom.Gauge(
            "gpu_exporter_last_scrape_success_ts_seconds",
            "unix time of the last successful agent scrape",
            registry=self.registry)
        self.validation_ready = prom.Gauge(
            "gpu_exporter_validation_ready",
            "1 if the component's validator status file is present",
            labelnames=("component",), registry=self.registry)

    # -- scraping ---------------------------------------------------------

    def fetch(self) -> str:
        url = self.agent_addr
        if "://" not in url:
            url = "http://" + url
        if not url.endswith("/metrics"):
            url = url.rstrip("/") + "/metrics"
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            return r.read().decode("utf-8", "replace")

    def extra_labels(self) -> dict:
        labels = {}
        if self.node_name:
            labels["node"] = self.node_name
        if self.accelerator:
            labels["accelerator"] = self.accelerator
        return labels

    def scrape_once(self) -> bool:
        self.scrapes.inc()
        t0 = time.monotonic()
        try:
            raw = self.fetch()
        except (OSError, urllib.error.URLError,
                http.client.HTTPException) as e:
            # HTTPException covers a mid-response agent death
            # (IncompleteRead/BadStatusLine) — the exporter must degrade to
            # gpu_exporter_up 0, never crash-loop the DaemonSet
            self.scrape_seconds.set(time.monotonic() - t0)
            self.scrape_errors.inc()
            self.up.set(0)
            with self._lock:
                self._relabeled = ""  # never serve stale agent samples
            log.warning("agent scrape failed (%s): %s", self.agent_addr, e)
            return False
        self.scrape_seconds.set(time.monotonic() - t0)
        relabeled = render(parse_exposition(raw), self.extra_labels())
        with self._lock:
            self._relabeled = relabeled
        self.up.set(1)
        self.last_success.set(time.time())
        return True

    def _refresh_validations(self):
        if not self.validations_dir:
            return
        # the component list is the validator's, not a private copy; "gate"
        # is the init-chain barrier component and writes no status file
        from tpu_operator_torch.validator.components import VALID_COMPONENTS
        try:
            present = {f[:-len("-ready")]
                       for f in os.listdir(self.validations_dir)
                       if f.endswith("-ready")}
        except OSError:
            present = set()
        known = set(VALID_COMPONENTS) - {"gate"}
        # zero every label ever seen, so a removed status file (preStop
        # re-gating) drops to 0 instead of serving a stale 1
        self._seen_components = getattr(self, "_seen_components",
                                        set()) | known | present
        for component in sorted(self._seen_components):
            self.validation_ready.labels(component).set(
                1 if component in present else 0)

    # -- serving ----------------------------------------------------------

    def render(self) -> str:
        """One exporter page: meta-metrics + readiness + relabeled agent."""
        self._refresh_validations()
        with self._lock:
            passthrough = self._relabeled
        return self.registry.render() + passthrough

    def run(self, port: int = 9400, interval: float = 15.0,
            stop: threading.Event | None = None) -> None:
        # prom.serve only calls .render() per request, which this class
        # provides (registry + relabeled agent passthrough)
        stop = stop or threading.Event()
        srv = prom.serve(self, port)
        log.info("serving on :%d, scraping %s every %.0fs",
                 srv.server_address[1], self.agent_addr, interval)
        try:
            while not stop.is_set():
                self.scrape_once()
                stop.wait(interval)
        finally:
            srv.shutdown()
