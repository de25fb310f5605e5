"""Minimal Prometheus client: counters/gauges/histograms + exposition + HTTP.

The port's copy of ``tpu_operator/utils/prom.py``, which uses no device: the
port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Self-contained replacement for the prometheus client libraries the reference
links (controllers/operator_metrics.go, validator/metrics.go): labeled
gauges/counters/histograms rendered in exposition format 0.0.4 and served
from a background thread, plus the operator's debug surface (/readyz gated
on first successful reconcile, /debug/traces serving the tracer's ring
buffer as Chrome trace-event JSON).

Writes funnel through ``_Metric._set`` / ``_Metric._inc`` under ``_lock``
for BOTH the unlabeled shortcut and the ``labels(...)`` path, so type
invariants (counters only go up) hold no matter how a family is addressed,
and reads take the same lock — the DAG executor updates metrics from worker
threads.

Histograms additionally accept **exemplars** — ``observe(v, exemplar=
{"trace_id": ...})`` stores the most recent exemplar per bucket, exposed
via ``exemplars()`` and rendered in OpenMetrics exposition (`` # {labels}
value`` bucket suffixes) when a scraper negotiates
``Accept: application/openmetrics-text``. The default 0.0.4 text render is
byte-identical to before — exemplars are opt-in at scrape time, so Grafana
can join a latency spike to the exact trace in the flight recorder.
"""

from __future__ import annotations

import bisect
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class Registry:
    def __init__(self):
        self._metrics: list = []
        self._lock = threading.Lock()

    def register(self, metric):
        with self._lock:
            self._metrics.append(metric)
        return metric

    def families(self) -> list["_Metric"]:
        """Registered metric objects (docs↔code consistency test)."""
        with self._lock:
            return list(self._metrics)

    def render(self, openmetrics: bool = False) -> str:
        with self._lock:
            body = "".join(m.render(openmetrics) for m in self._metrics)
        return body + "# EOF\n" if openmetrics else body


DEFAULT_REGISTRY = Registry()


class _Metric:
    TYPE = "untyped"

    def __init__(self, name: str, help_: str, labelnames: tuple = (),
                 registry: Registry | None = None):
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._values: dict[tuple, float] = {}
        self._bound: dict[tuple, "_Bound"] = {}
        self._lock = threading.Lock()
        (registry or DEFAULT_REGISTRY).register(self)

    def labels(self, *labelvalues: str) -> "_Bound":
        # children are cached per labelset (client_golang-style): the hot
        # reconcile path calls labels() per lookup and the bound handle is
        # immutable. Races just build the same child twice — harmless.
        b = self._bound.get(labelvalues)
        if b is None:
            if len(labelvalues) != len(self.labelnames):
                raise ValueError(f"{self.name}: expected labels "
                                 f"{self.labelnames}, got {labelvalues}")
            b = self._bound[labelvalues] = _Bound(
                self, tuple(str(v) for v in labelvalues))
        return b

    # unlabeled shortcuts
    def set(self, v: float):
        self.labels().set(v)

    def inc(self, v: float = 1):
        self.labels().inc(v)

    def get(self, *labelvalues) -> float:
        with self._lock:
            return self._values.get(tuple(str(v) for v in labelvalues), 0.0)

    def remove(self, *labelvalues):
        """Drop the child for one labelset so a departed label value (e.g.
        a slice that left the fleet) stops being exported instead of
        holding its last value forever."""
        lv = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._values.pop(lv, None)
            self._bound.pop(lv, None)

    # type-invariant chokepoints: every write path lands here
    def _set(self, lv: tuple, v: float):
        with self._lock:
            self._values[lv] = float(v)

    def _inc(self, lv: tuple, v: float):
        with self._lock:
            self._values[lv] = self._values.get(lv, 0.0) + v

    def render(self, openmetrics: bool = False) -> str:
        out = [f"# HELP {self.name} {self.help}\n",
               f"# TYPE {self.name} {self.TYPE}\n"]
        with self._lock:
            items = sorted(self._values.items())
        if not items:
            return "".join(out)
        for labelvalues, v in items:
            if labelvalues:
                lbl = ",".join(f'{k}="{_escape(v2)}"' for k, v2 in
                               zip(self.labelnames, labelvalues))
                out.append(f"{self.name}{{{lbl}}} {_fmt(v)}\n")
            else:
                out.append(f"{self.name} {_fmt(v)}\n")
        return "".join(out)


def _escape(s: str) -> str:
    return s.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


class _Bound:
    def __init__(self, metric: _Metric, labelvalues: tuple):
        self.m = metric
        self.lv = labelvalues

    def set(self, v: float):
        self.m._set(self.lv, v)

    def inc(self, v: float = 1):
        self.m._inc(self.lv, v)

    def observe(self, v: float, exemplar: dict | None = None):
        self.m._observe(self.lv, v, exemplar)


class Gauge(_Metric):
    TYPE = "gauge"


class Counter(_Metric):
    TYPE = "counter"

    def set(self, v):  # counters only go up
        raise AttributeError("counters cannot be set; use inc()")

    def _set(self, lv, v):  # same invariant via labels(...).set(...)
        raise AttributeError("counters cannot be set; use inc()")

    def _inc(self, lv, v):
        if v < 0:
            raise ValueError(f"{self.name}: counter increment must be >= 0, "
                             f"got {v}")
        super()._inc(lv, v)


# latency-oriented default: 1ms .. ~100s, roughly log-spaced
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                   0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 100.0)


class Histogram(_Metric):
    """Cumulative-bucket histogram per labelset: ``<name>_bucket{le=...}``
    (monotone, +Inf == count), ``<name>_sum``, ``<name>_count``."""

    TYPE = "histogram"

    def __init__(self, name: str, help_: str, labelnames: tuple = (),
                 registry: Registry | None = None,
                 buckets: tuple = DEFAULT_BUCKETS):
        super().__init__(name, help_, labelnames, registry)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        # labelset -> [per-bucket counts (non-cumulative) + overflow, sum]
        self._h: dict[tuple, list] = {}
        # labelset -> bucket index -> (exemplar labels, observed value):
        # last-write-wins per bucket, OpenTelemetry/client_golang style
        self._ex: dict[tuple, dict[int, tuple[dict, float]]] = {}

    def observe(self, v: float, exemplar: dict | None = None):
        self._observe((), v, exemplar)

    def _observe(self, lv: tuple, v: float, exemplar: dict | None = None):
        v = float(v)
        with self._lock:
            row = self._h.get(lv)
            if row is None:
                row = self._h[lv] = [[0] * (len(self.buckets) + 1), 0.0]
            i = bisect.bisect_left(self.buckets, v)
            row[0][i] += 1
            row[1] += v
            if exemplar:
                self._ex.setdefault(lv, {})[i] = (dict(exemplar), v)

    def exemplars(self, *labelvalues) -> dict:
        """Bucket upper-edge -> {"labels": ..., "value": ...} for the
        labelset — the join key from a histogram bucket to its exemplar
        trace in the flight recorder."""
        lv = tuple(str(v) for v in labelvalues)
        edges = (*self.buckets, float("inf"))
        with self._lock:
            return {edges[i]: {"labels": dict(lbls), "value": val}
                    for i, (lbls, val) in self._ex.get(lv, {}).items()}

    def _set(self, lv, v):
        raise AttributeError("histograms take observe(), not set()")

    def _inc(self, lv, v):
        raise AttributeError("histograms take observe(), not inc()")

    def get(self, *labelvalues) -> float:
        """Observation count for the labelset (mirrors Counter.get)."""
        lv = tuple(str(v) for v in labelvalues)
        with self._lock:
            row = self._h.get(lv)
            return float(sum(row[0])) if row else 0.0

    def remove(self, *labelvalues):
        lv = tuple(str(v) for v in labelvalues)
        with self._lock:
            self._h.pop(lv, None)
            self._ex.pop(lv, None)
            self._values.pop(lv, None)
            self._bound.pop(lv, None)

    def sum(self, *labelvalues) -> float:
        lv = tuple(str(v) for v in labelvalues)
        with self._lock:
            row = self._h.get(lv)
            return row[1] if row else 0.0

    def quantile(self, q: float, *labelvalues) -> float:
        """histogram_quantile-style estimate: linear interpolation inside
        the bucket holding rank q (lower bound 0, upper bound clamps the
        +Inf bucket to the largest finite edge). NaN-free: returns 0.0 for
        an empty labelset."""
        lv = tuple(str(v) for v in labelvalues)
        with self._lock:
            row = self._h.get(lv)
            if not row:
                return 0.0
            counts = list(row[0])
        return self._quantile_from_counts(counts, q)

    def quantile_all(self, q: float) -> float:
        """quantile() over the merged distribution of EVERY labelset —
        what "p99 across all states/verbs" means (identical buckets make
        the merge a columnwise sum)."""
        with self._lock:
            rows = [row[0] for row in self._h.values()]
            counts = [sum(col) for col in zip(*rows)] if rows else []
        if not counts:
            return 0.0
        return self._quantile_from_counts(counts, q)

    def _quantile_from_counts(self, counts: list, q: float) -> float:
        total = sum(counts)
        if total == 0:
            return 0.0
        rank = q * total
        cum = 0
        for i, c in enumerate(counts):
            prev_cum = cum
            cum += c
            if cum >= rank:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = self.buckets[i] if i < len(self.buckets) \
                    else self.buckets[-1]
                if c == 0 or hi == lo:
                    return hi
                return lo + (hi - lo) * (rank - prev_cum) / c
        return self.buckets[-1]

    def render(self, openmetrics: bool = False) -> str:
        out = [f"# HELP {self.name} {self.help}\n",
               f"# TYPE {self.name} {self.TYPE}\n"]
        with self._lock:
            items = sorted((lv, (list(row[0]), row[1]))
                           for lv, row in self._h.items())
            ex = {lv: dict(b) for lv, b in self._ex.items()} \
                if openmetrics else {}
        for lv, (counts, total_sum) in items:
            base = ",".join(f'{k}="{_escape(v)}"' for k, v in
                            zip(self.labelnames, lv))
            cum = 0
            for i, (edge, c) in enumerate(
                    zip((*self.buckets, float("inf")), counts)):
                cum += c
                lbl = f'{base},le="{_fmt(edge)}"' if base \
                    else f'le="{_fmt(edge)}"'
                line = f"{self.name}_bucket{{{lbl}}} {cum}"
                hit = ex.get(lv, {}).get(i)
                if hit is not None:
                    elbl = ",".join(f'{k}="{_escape(str(v))}"'
                                    for k, v in sorted(hit[0].items()))
                    line += f" # {{{elbl}}} {_fmt(hit[1])}"
                out.append(line + "\n")
            suffix = f"{{{base}}}" if base else ""
            out.append(f"{self.name}_sum{suffix} {_fmt(total_sum)}\n")
            out.append(f"{self.name}_count{suffix} {cum}\n")
        return "".join(out)


def serve(registry: Registry, port: int, addr: str = "",
          ready_check=None, tracer=None,
          goodput_json=None, pools_json=None,
          slow_json=None, utilization_json=None) -> ThreadingHTTPServer:
    """Serve /metrics (+ /healthz, /readyz, /debug/traces, /debug/metrics,
    /debug/goodput, /debug/pools, /debug/slow, /debug/utilization) in a
    daemon thread; returns
    the server (call .shutdown() to stop). Port 0 picks a free port (tests).
    ``ready_check`` is a zero-arg callable — /readyz is 503 until it
    returns truthy (no callback keeps the old always-ok behaviour).
    ``tracer`` enables /debug/traces with the ring buffer of recent
    traces as Chrome trace-event JSON. ``goodput_json`` is a
    zero-arg callable returning the fleet goodput breakdown as a dict —
    it enables /debug/goodput. ``pools_json`` likewise enables
    /debug/pools with every connection pool's counters (the apiserver
    keep-alive pool, the relay channel pool), ``slow_json`` enables
    /debug/slow with the tail-sampled flight recorder's retained request
    traces, and ``utilization_json`` enables /debug/utilization with the
    capacity ledger's component decomposition. /debug/metrics is an alias
    of /metrics, so every debug surface
    lives under one prefix. A scraper that negotiates
    ``Accept: application/openmetrics-text`` on /metrics gets the
    OpenMetrics render with histogram exemplars."""

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            ctype = "text/plain; version=0.0.4; charset=utf-8"
            status = 200
            if self.path in ("/metrics", "/debug/metrics"):
                if "application/openmetrics-text" in \
                        self.headers.get("Accept", ""):
                    ctype = ("application/openmetrics-text; "
                             "version=1.0.0; charset=utf-8")
                    body = registry.render(openmetrics=True)
                else:
                    body = registry.render()
            elif self.path == "/healthz":
                body = "ok"
            elif self.path == "/readyz":
                if ready_check is not None and not ready_check():
                    status, body = 503, "not ready"
                else:
                    body = "ok"
            elif self.path == "/debug/traces" and tracer is not None:
                ctype = "application/json"
                body = tracer.chrome_json()
            elif self.path == "/debug/goodput" and goodput_json is not None:
                ctype = "application/json"
                body = json.dumps(goodput_json(), sort_keys=True)
            elif self.path == "/debug/pools" and pools_json is not None:
                ctype = "application/json"
                body = json.dumps(pools_json(), sort_keys=True)
            elif self.path == "/debug/slow" and slow_json is not None:
                ctype = "application/json"
                body = json.dumps(slow_json(), sort_keys=True)
            elif self.path == "/debug/utilization" and \
                    utilization_json is not None:
                ctype = "application/json"
                body = json.dumps(utilization_json(), sort_keys=True)
            else:
                self.send_error(404)
                return
            body = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

    srv = ThreadingHTTPServer((addr, port), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv
