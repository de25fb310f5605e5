"""The device trace of a traced run: ``torch.profiler`` over a stretch of
the window, read back from its Chrome trace.

:class:`Tracer` starts the profiler at a step boundary and stops it at a
later one, inside a ``port_bench.trace_window`` annotation whose host
interval is the traced window. :func:`parse` turns the exported events into
a :class:`Trace`: the device's kernels, copies and fills, each tied to the
host call that launched it (by the profiler's correlation id), the
benchmark's annotations (``torch.profiler.record_function`` spans), and
the host's operators. Every time here is in microseconds on the
profiler's clock, which it aligns for host and device.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass

WINDOW = "port_bench.trace_window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
NAME_CHARS = 120          # a device op's name in the breakdown, at most
SMALL_GAP_US = 10.0       # gaps below this are one line of the breakdown
TOP = 10


@dataclass(frozen=True)
class DeviceOp:
    name: str
    device: int
    start: float
    end: float
    launch: float         # host time of the call that launched it

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-6


@dataclass(frozen=True)
class Span:
    name: str
    start: float
    end: float


class Trace:
    def __init__(self, ops: list[DeviceOp], spans: list[Span],
                 host: list[Span], window: tuple[float, float]):
        self.ops = ops
        self.spans = spans
        self.host = host
        self.window = window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self, device: int) -> list[tuple[float, float]]:
        """The device's busy time inside the window, merged."""
        lo, hi = self.window
        cut = sorted((max(op.start, lo), min(op.end, hi)) for op in self.ops
                     if op.device == device and op.end > lo and op.start < hi)
        merged: list[list[float]] = []
        for start, end in cut:
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], end)
            else:
                merged.append([start, end])
        return [(a, b) for a, b in merged]

    def busy_s(self, device: int) -> float:
        return sum(b - a for a, b in self.busy_intervals(device)) * 1e-6

    def busy_mean_s(self, devices) -> float:
        devices = list(devices)
        return sum(self.busy_s(d) for d in devices) / len(devices)

    def count(self, name: str) -> int:
        return sum(1 for s in self.spans if s.name == name)

    def under(self, name: str) -> list[DeviceOp]:
        """The device ops launched inside a span called ``name``."""
        spans = sorted((s.start, s.end) for s in self.spans if s.name == name)
        starts = [a for a, _ in spans]
        found = []
        for op in self.ops:
            i = bisect.bisect_right(starts, op.launch) - 1
            if i >= 0 and op.launch <= spans[i][1]:
                found.append(op)
        return found

    def device_ops(self) -> list[list]:
        """The device operations that took most time, summed by name over
        every device: [[name, seconds], ...]."""
        total: dict[str, float] = defaultdict(float)
        for op in self.ops:
            total[op.name[:NAME_CHARS]] += op.seconds
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self, devices) -> list[list]:
        """The device's idle time inside the window, summed over
        ``devices`` by what the host was doing at the middle of each gap:
        the innermost benchmark span and the innermost host operator, or
        one line for all gaps under :data:`SMALL_GAP_US`."""
        gaps = []
        lo, hi = self.window
        for device in devices:
            edge = lo
            for start, end in self.busy_intervals(device) + [(hi, hi)]:
                if start > edge:
                    gaps.append((edge, start))
                edge = max(edge, end)
        total: dict[str, float] = defaultdict(float)
        big = sorted(g for g in gaps if g[1] - g[0] >= SMALL_GAP_US)
        small = sum(b - a for a, b in gaps if b - a < SMALL_GAP_US)
        if small:
            total[f"gaps under {SMALL_GAP_US:g} us"] = small * 1e-6
        mids = [(a + b) / 2 for a, b in big]
        spans = _innermost([s for s in self.spans if s.name != WINDOW], mids)
        host = _innermost(self.host, mids)
        for (a, b), span, op in zip(big, spans, host):
            total[f"{span or '-'} / {op or 'no host op'}"] += (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(total.items(), key=lambda kv: -kv[1])[:TOP]]


def _innermost(spans: list[Span], points: list[float]) -> list[str | None]:
    """For each of the sorted ``points``, the name of the latest-starting
    span that contains it (spans of one thread nest), or None."""
    spans = sorted(spans, key=lambda s: s.start)
    active: list[Span] = []
    names = []
    i = 0
    for p in points:
        while i < len(spans) and spans[i].start <= p:
            active.append(spans[i])
            i += 1
        while active and active[-1].end < p:
            active.pop()
        names.append(active[-1].name if active else None)
    return names


def parse(events: list[dict]) -> Trace:
    """A :class:`Trace` from the Chrome trace's complete events."""
    launches: dict = {}
    device_raw, spans, host = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, args = e.get("cat", ""), e.get("args") or {}
        start = float(e["ts"])
        end = start + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device_raw.append((e.get("name", "?"),
                               int(args.get("device", e.get("pid", 0))),
                               start, end, args.get("correlation")))
        elif cat == "user_annotation":
            spans.append(Span(e.get("name", "?"), start, end))
        elif cat in HOST_CATS:
            host.append(Span(e.get("name", "?"), start, end))
        if cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = start
    ops = [DeviceOp(name, dev, start, end, launches.get(corr, start))
           for name, dev, start, end, corr in device_raw]
    frame = [s for s in spans if s.name == WINDOW]
    if frame:
        window = (frame[0].start, frame[0].end)
    else:
        every = [(s.start, s.end) for s in spans + host] \
            + [(o.start, o.end) for o in ops]
        window = (min(a for a, _ in every), max(b for _, b in every)) \
            if every else (0.0, 0.0)
    return Trace(ops, spans, host, window)


class Tracer:
    """``torch.profiler`` over the CPU and, where there is one, the card,
    around a ``port_bench.trace_window`` span. Making it prepares the
    profiler, which takes seconds the first time in a process (the
    tracing library's start-up), so a run makes it in its set-up and only
    starts and stops it inside the window."""

    def __init__(self, cuda: bool):
        import torch
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._profile = torch.profiler.profile(activities=acts)
        self._profile.prepare_trace()
        self._window = torch.profiler.record_function(WINDOW)

    def start(self) -> None:
        self._profile.start_trace()
        self._window.__enter__()

    def stop(self) -> None:
        self._window.__exit__(None, None, None)
        self._profile.stop_trace()

    def read(self) -> Trace:
        """The stopped trace, exported under the temporary directory and
        read back (the file is removed)."""
        fd, path = tempfile.mkstemp(suffix=".json", prefix="port_bench_")
        os.close(fd)
        try:
            self._profile.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        return parse(events)
