"""One run of one cell: set-up, the measured window, the check, the line.

The general loop reads the traffic mix's parameters, and they alone set
its pacing:

- ``loop``: ``"closed"`` waits for the device after each unit, so that a
  unit starts only once the one before it has ended there (a node
  re-validated, one validation after another); ``"dispatch"`` queues the
  units on the device without a wait between them, and waits only where
  the window ends. Any other value is refused.
- ``interval_s`` (optional, 0 where absent): the least time from the start
  of one unit to the start of the next; the loop sleeps until then. With
  ``"closed"`` it paces a periodic check (a health sweep every 30 s), with
  ``"dispatch"`` it offers units at a fixed rate (open-loop arrivals); a
  unit that is due late starts at once.
- ``trace_after_s``, ``trace_min_s``: in a traced run, the profiler starts
  at the first unit boundary after ``trace_after_s`` seconds of the window
  and stops at the first one after ``trace_min_s`` seconds of tracing.
- ``pool``, ``sample`` and any other key: read by the entries (input sets
  made from the seed, how many of the window's answers the reference
  checks).

An entry's ``step()`` runs one unit and leaves the waiting to the loop.
The window ends at the first unit boundary after ``--seconds``, and its
length is taken after the device has finished, so rates and times are
over all the work and all the time of the window.
"""

from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass

from port_bench import guard, spec
from port_bench.trace import Tracer

CACHE_DIR = spec.ROOT / ".port_bench_cache"


class Spans:
    """The benchmark's spans: seconds by name, and a profiler annotation of
    the same name while a trace runs."""

    def __init__(self):
        self.seconds: dict[str, list[float]] = {}
        self.annotate = False

    def add(self, name: str, seconds: float) -> None:
        self.seconds.setdefault(name, []).append(seconds)

    @contextlib.contextmanager
    def span(self, name: str):
        mark = None
        if self.annotate:
            import torch
            mark = torch.profiler.record_function(name)
            mark.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)
            if mark is not None:
                mark.__exit__(None, None, None)


class Reservoir:
    """A uniform sample of ``k`` of the items offered, drawn from the
    seed (reservoir sampling)."""

    def __init__(self, k: int, seed: int):
        import random
        self.k = k
        self.items: list = []
        self.seen = 0
        self._rng = random.Random(seed)

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self._rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


@dataclass
class Run:
    """What the metric readers read."""
    cell: str
    config: dict
    traffic: dict
    kind: str
    devices: list[int]
    setup_s: float
    window_s: float
    steps: int
    failed: int
    spans: dict[str, list[float]]
    trace: object = None

    def mean(self, span: str) -> float | None:
        values = self.spans.get(span)
        return sum(values) / len(values) if values else None


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so that
    only a checkout's first run builds. The program's own kernel library
    is built under ``tpu_operator_torch/build/``, also in the checkout."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE_DIR / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE_DIR / "torch_extensions")


def cards_missing(chips: int) -> str | None:
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch.cuda.device_count() "
                f"is {torch.cuda.device_count()}")
    return None


LOOPS = ("closed", "dispatch")


def pacing(traffic: dict) -> tuple[bool, float]:
    """(a wait after each unit, the least seconds between unit starts)
    from the mix's ``loop`` and ``interval_s``."""
    loop = traffic.get("loop")
    if loop not in LOOPS:
        raise spec.SpecError(f"traffic loop {loop!r} is none of {LOOPS}")
    interval = traffic.get("interval_s", 0)
    if not isinstance(interval, (int, float)) or interval < 0:
        raise spec.SpecError(f"traffic interval_s {interval!r} is not a "
                             f"number of seconds")
    return loop == "closed", float(interval)


def window(session, traffic: dict, seconds: float, tracer=None):
    """Run units of work for ``seconds``, paced as the mix says, and with a
    (prepared) ``tracer`` trace a stretch of them; (steps, failed,
    window_s). A traced window lasts at least until its stretch has
    ended."""
    closed, interval = pacing(traffic)
    steps = failed = 0
    state, t_trace = ("wait" if tracer else "done"), 0.0
    t0 = time.perf_counter()
    while True:
        now = time.perf_counter()
        if now - t0 >= seconds and state == "done":
            break
        if state == "wait" and now - t0 >= traffic["trace_after_s"]:
            session.sync()
            tracer.start()
            session.spans.annotate = True
            state, t_trace = "on", time.perf_counter()
        elif state == "on" and now - t_trace >= traffic["trace_min_s"]:
            session.sync()
            session.spans.annotate = False
            tracer.stop()
            state = "done"
        due = t0 + steps * interval - time.perf_counter()
        if due > 0:
            time.sleep(due)
        if not session.step():
            failed += 1
        if closed:
            session.sync()
        steps += 1
    session.sync()
    return steps, failed, time.perf_counter() - t0


def judge(numbers: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``correct`` and the compared numbers beside their limits: each
    number at or under its limit, and no failed unit."""
    checks = {}
    ok = failed == 0
    for name, value in numbers.items():
        limit = limits[name]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and not math.isnan(value) and value <= limit
    checks["failed"] = {"value": failed, "limit": 0}
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             t_start: float | None = None, device: str = "cuda",
             config_override: dict | None = None, fault=None,
             control: bool = False, root=spec.ROOT) -> dict:
    """One run of ``workload``; the result line as a dict. ``device``,
    ``config_override`` and ``fault`` serve the CPU tests: a device other
    than the card, sizes the CPU can hold, and a function that breaks the
    timed path once the session is built. ``control`` judges the
    reference in a lower precision in place of the program's answers
    (:mod:`port_bench.calibrate`), which must come out not correct.
    ``root`` is the checkout whose ``BENCHMARK.json`` and ``port_bench/``
    name the pieces."""
    t_start = time.perf_counter() if t_start is None else t_start
    guard.check("start-up")
    here = spec.Pieces(root)
    bench = here.benchmark()
    cell = spec.cell(bench, workload)
    config = dict(here.config(bench, cell["config"]))
    config.update(config_override or {})
    traffic = here.traffic(cell["traffic"])
    pacing(traffic)
    entry = here.module("entries", config["entry"])
    set_cache_dirs()
    import torch
    phases = {"import": time.perf_counter() - t_start}
    on_card = device == "cuda"
    devices = ([torch.device("cuda", i) for i in range(cell["chips"])]
               if on_card else [torch.device(device)])
    spans = Spans()
    session = entry.Session(config, traffic, seed, devices, spans)
    phases["session"] = time.perf_counter() - t_start
    try:
        if fault is not None:
            fault(session)
        session.warm()
        session.sync()
        # set-up's garbage collected, and what is left kept out of later
        # collections, so that no full collection lands in the window
        gc.collect()
        gc.freeze()
        phases["warm"] = time.perf_counter() - t_start
        tracer = Tracer(session.cuda) if trace else None
        spans.seconds.clear()
        setup_s = time.perf_counter() - t_start
        steps, failed, window_s = window(session, traffic, seconds, tracer)
        guard.check("after the window")
        peak = max((torch.cuda.max_memory_allocated(d) for d in devices),
                   default=0) if on_card else 0
        kind = torch.cuda.get_device_name(devices[0]) if on_card else device
        session.free()
        numbers = session.compare(control=control)
    finally:
        session.close()
        gc.unfreeze()
    correct, checks = judge(numbers, config["limits"], failed)
    run = Run(workload, config, traffic, kind,
              [d.index or 0 for d in devices], setup_s, window_s, steps,
              failed, spans.seconds, tracer.read() if tracer else None)
    metrics = {}
    for m in spec.metrics(bench, workload, trace):
        value = here.module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else device, "kind": kind,
           "count": len(devices), "memory_peak_bytes": peak}
    line = {"correct": correct, "attempted": steps, "failed": failed,
            "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_mean_s(run.devices)
        dev["window_s"] = run.trace.window_s
        line["breakdown"] = {"device_ops": run.trace.device_ops(),
                             "idle_gaps": run.trace.idle_gaps(run.devices)}
    line["window"] = {"seconds": window_s, "units": steps,
                      "setup_s": setup_s, "setup_phases_s": phases}
    line["checks"] = checks
    guard.check("before the result")
    return line


def main(argv: list[str], t_start: float) -> int:
    import argparse
    parser = argparse.ArgumentParser(prog="port_bench/run.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    try:
        guard.check("start-up")
        set_cache_dirs()
        chips = spec.cell(spec.Pieces().benchmark(),
                          args.workload)["chips"]
        missing = cards_missing(chips)
        if missing:
            print(f"port_bench: no run: {missing}", file=sys.stderr)
            return 2
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=t_start)
    except Exception:  # the run's boundary: report, print no result
        traceback.print_exc()
        return 1
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
