"""Timing helpers for device benchmarks.

The port keeps its own copy of ``tpu_operator/utils/timing.py``'s two
samplers. Every timed function it hands them must end in a completion
barrier: PyTorch returns as soon as the work is queued, so a device timing
function ends with ``.item()`` on a scalar result or with
``torch.cuda.synchronize()``; without one the host clock measures the enqueue.
"""

from __future__ import annotations

import time
from typing import Callable


def measure_best(fn: Callable, *args, iters: int = 5, warmup: int = 2) -> float:
    """Best-of-``iters`` wall time in seconds for ``fn(*args)``, after
    ``warmup`` untimed calls. ``fn`` must block until the device is done."""
    for _ in range(warmup):
        fn(*args)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        best = min(best, time.perf_counter() - t0)
    return best


def median_differential(measure_hi: Callable[[], float],
                        measure_lo: Callable[[], float],
                        delta_work: float,
                        repeats: int = 3) -> tuple[float, float] | None:
    """Median of ``repeats`` two-point differential rates.

    Each repeat times a long and a short run of the same workload;
    ``rate = delta_work / (t_hi - t_lo)`` cancels the per-launch constant,
    and the median of several discards outlier samples.

    Returns ``(rate, dt)`` of the median-rate sample in ``delta_work``'s
    units per second, or ``None`` when timer noise swamped every
    differential (no positive Δt); callers then fall back to an absolute
    measurement.
    """
    samples = []
    for _ in range(max(1, repeats)):
        t_hi = measure_hi()
        t_lo = measure_lo()
        dt = t_hi - t_lo
        if dt > 0:
            samples.append((delta_work / dt, dt))
    if not samples:
        return None
    samples.sort()
    return samples[len(samples) // 2]
