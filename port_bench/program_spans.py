"""What the readers of the program's own spans share.

The port's span sites (``tpu_operator_torch/utils/trace.py``) are profiler
annotations of the same name while a trace runs, so in a traced run they
lie in ``run.trace.spans`` beside the benchmark's own annotations, on the
device trace's clock (microseconds). Their names never meet the
benchmark's own. Each reader returns None where the run has no trace or
the program made no such span (a program without them)."""

from __future__ import annotations

import bisect

#: the validator's legs, children of ``validator.validate``
VALIDATOR_LEGS = tuple(f"validator.{leg}" for leg in (
    "matmul", "hbm", "flash", "collectives", "ring_attention"))
#: host calls that launch work on the device (`cudaLaunch*`, `cuLaunch*`)
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


def spans(run, name: str) -> list:
    """The traced spans called ``name``, by start."""
    if run.trace is None:
        return []
    return sorted((s for s in run.trace.spans if s.name == name),
                  key=lambda s: s.start)


def mean_us(run, name: str):
    """Mean duration of the traced ``name`` spans, in microseconds."""
    found = spans(run, name)
    if not found:
        return None
    return sum(s.end - s.start for s in found) / len(found)


def inside_us(outer, inner: list) -> list[float]:
    """For each of the ``outer`` spans, the microseconds of the ``inner``
    spans (by start, not overlapping one another) that lie within it."""
    starts = [s.start for s in inner]
    out = []
    for o in outer:
        i = bisect.bisect_left(starts, o.start)
        total = 0.0
        while i < len(inner) and inner[i].start <= o.end:
            if inner[i].end <= o.end:
                total += inner[i].end - inner[i].start
            i += 1
        out.append(total)
    return out


def launch_calls_us(run, name: str):
    """Per ``name`` span, the mean microseconds spent inside host calls
    that launch device work (:data:`LAUNCH_PREFIXES`) within it."""
    outer = spans(run, name)
    if not outer:
        return None
    calls = sorted((h for h in run.trace.host
                    if h.name.startswith(LAUNCH_PREFIXES)),
                   key=lambda h: h.start)
    waits = inside_us(outer, calls)
    return sum(waits) / len(waits)
