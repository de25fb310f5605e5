"""Seconds of the validator's matmul leg, as ``validate()`` records them in
``leg_seconds``, averaged over the window's validations."""

from port_bench.readers import span_mean


def read(run):
    return span_mean(run, "program.leg.matmul")
