"""The share of the traced window in which no operation ran on the
device, in %, averaged over the cards the run uses."""

from port_bench.readers import idle_percent


def read(run):
    return idle_percent(run)
