"""Host microseconds a ``flash_attention`` call takes, the benchmark's span
around each call (no wait for the device), averaged over the window's
calls. Once the launch queue is full, a call also waits there for room."""

from port_bench.readers import span_mean


def read(run):
    return span_mean(run, "flash.call", 1e6)
