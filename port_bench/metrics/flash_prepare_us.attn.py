"""Host microseconds of a ``flash_attention`` call's ``flash_op.prepare``
step (the shape and block checks, the contiguous copies, the route),
averaged over the traced calls: the program's span, on the device trace's
clock."""

from port_bench.program_spans import mean_us


def read(run):
    return mean_us(run, "flash_op.prepare")
