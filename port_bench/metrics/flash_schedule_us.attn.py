"""Host microseconds of a ``flash_attention`` call's ``flash_op.schedule``
step (the work list, found or built, and the output and workspace
allocations), averaged over the traced calls: the program's span, on the
device trace's clock."""

from port_bench.program_spans import mean_us


def read(run):
    return mean_us(run, "flash_op.schedule")
