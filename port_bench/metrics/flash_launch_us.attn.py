"""Host microseconds of a ``flash_attention`` call's ``flash_op.launch``
step (the kernel library, the C entry: tensor maps, attributes and the
launches, and the error check), averaged over the traced calls: the
program's span, on the device trace's clock."""

from port_bench.program_spans import mean_us


def read(run):
    return mean_us(run, "flash_op.launch")
