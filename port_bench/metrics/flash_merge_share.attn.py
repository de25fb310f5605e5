"""The flash merge's share of the flash calls' device time, in %: the
device time of the ``flash_combine_kernel`` operations launched inside the
traced ``flash.call`` spans, over the device time of every operation
launched inside them. None where no operation ran under those spans."""

MERGE = "flash_combine_kernel"


def read(run):
    t = run.trace
    if t is None:
        return None
    ops = t.under("flash.call")
    total = sum(op.seconds for op in ops)
    if total <= 0:
        return None
    merge = sum(op.seconds for op in ops if MERGE in op.name)
    return 100.0 * merge / total
