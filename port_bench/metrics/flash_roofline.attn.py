"""The flash calls' share of the card's bf16 peak, in %: the FLOPs of each
traced call, from its shape, over the peak, over the device time of every
operation the traced calls launched (the kernel, its merge, any copy)."""

from port_bench import work
from port_bench.readers import roofline_percent


def read(run):
    c = run.config
    flops = work.attention_flops(c["t"], c["d"], c["causal"],
                                 c.get("heads") or 1)
    return roofline_percent(run, "flash.call", flops, "bf16_flops")
