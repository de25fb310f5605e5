"""The matmul leg's share of the card's bf16 peak, in %: the FLOPs of its
chains at the configuration's defaults (2·dim³ a product), over the peak,
over the device time of every operation the traced legs launched."""

from port_bench import work
from port_bench.readers import roofline_percent


def read(run):
    return roofline_percent(run, "leg.matmul",
                            work.matmul_flops(run.config["matmul"]),
                            "bf16_flops")
