"""The HBM leg's share of its roofline, in %: the bytes its K1 launches
read at the configuration's defaults (every sweep of the 256 MiB array),
over the card's HBM bytes/s, over the device time of every operation the
traced legs launched."""

from port_bench import work
from port_bench.readers import roofline_percent


def read(run):
    return roofline_percent(run, "leg.hbm", work.hbm_bytes(run.config["hbm"]),
                            "hbm_bytes")
