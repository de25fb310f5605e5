"""The work of one unit of each configuration, counted from its shapes.

These are the counts the roofline shares divide by the peaks: each input
byte read once and each operation the algorithm needs, whatever kernel
does it, so a change that leaves work out reads above the roofline.
"""

from __future__ import annotations

from port_bench.reference.hbm_sum import rows as hbm_rows


def hbm_launches(hbm: dict) -> list[int]:
    """The sweeps of each K1 launch in one HBM leg: ``repeats`` times a
    deep and a shallow measurement, each a checked run and ``iters`` timed
    ones."""
    one = [hbm["sweeps_hi"]] * (1 + hbm["iters"]) \
        + [hbm["sweeps_lo"]] * (1 + hbm["iters"])
    return one * hbm["repeats"]


def hbm_array_bytes(hbm: dict) -> int:
    return hbm_rows(hbm["size_mb"], hbm["lanes"], hbm["chunk_rows"]) \
        * hbm["lanes"] * 4


def hbm_bytes(hbm: dict) -> int:
    """Bytes the HBM leg reads: every sweep of every launch over the
    array."""
    return sum(hbm_launches(hbm)) * hbm_array_bytes(hbm)


def matmul_chains(mm: dict) -> list[int]:
    """The depth of each chain in one matmul leg: ``repeats`` times a deep
    and a shallow measurement, each ``warmup`` + ``iters`` chains."""
    runs = mm["warmup"] + mm["iters"]
    return ([mm["depth_hi"]] * runs + [mm["depth_lo"]] * runs) \
        * mm["repeats"]


def matmul_flops(mm: dict) -> int:
    """FLOPs of the matmul leg: 2·dim³ a product."""
    return sum(matmul_chains(mm)) * 2 * mm["dim"] ** 3


def attention_flops(t: int, d: int, causal: bool, heads: int = 1) -> int:
    """q·Kᵀ and P·V, 2·D each a (query, key) pair: T(T+1)/2 pairs causal,
    T² full."""
    pairs = t * (t + 1) // 2 if causal else t * t
    return 4 * d * pairs * heads

