"""Single-card tensor-core throughput probe.

The port of ``tpu_operator/ops/matmul.py``: a bf16 matmul chain whose
achieved TFLOP/s is a health number, gated against the card's data-sheet
peak. The reference left its matmuls to XLA, outside any Pallas kernel, so
the port leaves them to ``torch.matmul``; no hand-written kernel is owed.

Each step multiplies in bf16 with f32 accumulation, rescales by 1e-2 to keep
magnitudes bounded, and the chain ends in an f32 sum fetched with ``.item()``,
the completion barrier the timer waits on.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass

import torch

from tpu_operator_torch.utils.device import resolve_device
from tpu_operator_torch.utils.timing import measure_best, median_differential

# Dense bf16 tensor-core TFLOP/s by lower-cased torch.cuda.get_device_name()
# substring (NVIDIA H100 data sheet, without sparsity). Most specific first:
# the SXM part reports as "NVIDIA H100 80GB HBM3", so the bare "h100" row
# must come after the PCIe and NVL rows.
PEAK_BF16 = {
    "h100 pcie": 756.0,
    "h100 nvl": 835.0,
    "h100": 989.0,
}
DEFAULT_PEAK_BF16 = 989.0


def peak_lookup(kind: str, table: dict, default: float):
    """Data-sheet lookup by device-name substring, shared by the TFLOP/s and
    HBM tables. Returns ``(peak, kind, matched)``; ``matched=False`` means
    ``default`` is in use, which callers must surface rather than report a
    ratio against a guessed denominator."""
    for name, peak in table.items():
        if name in kind.lower():
            return peak, kind, True
    return default, kind, False


def chip_peak_tflops(kind: str, override: float | None = None) -> float:
    """Peak bf16 TFLOP/s denominator: explicit ``override`` →
    ``PEAK_TFLOPS`` env → data-sheet table by device name."""
    if override:
        return float(override)
    env = os.environ.get("PEAK_TFLOPS")
    if env:
        return float(env)
    return peak_lookup(kind, PEAK_BF16, DEFAULT_PEAK_BF16)[0]


@dataclass(frozen=True)
class MatmulReport:
    m: int
    k: int
    n: int
    depth: int
    dtype: str
    seconds: float
    tflops: float

    def to_dict(self) -> dict:
        return asdict(self)


def matmul_tflops(m: int = 4096, k: int = 4096, n: int = 4096,
                  dtype: torch.dtype = torch.bfloat16, depth: int = 32,
                  iters: int = 5, device="cuda") -> MatmulReport:
    """Achieved TFLOP/s of a depth-``depth`` matmul chain (best of
    ``iters``)."""
    if k != n:
        raise ValueError("chain requires k == n (square b)")
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    b = torch.randn((k, n), generator=gen, device=dev).to(dtype)

    def run():
        x = a
        for _ in range(depth):
            x = torch.matmul(x, b).mul_(1e-2)
        return x.float().sum().item()  # completion barrier

    t = measure_best(run, iters=iters)
    flops = 2 * m * k * n * depth
    return MatmulReport(m, k, n, depth, str(dtype).removeprefix("torch."), t,
                        flops / t / 1e12)


def matmul_device_tflops(m: int = 4096, k: int = 4096, n: int = 4096,
                         dtype: torch.dtype = torch.bfloat16,
                         depth_hi: int = 512, depth_lo: int = 128,
                         iters: int = 3, device="cuda",
                         repeats: int = 3) -> MatmulReport:
    """Two-point differential throughput: Δflops / Δtime between a deep and
    a shallow chain, cancelling the per-call constant (input set-up, launch
    of the first product, the scalar fetch). Median of ``repeats``
    differentials; falls back to the deep chain's absolute rate when timer
    noise swamps every differential."""
    dflops = 2 * m * k * n * (depth_hi - depth_lo)
    last = {}

    def t_hi():
        last["hi"] = matmul_tflops(m, k, n, dtype, depth_hi, iters, device)
        return last["hi"].seconds

    def t_lo():
        return matmul_tflops(m, k, n, dtype, depth_lo, iters, device).seconds

    med = median_differential(t_hi, t_lo, dflops, repeats)
    if med is None:
        return last["hi"]
    rate, dt = med
    return MatmulReport(m, k, n, depth_hi - depth_lo,
                        str(dtype).removeprefix("torch."), dt, rate / 1e12)
