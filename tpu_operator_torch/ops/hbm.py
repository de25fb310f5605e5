"""HBM read-bandwidth probe on a hand-written CUDA kernel.

The port of ``tpu_operator/ops/hbm.py``. Silent device-memory degradation
(thermal, a failing stack) shows up as lost bandwidth long before a matmul
stops producing numbers, so the validator records achieved read GB/s next
to the matmul TFLOP/s.

A kernel of our own rather than timing ``torch.sum``: the kernel pins the
access pattern (persistent blocks streaming 16-byte loads, the sweep loop
inside one launch), so the number is comparable across nodes and over time.
``csrc/hbm_read.cu`` says what bounds it and how its design answers that.

The probe array must stay well above the card's 50 MB L2 cache, or part of
every sweep is served from L2 and the rate overstates HBM: the default is
256 MiB.

:func:`read_sum` launches the kernel for a CUDA tensor and runs the plain
PyTorch version, :func:`read_sum_plain`, only for a CPU tensor.
"""

from __future__ import annotations

import os
from dataclasses import asdict, dataclass

import torch

from tpu_operator_torch import _native
from tpu_operator_torch.ops.matmul import peak_lookup
from tpu_operator_torch.utils import trace
from tpu_operator_torch.utils.device import resolve_device
from tpu_operator_torch.utils.timing import measure_best, median_differential

LANES = 1024          # f32 row width of the probe array
CHUNK_ROWS = 512      # rows come in 2 MiB chunks, as in the reference
THREADS = 256         # threads per block of the kernel (kThreads)
BLOCKS_PER_SM = 4

# Peak device-memory GB/s by lower-cased torch.cuda.get_device_name()
# substring (NVIDIA H100 data sheet), most specific first.
PEAK_HBM_GBPS = {
    "h100 pcie": 2000.0,
    "h100 nvl": 3900.0,
    "h100": 3350.0,
}
DEFAULT_PEAK_HBM_GBPS = 3350.0


def chip_peak_hbm_gbps(kind: str, override: float | None = None) -> float:
    """Peak HBM GB/s denominator: ``override`` → ``PEAK_HBM_GBPS`` env →
    data-sheet table by device name."""
    if override:
        return float(override)
    env = os.environ.get("PEAK_HBM_GBPS")
    if env:
        return float(env)
    return peak_lookup(kind, PEAK_HBM_GBPS, DEFAULT_PEAK_HBM_GBPS)[0]


def read_sum_plain(x: torch.Tensor, sweeps: int = 1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the f64 sum of ``x`` times
    ``sweeps``, as a 0-d f64 tensor. It reads ``x`` once."""
    return x.sum(dtype=torch.float64) * sweeps


def read_grid(device: torch.device) -> int:
    """Blocks of the kernel's persistent grid on ``device``."""
    props = torch.cuda.get_device_properties(device)
    return props.multi_processor_count * BLOCKS_PER_SM


def read_sum(x: torch.Tensor, sweeps: int = 1) -> torch.Tensor:
    """Sum ``x`` (f32) ``sweeps`` times over in one launch; returns the 0-d
    f64 checksum. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise."""
    if sweeps < 1:
        raise ValueError(f"sweeps must be >= 1, got {sweeps}")
    if x.device.type == "cpu":
        return read_sum_plain(x, sweeps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("the HBM read kernel takes a contiguous float32 "
                         f"tensor, got {x.dtype} contiguous={x.is_contiguous()}")
    if x.numel() % 4 or x.data_ptr() % 16:
        raise ValueError("the HBM read kernel reads 16-byte vectors: the "
                         "tensor must hold a multiple of 4 elements and be "
                         "16-byte aligned")
    lib = _native.library()
    nblocks = read_grid(x.device)
    partials = torch.empty(nblocks, dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float64, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.hbm_read_sum(x.data_ptr(), x.numel() // 4, sweeps,
                               partials.data_ptr(), nblocks, out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    _native.check(err, "hbm_read_sum")
    read_sum.launches += 1
    return out


read_sum.launches = 0


class ProbeError(RuntimeError):
    """The probe's checksum did not survive the read: corrupt reads, the
    fault this probe exists to catch. The validator maps it to a validation
    failure, never a crash."""


@dataclass(frozen=True)
class HbmReport:
    mbytes: int
    seconds: float
    read_gbps: float
    backend: str   # "cuda" (the kernel) | "torch" (the plain version, CPU)

    def to_dict(self) -> dict:
        return asdict(self)


def _alloc(size_mb: int, device: torch.device):
    """The probe array, allocated and filled with ones in an ``hbm.alloc``
    span, and its bytes."""
    rows = max(CHUNK_ROWS, (size_mb * 1024 * 1024) // (LANES * 4))
    rows -= rows % CHUNK_ROWS
    with trace.span("hbm.alloc"):
        x = torch.ones((rows, LANES), dtype=torch.float32, device=device)
    return x, rows * LANES * 4


def _measure(x: torch.Tensor, sweeps: int, iters: int) -> float:
    """Best-of-``iters`` seconds for one ``sweeps``-deep launch over ``x``.
    The checksum is fetched with ``.item()``, the completion barrier, and
    the first (warm-up) run is gated on it: the probe proves the reads
    return the right data before it times them. The gated run is an
    ``hbm.gate`` span, each timed one an ``hbm.timed`` span."""
    def run():
        return read_sum(x, sweeps).item()

    expect = float(x.numel()) * sweeps
    with trace.span("hbm.gate"):
        got = run()
    if abs(got - expect) > 1e-6 * expect:
        raise ProbeError(f"hbm probe checksum {got} != {expect}: bad reads?")
    return measure_best(run, iters=iters, warmup=0, span="hbm")


def _backend(device: torch.device) -> str:
    return "cuda" if device.type == "cuda" else "torch"


def hbm_read_gbps(size_mb: int = 256, sweeps: int = 1, iters: int = 5,
                  device="cuda") -> HbmReport:
    """Achieved read bandwidth streaming a ``size_mb`` array ``sweeps``
    times in one launch."""
    dev = resolve_device(device)
    x, nbytes = _alloc(size_mb, dev)
    secs = _measure(x, sweeps, iters)
    return HbmReport(mbytes=nbytes // (1024 * 1024), seconds=secs,
                     read_gbps=sweeps * nbytes / secs / 1e9,
                     backend=_backend(dev))


def hbm_device_gbps(size_mb: int = 256, sweeps_hi: int = 2048,
                    sweeps_lo: int = 512, iters: int = 2, device="cuda",
                    repeats: int = 3) -> HbmReport:
    """Two-point differential bandwidth: Δbytes / Δtime between a
    many-sweep and a few-sweep launch over one shared array, cancelling the
    per-launch constant. The median of ``repeats`` differentials is
    reported. At the defaults the window between the two is 1536 sweeps of
    256 MiB, about 400 GB of reads, so it lasts a good fraction of a second
    and host-clock jitter is small against it."""
    dev = resolve_device(device)
    x, nbytes = _alloc(size_mb, dev)
    mbytes = nbytes // (1024 * 1024)
    dbytes = (sweeps_hi - sweeps_lo) * nbytes
    last = {}

    def t_hi():
        last["secs"] = _measure(x, sweeps_hi, iters)
        return last["secs"]

    def t_lo():
        return _measure(x, sweeps_lo, iters)

    med = median_differential(t_hi, t_lo, dbytes, repeats)
    if med is None:  # timer noise swamped every differential
        return HbmReport(mbytes=mbytes, seconds=last["secs"],
                         read_gbps=sweeps_hi * nbytes / last["secs"] / 1e9,
                         backend=_backend(dev))
    rate, dt = med
    return HbmReport(mbytes=mbytes, seconds=dt, read_gbps=rate / 1e9,
                     backend=_backend(dev))
