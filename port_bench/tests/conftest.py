"""The benchmark's own tests: CPU tests at small sizes, and card tests that
skip inside the ``cuda`` fixture where no card is reachable.

    python -m pytest port_bench/tests -q

No JAX here: the benchmark must run where only PyTorch is installed.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the validator's own CPU sizes (``WorkloadComponent.validate`` on the CPU),
# and the other cells cut to what a CPU test holds
CPU_SIZES = {
    "validate.default": {
        "matmul": {"dim": 512, "dtype": "bfloat16", "depth_hi": 8,
                   "depth_lo": 2, "warmup": 2, "iters": 3, "repeats": 3,
                   "scale": 0.01, "seed": 0},
        "hbm": {"size_mb": 8, "lanes": 1024, "chunk_rows": 512,
                "dtype": "float32", "sweeps_hi": 8, "sweeps_lo": 2,
                "iters": 1, "repeats": 1},
        "flash": {"t": 256, "d": 128, "dtype": "bfloat16", "causal": True,
                  "seed": 7}},
    "attn.causal-16k": {"t": 256},
}


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the program's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


@pytest.fixture
def cpu_run():
    """``run_cell`` on the CPU at :data:`CPU_SIZES`, a short window."""
    from port_bench.harness import run_cell

    def run(cell, seed=2**31 + 11, seconds=0.5, trace=False, **kw):
        return run_cell(cell, seed, seconds, trace, device="cpu",
                        config_override=CPU_SIZES[cell], **kw)
    return run
