"""The port's HBM read probe against the reference's Pallas kernel (run in
interpret mode, as tests/test_ops.py runs it) on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.ops.hbm import CHUNK_ROWS, LANES, _pallas_sum
from tpu_operator_torch.ops import hbm
from tpu_operator_torch.parallel.numerics import reduction_tolerance

SHAPE = (2 * CHUNK_ROWS, LANES)
RANDOM = np.random.default_rng(0).random(SHAPE, dtype=np.float32)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_plain_read_matches_pallas_kernel(sweeps):
    want = float(_pallas_sum(jnp.asarray(RANDOM), sweeps, interpret=True))
    got = hbm.read_sum(torch.from_numpy(RANDOM), sweeps)
    assert got.dtype == torch.float64 and got.dim() == 0
    # the Pallas kernel adds in f32: each lane's chain is rows/8 per sweep
    # long, then one sum over the lanes; rows·sweeps terms bound both
    tol = reduction_tolerance(torch.float32, SHAPE[0] * sweeps)
    assert abs(got.item() - want) <= tol * want


@pytest.mark.parametrize("sweeps", [1, 3])
def test_checksum_of_ones_is_exact_in_both(sweeps):
    ones = np.ones(SHAPE, np.float32)
    expect = ones.size * sweeps
    assert float(_pallas_sum(jnp.asarray(ones), sweeps, interpret=True)) \
        == expect
    assert hbm.read_sum(torch.from_numpy(ones), sweeps).item() == expect


def test_read_sum_rejects_bad_sweeps_and_devices():
    with pytest.raises(ValueError, match="sweeps"):
        hbm.read_sum(torch.ones(4), 0)
    # only a CPU tensor takes the plain version: anything else launches the
    # kernel or raises
    with pytest.raises(ValueError, match="unsupported device"):
        hbm.read_sum(torch.ones(4, device="meta"))


def test_probe_error_gate(monkeypatch):
    x = torch.ones(SHAPE)
    expect = x.numel() * 2
    # within 1e-6 of the expected checksum passes
    monkeypatch.setattr(hbm, "read_sum",
                        lambda v, s: torch.tensor(expect * (1 + 5e-7),
                                                  dtype=torch.float64))
    assert hbm._measure(x, 2, iters=1) >= 0.0
    # a corrupt read fails the probe before anything is timed
    monkeypatch.setattr(hbm, "read_sum",
                        lambda v, s: torch.tensor(expect - 1e3,
                                                  dtype=torch.float64))
    with pytest.raises(hbm.ProbeError, match="checksum"):
        hbm._measure(x, 2, iters=1)


def test_alloc_matches_reference_sizing():
    x, nbytes = hbm._alloc(8, torch.device("cpu"))
    assert x.shape == (2048, LANES) and x.dtype == torch.float32
    assert nbytes == 8 * 1024 * 1024 and bool((x == 1).all())
    # below one chunk rounds up to one chunk, as in the reference
    x, nbytes = hbm._alloc(1, torch.device("cpu"))
    assert x.shape == (CHUNK_ROWS, LANES)


def test_hbm_read_gbps_on_cpu_uses_the_plain_version():
    before = hbm.read_sum.launches
    rep = hbm.hbm_read_gbps(size_mb=8, iters=2, device="cpu")
    assert rep.read_gbps > 0 and rep.backend == "torch" and rep.mbytes == 8
    assert set(rep.to_dict()) == {"mbytes", "seconds", "read_gbps",
                                  "backend"}
    assert hbm.read_sum.launches == before == 0


def test_hbm_device_gbps_median_of_differentials(monkeypatch):
    seq = iter([0.10, 0.05, 1.00, 0.05, 0.11, 0.06])
    monkeypatch.setattr(hbm, "_measure", lambda x, sweeps, iters: next(seq))
    rep = hbm.hbm_device_gbps(size_mb=8, sweeps_hi=8, sweeps_lo=2, iters=1,
                              repeats=3, device="cpu")
    nbytes = rep.mbytes * 1024 * 1024
    rates = sorted([(8 - 2) * nbytes / dt / 1e9
                    for dt in (0.05, 0.95, 0.05)])
    assert abs(rep.read_gbps - rates[1]) / rates[1] < 1e-6


@pytest.mark.parametrize("name,peak,matched", [
    ("NVIDIA H100 80GB HBM3", 3350.0, True),
    ("NVIDIA H100 PCIe", 2000.0, True),
    ("NVIDIA H100 NVL", 3900.0, True),
    ("NVIDIA A100-SXM4-80GB", hbm.DEFAULT_PEAK_HBM_GBPS, False),
])
def test_peak_hbm_table(monkeypatch, name, peak, matched):
    from tpu_operator_torch.ops.matmul import peak_lookup
    monkeypatch.delenv("PEAK_HBM_GBPS", raising=False)
    assert peak_lookup(name, hbm.PEAK_HBM_GBPS,
                       hbm.DEFAULT_PEAK_HBM_GBPS) == (peak, name, matched)
    assert hbm.chip_peak_hbm_gbps(name) == peak
    monkeypatch.setenv("PEAK_HBM_GBPS", "1234")
    assert hbm.chip_peak_hbm_gbps(name) == 1234.0
    assert hbm.chip_peak_hbm_gbps(name, override=2500) == 2500.0
