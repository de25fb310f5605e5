"""Parity of the port's tolerance model and timing samplers with the
reference's, plus the CUDA rule the reference lacks on purpose."""

import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_operator.parallel import numerics as ref
from tpu_operator.utils import timing as ref_timing
from tpu_operator_torch.parallel import numerics as port
from tpu_operator_torch.utils import timing as port_timing

DTYPES = [(jnp.bfloat16, torch.bfloat16), (np.float32, torch.float32)]
DTYPE_IDS = ["bf16", "f32"]
F32_EPS = float(np.finfo(np.float32).eps)


@pytest.fixture
def restore_precision():
    precision = torch.get_float32_matmul_precision()
    yield
    torch.set_float32_matmul_precision(precision)


@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_effective_eps_matches_reference_on_cpu(jdt, tdt):
    assert port.effective_matmul_eps(tdt, "cpu") == \
        ref.effective_matmul_eps(jdt, "cpu")


@pytest.mark.parametrize("head_dim", [16, 128])
@pytest.mark.parametrize("jdt,tdt", DTYPES, ids=DTYPE_IDS)
def test_attention_tolerance_matches_reference_on_cpu(jdt, tdt, head_dim):
    assert port.attention_tolerance(tdt, head_dim, "cpu") == \
        ref.attention_tolerance(jdt, head_dim, "cpu")


@pytest.mark.parametrize("n_terms", [1, 8, 1024])
def test_reduction_tolerance_matches_reference(n_terms):
    assert port.reduction_tolerance(torch.float32, n_terms) == \
        ref.reduction_tolerance(np.float32, n_terms)
    # the reference's np.finfo has no bf16; ml_dtypes' finfo is its source
    assert port.reduction_tolerance(torch.bfloat16, n_terms) == \
        8.0 * float(ml_dtypes.finfo(ml_dtypes.bfloat16).eps) * n_terms


@pytest.mark.parametrize("precision,want", [
    ("highest", F32_EPS), ("high", 2.0 ** -11), ("medium", 2.0 ** -11)])
def test_cuda_f32_rule_follows_matmul_precision(restore_precision,
                                                precision, want):
    torch.set_float32_matmul_precision(precision)
    assert port.effective_matmul_eps(torch.float32, "cuda") == want
    # the CPU honours the operand dtype whatever the setting
    assert port.effective_matmul_eps(torch.float32, "cpu") == F32_EPS
    # bf16 operands multiply at bf16 precision everywhere
    assert port.effective_matmul_eps(torch.bfloat16, "cuda") == 2.0 ** -8


@pytest.mark.parametrize("allow_tf32,want", [(True, 2.0 ** -11),
                                             (False, F32_EPS)])
def test_cuda_f32_rule_follows_allow_tf32(restore_precision, allow_tf32,
                                          want):
    torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    assert port.effective_matmul_eps(torch.float32, "cuda") == want
    # the reference has no CUDA rule: it honours the dtype on a GPU, which
    # is right only while TF32 is off
    assert (ref.effective_matmul_eps(np.float32, "cuda") == want) \
        == (not allow_tf32)


def test_cuda_attention_tolerance_on_the_main_path():
    # the flash check's tolerance on the card: bf16, D=128
    tol = port.attention_tolerance(torch.bfloat16, 128, "cuda")
    assert tol == 8 * 2.0 ** -8 + 32 * F32_EPS * math.sqrt(128)
    assert 3.1e-2 < tol < 3.2e-2


def test_residual_tolerance_grows_with_depth_and_precision():
    one = port.residual_tolerance(torch.bfloat16, 1, 2048)
    assert port.residual_tolerance(torch.bfloat16, 4, 2048) == 4 * one
    assert port.residual_tolerance(torch.float32, 1, 2048) < one / 100


def _replay(module, samples, delta, repeats):
    seq = iter(samples)
    return module.median_differential(lambda: next(seq), lambda: next(seq),
                                      delta, repeats)


@pytest.mark.parametrize("samples,repeats", [
    ([0.10, 0.05, 1.00, 0.05, 0.11, 0.06], 3),   # one outlier repeat
    ([0.05, 0.10, 0.05, 0.10], 2),               # noise swamps every dt
    ([0.30, 0.10], 1),
])
def test_median_differential_matches_reference(samples, repeats):
    assert _replay(port_timing, samples, 6.0, repeats) == \
        _replay(ref_timing, samples, 6.0, repeats)


def test_measure_best_matches_reference_call_pattern():
    calls = {"port": [], "ref": []}
    for name, module in (("port", port_timing), ("ref", ref_timing)):
        t = module.measure_best(lambda a: calls[name].append(a), 7,
                                iters=3, warmup=2)
        assert t >= 0.0
    assert calls["port"] == calls["ref"] == [7] * 5
