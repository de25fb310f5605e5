"""The port's flash attention (its plain version, on the CPU) and its
attention oracle against the reference's Pallas kernel in interpret mode
and the reference's oracle, on the same numpy inputs."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k2_faults, limit_ratio
from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator.parallel.ring_attention import \
    reference_attention as jax_reference
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance
from tpu_operator_torch.parallel.ring_attention import reference_attention

T, D, H = 256, 128, 4
_rng = np.random.default_rng(19)
QKV = [_rng.standard_normal((T, D), dtype=np.float32) for _ in range(3)]
QKV_HEADS = [_rng.standard_normal((H, T, D), dtype=np.float32)
             for _ in range(3)]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _both(arrays, dtype):
    """The same values in both frameworks: bf16 rounding of an f32 numpy
    array is round-to-nearest-even on both sides."""
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_pallas_kernel(dtype, causal):
    (jq, jk, jv), (q, k, v) = _both(QKV, dtype)
    # 128-row blocks give the reference kernel all three causal tile
    # classes: skipped, unmasked and diagonal
    want = jax_flash(jq, jk, jv, causal=causal, block_q=128, block_k=128,
                     interpret=True)
    got = port.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, attention_tolerance(q.dtype, D))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_flash_matches_reference_oracle(dtype, causal):
    (jq, jk, jv), (q, k, v) = _both(QKV, dtype)
    want = jax_reference(jq, jk, jv, causal=causal)
    got = port.flash_attention(q, k, v, causal=causal)
    _close(got, want, attention_tolerance(q.dtype, D))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_oracle_matches_reference_oracle(dtype, causal):
    (jq, jk, jv), (q, k, v) = _both(QKV, dtype)
    want = jax_reference(jq, jk, jv, causal=causal)
    got = reference_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype
    _close(got, want, attention_tolerance(q.dtype, D))


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_error_limit_holds_for_the_reference_kernel(causal):
    """The reference's Pallas kernel in bf16, at the CUDA kernel's 64-row
    tiles, rounds P and its output as the CUDA kernel does: it lies within
    the per-element limit of the port's f32 plain output."""
    (jq, jk, jv), (q, k, v) = _both(QKV, "bfloat16")
    got = jax_flash(jq, jk, jv, causal=causal, block_q=port.BLOCK,
                    block_k=port.BLOCK, interpret=True)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    got = torch.from_numpy(np.asarray(got, np.float32))
    assert limit_ratio(got, ref, limit) <= 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_error_limit_rejects_planted_faults(causal):
    """The plain version lies within the per-element limit; a dropped kv
    tile and a 1/64 scale error do not."""
    _, (q, k, v) = _both(QKV, "bfloat16")
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(port.attention_plain(q, k, v, causal=causal), ref,
                       limit) <= 1.0
    for name, bad in k2_faults(q, k, v, ref, causal).items():
        assert limit_ratio(bad, ref, limit) > 1.0, name


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_error_limit_holds_for_the_reference_kernel_in_f16(causal):
    """As in bf16, at f16's unit roundoff: the reference's kernel rounds P
    to f16 before P·V and its output once."""
    (jq, jk, jv), (q, k, v) = _both(QKV, "float16")
    got = jax_flash(jq, jk, jv, causal=causal, block_q=port.BLOCK,
                    block_k=port.BLOCK, interpret=True)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    got = torch.from_numpy(np.asarray(got, np.float32))
    assert limit_ratio(got, ref, limit) <= 1.0


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_error_limit_rejects_planted_faults_in_f16(causal):
    _, (q, k, v) = _both(QKV, "float16")
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(port.attention_plain(q, k, v, causal=causal), ref,
                       limit) <= 1.0
    for name, bad in k2_faults(q, k, v, ref, causal).items():
        assert limit_ratio(bad, ref, limit) > 1.0, name


def test_kernel_error_limit_is_for_16_bit_inputs():
    """f16's limit is eight times tighter than bf16's; f32 has none (its
    kernels are held to the attention tolerance)."""
    assert port.unit_roundoff(torch.bfloat16) == 2.0 ** -8
    assert port.unit_roundoff(torch.float16) == 2.0 ** -11
    _, (q, k, v) = _both(QKV, "float32")
    with pytest.raises(ValueError, match="16-bit"):
        port.kernel_error_limit(q, k, v)


def test_heads_are_a_grid_axis():
    """[H, T, D] input equals the reference's jax.vmap over heads."""
    (jq, jk, jv), (q, k, v) = _both(QKV_HEADS, "float32")
    want = jax.vmap(lambda a, b, c: jax_flash(
        a, b, c, causal=True, block_q=128, block_k=128,
        interpret=True))(jq, jk, jv)
    got = port.flash_attention(q, k, v, causal=True)
    assert got.shape == (H, T, D)
    _close(got, want, attention_tolerance(q.dtype, D))
    # and each head alone gives the same rows
    for h in range(H):
        torch.testing.assert_close(
            port.flash_attention(q[h], k[h], v[h], causal=True), got[h])


def test_scale_defaults_to_inverse_sqrt_d_and_passes_through():
    (jq, jk, jv), (q, k, v) = _both(QKV, "float32")
    torch.testing.assert_close(
        port.flash_attention(q, k, v),
        port.flash_attention(q, k, v, sm_scale=1.0 / math.sqrt(D)))
    want = jax_flash(jq, jk, jv, sm_scale=0.5, block_q=128, block_k=128,
                     interpret=True)
    got = port.flash_attention(q, k, v, sm_scale=0.5)
    _close(got, want, attention_tolerance(q.dtype, D))


def test_shape_guard_matches_reference():
    ones = np.ones((500, 128), np.float32)
    with pytest.raises(ValueError, match="divisible"):
        jax_flash(*[jnp.asarray(ones)] * 3, block_q=256, block_k=256,
                  interpret=True)
    with pytest.raises(ValueError, match="divisible"):
        port.flash_attention(*[torch.from_numpy(ones)] * 3, block_q=256,
                             block_k=256)
    # the port's default 64-row blocks do not divide 500 either
    with pytest.raises(ValueError, match="divisible"):
        port.flash_attention(*[torch.from_numpy(ones)] * 3)


def test_wrapper_rejects_mismatched_shapes_and_devices():
    q = torch.zeros((128, 64))
    with pytest.raises(ValueError, match="shape"):
        port.flash_attention(q, q[:64], q)
    with pytest.raises(ValueError, match="shape"):
        port.flash_attention(torch.zeros(128), torch.zeros(128),
                             torch.zeros(128))
    meta = torch.zeros((128, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_attention(meta, meta, meta)


def test_oracle_restores_tf32_settings():
    precision = torch.get_float32_matmul_precision()
    cudnn = torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
        q = torch.from_numpy(QKV[0][:64, :16])
        reference_attention(q, q, q, causal=True)
        assert torch.get_float32_matmul_precision() == "high"
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.set_float32_matmul_precision(precision)
        torch.backends.cudnn.allow_tf32 = cudnn
