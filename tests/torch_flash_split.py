"""The inputs and the reference's outputs that the split-schedule tests of
K2 (flash attention) share, and the bodies of the tests spread over
``tests/test_torch_flash_split*.py`` (each file about a minute of one
worker): the schedule's plain twin ``flash_split_plain`` on the same numpy
inputs as the reference's Pallas kernel in interpret mode, held to the
per-element limit of the f32 oracle and the attention tolerance."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import limit_ratio
from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance

T, D = 576, 128   # 9 tiles of 64: with split 8, a unit of 8 and one of 1
_rng = np.random.default_rng(23)
INPUTS = {heads: [_rng.standard_normal(shape, dtype=np.float32)
                  for _ in range(3)]
          for heads, shape in ((1, (T, D)), (4, (4, T, D)))}


def bf16_inputs(heads):
    return [torch.from_numpy(a).to(torch.bfloat16) for a in INPUTS[heads]]


@functools.lru_cache(maxsize=None)
def reference(heads, causal):
    """The reference's Pallas kernel in interpret mode, in bf16."""
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in INPUTS[heads])

    def one(a, b, c):
        return jax_flash(a, b, c, causal=causal, block_q=port.BLOCK,
                         block_k=port.BLOCK, interpret=True)
    out = jax.vmap(one)(jq, jk, jv) if heads > 1 else one(jq, jk, jv)
    return np.asarray(out, np.float32)


GRID_DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16),
               "float16": (jnp.float16, torch.float16)}


@functools.lru_cache(maxsize=None)
def grid_case(dtype, d, t, causal):
    """Three heads of numpy inputs, and the reference's Pallas kernel on
    them in interpret mode, in ``dtype``, with blocks that divide T."""
    rng = np.random.default_rng(d * 7 + t)
    arrays = [rng.standard_normal((3, t, d), dtype=np.float32)
              for _ in range(3)]
    jdt, _ = GRID_DTYPES[dtype]
    block = min(t, 256)

    def one(a, b, c):
        return jax_flash(a, b, c, causal=causal, block_q=block,
                         block_k=block, interpret=True)
    want = jax.vmap(one)(*(jnp.asarray(a, jdt) for a in arrays))
    return arrays, np.asarray(want, np.float32)


def check_grid(dtype, d, t, causal, heads):
    """The schedule's plain twin at T that 64 does not divide (96, 200), D
    off the buckets (96) and both 16-bit types, in units of 3 kv tiles:
    within the per-element limit of the f32 oracle and the attention
    tolerance of the reference's kernel."""
    arrays, want = grid_case(dtype, d, t, causal)
    q, k, v = (torch.from_numpy(a[:heads]).to(GRID_DTYPES[dtype][1])
               for a in arrays)
    want = want[:heads]
    if heads == 1:
        q, k, v, want = q[0], k[0], v[0], want[0]
    got = port.flash_split_plain(q, k, v, causal, split=3)
    assert got.dtype == q.dtype and got.shape == q.shape
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def check_steps_of_32(t, causal):
    """K2w's schedule at DP = 256 with kv steps of 32 keys (two a 64-key
    tile): the same limit and tolerance."""
    arrays, want = grid_case("bfloat16", 256, t, causal)
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    got = port.flash_split_plain(q, k, v, causal, split=3, block_k=32)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, 256)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    with pytest.raises(ValueError, match="block_k"):
        port.split_partials(q, k, v, causal, 3, block_k=48)
