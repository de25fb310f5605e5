"""The port's ring attention against the reference's, on the same numpy
inputs, causal and not, and against the pinned-precision oracle."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from tpu_operator.parallel.ring_attention import \
    ring_attention as jax_ring_attention
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh
from tpu_operator_torch.parallel.numerics import attention_tolerance
from tpu_operator_torch.parallel.ring_attention import (reference_attention,
                                                        ring_attention)


def _qkv(t, d, seed):
    return np.random.default_rng(seed).standard_normal((3, t, d),
                                                       dtype=np.float32)


def _ring_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("ring",))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_ring_attention_matches_the_reference(n, causal):
    t, d = 8 * n, 32
    q, k, v = _qkv(t, d, seed=n + 10 * causal)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("ring",))
    want = np.asarray(jax_ring_attention(q, k, v, jmesh, "ring",
                                         causal=causal))
    got = ring_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                         _ring_mesh(n), "ring", causal=causal)
    assert got.shape == (t, d) and bool(torch.isfinite(got).all())
    # the same online softmax in f32 on both sides: two association orders
    # of the same f32 computation
    tol = attention_tolerance(torch.float32, d)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_the_oracle(causal):
    n, t, d = 4, 64, 16
    q, k, v = (torch.from_numpy(a) for a in _qkv(t, d, seed=7))
    got = ring_attention(q, k, v, _ring_mesh(n), "ring", causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    tol = attention_tolerance(torch.float32, d)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_ring_attention_over_the_model_axis_of_a_two_axis_mesh():
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    q, k, v = (torch.from_numpy(a) for a in _qkv(16, 16, seed=9))
    got = ring_attention(q, k, v, mesh, "model", causal=True)
    assert torch.equal(got, ring_attention(q, k, v, _ring_mesh(2), "ring",
                                           causal=True))


def test_ring_attention_rejects_an_uneven_split():
    q = torch.zeros((10, 16))
    with pytest.raises(ValueError, match="divisible"):
        ring_attention(q, q, q, _ring_mesh(4), "ring")
