"""The port's Ulysses attention against the reference's, on the same numpy
inputs: the dense per-head path and the flash path, causal and not."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tpu_operator.parallel.ring_attention import \
    ulysses_attention as jax_ulysses_attention
from tpu_operator_torch.ops import flash_attention as flash_mod
from tpu_operator_torch.parallel import collectives
from tpu_operator_torch.parallel.mesh import Mesh, MeshPlan, make_mesh
from tpu_operator_torch.parallel.numerics import attention_tolerance
from tpu_operator_torch.parallel.ring_attention import (reference_attention,
                                                        ulysses_attention)


def _qkv(t, h, dh, seed):
    return np.random.default_rng(seed).standard_normal((3, t, h, dh),
                                                       dtype=np.float32)


def _line_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("model",))


def _port(q, k, v, mesh, n, causal, axis="model"):
    """The whole arrays sharded on the sequence over ``axis`` (replicated
    over any other axis), through the port, assembled from the first
    group."""
    def shards(a):
        parts = torch.from_numpy(a).chunk(n)
        return [parts[mesh.coords(r)[axis]] for r in range(mesh.size)]
    outs = ulysses_attention(shards(q), shards(k), shards(v), mesh, axis,
                             causal=causal)
    return torch.cat([outs[r] for r in mesh.groups(axis)[0]])


def _reference(q, k, v, n, causal, interpret):
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    shard = NamedSharding(jmesh, P("model", None, None))
    return np.asarray(jax_ulysses_attention(
        *(jax.device_put(a, shard) for a in (q, k, v)), jmesh,
        causal=causal, interpret=interpret))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_dense_path_matches_the_reference(n, causal):
    t, h, dh = 32, 8, 32
    q, k, v = _qkv(t, h, dh, seed=n + 10 * causal)
    want = _reference(q, k, v, n, causal, interpret=False)
    got = _port(q, k, v, _line_mesh(n), n, causal)
    assert got.shape == (t, h, dh) and bool(torch.isfinite(got).all())
    # the same f32 softmax attention per head on both sides, on the CPU
    tol = attention_tolerance(torch.float32, dh, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ulysses_flash_path_matches_the_reference(n, causal, monkeypatch):
    """Dh = 128: the reference takes its Pallas flash kernel (interpret
    mode here), the port ``flash_attention`` on [H/n, T, 128], which on a
    CPU tensor runs the kernel's plain version."""
    t, h, dh = 64, 8, 128
    q, k, v = _qkv(t, h, dh, seed=20 + n + 10 * causal)
    want = _reference(q, k, v, n, causal, interpret=True)
    shapes = []
    real = flash_mod.flash_attention

    def spy(qh, kh, vh, causal):
        shapes.append((tuple(qh.shape), qh.is_contiguous(),
                       kh.is_contiguous(), vh.is_contiguous()))
        return real(qh, kh, vh, causal=causal)
    monkeypatch.setattr(flash_mod, "flash_attention", spy)
    got = _port(q, k, v, _line_mesh(n), n, causal)
    # one call per rank, heads first, contiguous as the CUDA kernel needs
    assert shapes == [((h // n, t, dh), True, True, True)] * n
    # f32 on the CPU on both sides: blockwise online softmax against dense
    tol = attention_tolerance(torch.float32, dh, "cpu")
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_the_oracle_per_head(causal):
    n, t, h, dh = 4, 32, 8, 16
    q, k, v = _qkv(t, h, dh, seed=17)
    got = _port(q, k, v, _line_mesh(n), n, causal)
    want = reference_attention(
        *(torch.from_numpy(a).permute(1, 0, 2) for a in (q, k, v)),
        causal=causal).permute(1, 0, 2)
    tol = attention_tolerance(torch.float32, dh, "cpu")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_ulysses_takes_the_dense_path_off_the_kernels_shapes(monkeypatch):
    """Dh = 128 but T not a multiple of the kernel's tile: dense."""
    def refuse(*a, **k):
        raise AssertionError("flash path taken")
    monkeypatch.setattr(flash_mod, "flash_attention", refuse)
    n, t, h, dh = 2, 96, 2, 128
    q, k, v = _qkv(t, h, dh, seed=3)
    got = _port(q, k, v, _line_mesh(n), n, True)
    want = reference_attention(
        *(torch.from_numpy(a).permute(1, 0, 2) for a in (q, k, v)),
        causal=True).permute(1, 0, 2)
    tol = attention_tolerance(torch.float32, dh, "cpu")
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_ulysses_makes_three_exchanges_in_and_one_out():
    n, mesh = 4, _line_mesh(4)
    q, k, v = _qkv(16, 4, 8, seed=5)
    with collectives.recording() as log:
        _port(q, k, v, mesh, n, False)
    assert [c.op for c in log] == ["all_to_all"] * 4
    assert {c.grouping for c in log} == {mesh.grouping("model")}


def test_ulysses_over_the_model_axis_of_a_two_axis_mesh():
    mesh = make_mesh(4, MeshPlan(2, 2), device="cpu")
    q, k, v = _qkv(16, 4, 16, seed=9)
    got = _port(q, k, v, mesh, 2, True)
    assert torch.equal(got, _port(q, k, v, _line_mesh(2), 2, True))


def test_ulysses_rejects_heads_that_do_not_divide():
    x = [torch.zeros((4, 6, 16))] * 4
    with pytest.raises(ValueError,
                       match="heads 6 not divisible by axis size 4"):
        ulysses_attention(x, x, x, _line_mesh(4), "model")
