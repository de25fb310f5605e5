"""Flash attention's inputs beyond the wgmma kernel's: f32, f16 and head
dims up to 256 through the port's ``flash_attention`` (on the CPU, its plain
version) against the reference's Pallas kernel in interpret mode on the same
numpy inputs; which CUDA inputs go to K2 and which to K2g; what still
raises; and Ulysses at Dh = 256, which now takes the flash route as the
reference does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator.parallel.ring_attention import \
    ulysses_attention as jax_ulysses
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.mesh import Mesh
from tpu_operator_torch.parallel.numerics import attention_tolerance
from tpu_operator_torch.parallel.ring_attention import ulysses_attention

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    jdt, tdt = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,t,d,blocks", [
    ("float32", 128, 64, (32, 64)),
    ("float16", 128, 128, (64, 32)),
    ("float32", 128, 256, (64, 64)),
    ("bfloat16", 128, 256, (32, 128)),
    ("float16", 96, 96, (32, 96)),
])
def test_port_matches_the_pallas_kernel(dtype, t, d, blocks, causal):
    (jq, jk, jv), (q, k, v) = _inputs((t, d), dtype, seed=t + d)
    want = jax_flash(jq, jk, jv, causal=causal, block_q=blocks[0],
                     block_k=blocks[1], interpret=True)
    got = port.flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                               block_k=blocks[1])
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = attention_tolerance(q.dtype, d)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    # K2g's wrapper computes the same on the CPU
    torch.testing.assert_close(port.flash_generic(q, k, v, causal=causal),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,t,d,wgmma", [
    (torch.bfloat16, 128, 128, True),
    (torch.bfloat16, 4096, 128, True),
    (torch.bfloat16, 96, 128, False),       # T not a multiple of 64
    (torch.bfloat16, 128, 256, False),
    (torch.bfloat16, 128, 64, False),
    (torch.float16, 128, 128, False),
    (torch.float32, 128, 128, False),
])
def test_routing_between_the_two_kernels(dtype, t, d, wgmma):
    q = torch.empty((2, t, d), dtype=dtype, device="meta")
    assert port.takes_wgmma(q) is wgmma


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float32, 320, "head dim at most 256, got 320"),
    (torch.bfloat16, 512, "head dim at most 256"),
    (torch.float64, 64, "take float32, float16 and bfloat16"),
    (torch.int8, 64, "take float32, float16 and bfloat16"),
    (torch.float32, 256, "unsupported device"),
])
def test_what_the_kernels_refuse_raises(dtype, d, match):
    """Off the CPU, only a dtype outside f32/f16/bf16 or D > 256 is refused
    for what it is; a meta tensor, which no kernel takes, is refused for its
    device."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    for fn in (port.flash_attention, port.flash_generic):
        with pytest.raises(ValueError, match=match):
            fn(x, x, x)


def test_mixed_inputs_are_refused():
    q = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_generic(q, q.to(torch.float16), q)


def test_blocks_are_checked_as_the_reference_checks_them():
    x = torch.zeros((96, 64))
    with pytest.raises(ValueError, match="divisible"):
        port.flash_attention(x, x, x)             # 64-row default blocks
    port.flash_attention(x, x, x, block_q=32, block_k=96)
    jx = jnp.zeros((96, 64))
    with pytest.raises(ValueError, match="divisible"):
        jax_flash(jx, jx, jx, block_q=64, block_k=64, interpret=True)


def test_cpu_calls_launch_no_kernel():
    before = (port.flash_attention.launches, port.flash_generic.launches)
    x = torch.ones((2, 96, 256), dtype=torch.float16)
    port.flash_generic(x, x, x, causal=True)
    port.flash_attention(x, x, x, block_q=32, block_k=32)
    assert (port.flash_attention.launches,
            port.flash_generic.launches) == before


def _line_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("model",))


def _ulysses_port(q, k, v, n, causal):
    shards = [list(torch.from_numpy(a).chunk(n)) for a in (q, k, v)]
    return torch.cat(ulysses_attention(*shards, _line_mesh(n), "model",
                                       causal=causal))


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_head_dim_256_takes_flash_as_the_reference(causal,
                                                           monkeypatch):
    n, t, h, dh = 2, 64, 4, 256
    q, k, v = np.random.default_rng(23 + causal).standard_normal(
        (3, t, h, dh), dtype=np.float32)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    shard = NamedSharding(jmesh, P("model", None, None))
    want = np.asarray(jax_ulysses(
        *(jax.device_put(a, shard) for a in (q, k, v)), jmesh,
        causal=causal, interpret=True))
    shapes = []
    real = port.flash_attention

    def spy(qh, kh, vh, causal):
        shapes.append(tuple(qh.shape))
        return real(qh, kh, vh, causal=causal)
    monkeypatch.setattr(port, "flash_attention", spy)
    got = _ulysses_port(q, k, v, n, causal)
    assert shapes == [(h // n, t, dh)] * n
    tol = attention_tolerance(torch.float32, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_ulysses_past_the_widest_kernel_head_runs_dense(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("flash path taken")
    monkeypatch.setattr(port, "flash_attention", refuse)
    q, k, v = np.random.default_rng(4).standard_normal((3, 16, 2, 384),
                                                       dtype=np.float32)
    assert _ulysses_port(q, k, v, 2, True).shape == (16, 2, 384)
