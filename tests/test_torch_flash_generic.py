"""Flash attention's inputs beyond K2's: f32, f16 and head dims up to 512
through the port's ``flash_attention`` (on the CPU, its plain version)
against the reference's Pallas kernel in interpret mode on the same numpy
inputs; which CUDA inputs go to K2, which to K2w, K2dw and K2dt; what
each wrapper refuses (K2dt every 16-bit input, at any head dim); and
Ulysses at Dh = 256, 384, 512, 640 and 1024, which take the flash route as
the reference does, and at a Dh off the multiples of 128, which runs dense
as the reference does. Heads past 512 (K2dw, K2dt) are held in
``tests/test_torch_flash_wide.py`` and ``tests/test_torch_flash_tf32.py``."""

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

# each kernel's wrapper, by the name ``kernel_for`` gives it (K2's instance
# has none: K2w's wrapper takes its inputs)
WRAPPERS = {"K2": port.flash_wgmma, "K2w": port.flash_wgmma,
            "K2dw": port.flash_wide_wgmma, "K2dt": port.flash_wide_tf32}
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
    ("float32", 128, 384, (64, 64)),
    ("bfloat16", 64, 512, (64, 32)),
    ("float16", 64, 40, (32, 64)),
    # 16-bit heads off 8, which K2w takes through its padded row stride
    ("float16", 128, 100, (64, 64)),
    ("bfloat16", 96, 3, (32, 96)),
    ("bfloat16", 128, 250, (64, 32)),
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
    # the wrapper of the kernel the routing names computes the same on the
    # CPU (K2's inputs: K2w's)
    wrapper = WRAPPERS[port.kernel_for(q.dtype, d, t)]
    torch.testing.assert_close(wrapper(q, k, v, causal=causal), got, rtol=0,
                               atol=0)


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
    assert (port.kernel_for(dtype, d, t) == "K2") is wgmma


@pytest.mark.parametrize("dtype,d,t,kernel", [
    (torch.bfloat16, 128, 4096, "K2"),
    (torch.bfloat16, 128, 64, "K2"),
    (torch.bfloat16, 128, 200, "K2w"),      # T not a multiple of 64
    (torch.float16, 128, 4096, "K2w"),
    (torch.bfloat16, 256, 4096, "K2w"),
    (torch.bfloat16, 64, 4096, "K2w"),
    (torch.float16, 96, 96, "K2w"),
    (torch.bfloat16, 8, 1, "K2w"),
    (torch.float16, 100, 256, "K2w"),       # D % 8 != 0 up to 256
    (torch.bfloat16, 3, 256, "K2w"),
    (torch.bfloat16, 384, 4096, "K2dw"),    # past K2w's widest bucket
    (torch.float16, 512, 1024, "K2dw"),
    (torch.float32, 128, 4096, "K2dt"),     # every f32 head
    (torch.float32, 512, 96, "K2dt"),
    (torch.float32, 5, 7, "K2dt"),
])
def test_kernel_for_routes_each_input(dtype, d, t, kernel):
    assert port.kernel_for(dtype, d, t) == kernel


@pytest.mark.parametrize("d,bucket", [(1, 64), (64, 64), (96, 128),
                                      (128, 128), (200, 256), (256, 256),
                                      (264, None), (384, None), (385, None),
                                      (512, None)])
def test_head_dim_buckets(d, bucket):
    """K2w's buckets, 64, 128 and 256, which are K2dt's chunk widths up to
    256; K2w takes no wider head (K2dw and K2dt do, by 256-column
    chunks)."""
    if bucket is not None:
        assert port.head_bucket(d) == bucket
        assert d <= port.WGMMA_MAX_HEAD_DIM and port.tf32_chunk(d) == bucket
    else:
        with pytest.raises(ValueError, match=f"head dim {d} above 256"):
            port.head_bucket(d)


@pytest.mark.parametrize("dtype,d,routed,k2dt", [
    (torch.float32, 640, "unsupported device", "unsupported device"),
    (torch.bfloat16, 520, "unsupported device",
     "K2dt takes float32, got torch.bfloat16"),
    (torch.float64, 64, "take float32, float16 and bfloat16",
     "K2dt takes float32, got torch.float64"),
    (torch.int8, 64, "take float32, float16 and bfloat16",
     "K2dt takes float32, got torch.int8"),
    (torch.float32, 256, "unsupported device", "unsupported device"),
])
def test_what_the_kernels_refuse_raises(dtype, d, routed, k2dt):
    """Off the CPU, only a dtype outside f32/f16/bf16 is refused for what it
    is by ``flash_attention``, and by K2dt's own wrapper every dtype but f32
    (``flash_attention`` takes the 16-bit ones on K2w or K2dw); a meta
    tensor, which no kernel takes, is refused for its device."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    for fn, match in ((port.flash_attention, routed),
                      (port.flash_wide_tf32, k2dt)):
        with pytest.raises(ValueError, match=match):
            fn(x, x, x)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float32, 128, "K2w takes float16 and bfloat16"),
    (torch.float16, 257, "head dim at most 256, got 257"),
    (torch.bfloat16, 384, "head dim at most 256, got 384"),
])
def test_what_k2w_refuses_raises(dtype, d, match):
    """K2w's own wrapper refuses, on any device, what its wgmma shapes
    cannot take; ``flash_attention`` sends f32 to K2dt, and 16-bit
    heads past 256 to K2dw."""
    for device in ("cpu", "meta"):
        x = torch.zeros((64, d), dtype=dtype, device=device)
        with pytest.raises(ValueError, match=match):
            port.flash_wgmma(x, x, x)


@pytest.mark.parametrize("d", [3, 100, 250])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_k2w_takes_heads_off_8(dtype, d):
    """K2w's wrapper takes a 16-bit head off 8 up to 256, which it used to
    refuse (a meta tensor then fails only for its device), the routing
    sends it there, and on the CPU it is the plain version, bit for bit."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_wgmma(x, x, x)
    assert port.kernel_for(dtype, d, 64) == "K2w"
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((96, d),
                                                    dtype=np.float32))
               .to(dtype) for _ in range(3))
    torch.testing.assert_close(port.flash_wgmma(q, k, v, causal=True),
                               port.attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("dtype,d", [(torch.float16, 64),
                                     (torch.bfloat16, 100),
                                     (torch.float16, 256),
                                     (torch.bfloat16, 1024)])
def test_k2dt_refuses_16_bit_inputs(dtype, d, device):
    """K2dt takes f32 only: its wrapper refuses f16 and bf16 (K2w or K2dw
    takes them) at any head dim, on any device, the CPU included."""
    x = torch.zeros((64, d), dtype=dtype, device=device)
    with pytest.raises(ValueError, match=f"K2dt takes float32, got {dtype}"):
        port.flash_wide_tf32(x, x, x)


@pytest.mark.parametrize("d", [1, 3, 64, 96, 100, 128, 250, 256, 257, 1024])
def test_k2dt_takes_f32_at_every_head_dim(d):
    """K2dt's wrapper takes f32 at any D, the buckets up to 256 (the CUDA-
    core kernel's before it) as much as past them: a meta tensor is refused
    only for its device, the routing names K2dt, and on the CPU the wrapper
    is the plain version, bit for bit."""
    x = torch.empty((64, d), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_wide_tf32(x, x, x)
    assert port.kernel_for(torch.float32, d, 64) == "K2dt"
    assert port.wide_tf32_takes(torch.float32, d)
    rng = np.random.default_rng(d + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, d),
                                                    dtype=np.float32))
               for _ in range(3))
    torch.testing.assert_close(port.flash_wide_tf32(q, k, v, causal=True),
                               port.attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)


def test_mixed_inputs_are_refused():
    q = torch.empty((64, 64), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port.flash_wide_tf32(q, q.to(torch.float16), q)


def test_blocks_are_checked_as_the_reference_checks_them():
    x = torch.zeros((96, 64))
    with pytest.raises(ValueError, match="divisible"):
        port.flash_attention(x, x, x)             # 64-row default blocks
    port.flash_attention(x, x, x, block_q=32, block_k=96)
    jx = jnp.zeros((96, 64))
    with pytest.raises(ValueError, match="divisible"):
        jax_flash(jx, jx, jx, block_q=64, block_k=64, interpret=True)


def test_cpu_calls_launch_no_kernel():
    counters = (port.flash_attention, port.flash_wgmma, port.flash_wide_tf32)
    before = [fn.launches for fn in counters]
    x = torch.ones((2, 96, 256), dtype=torch.float16)
    port.flash_wide_tf32(x.float(), x.float(), x.float(), causal=True)
    port.flash_wgmma(x, x, x, causal=True)
    port.flash_attention(x, x, x, block_q=32, block_k=32)
    assert [fn.launches for fn in counters] == before


def _line_mesh(n):
    return Mesh(np.array([torch.device("cpu")] * n, dtype=object), ("model",))


def _ulysses_port(q, k, v, n, causal):
    shards = [list(torch.from_numpy(a).chunk(n)) for a in (q, k, v)]
    return torch.cat(ulysses_attention(*shards, _line_mesh(n), "model",
                                       causal=causal))


def _ulysses_takes_flash(dh, causal, monkeypatch):
    n, t, h = 2, 64, 4
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


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_head_dim_256_takes_flash_as_the_reference(causal,
                                                           monkeypatch):
    _ulysses_takes_flash(256, causal, monkeypatch)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [384, 512])
def test_ulysses_wide_heads_take_flash_as_the_reference(dh, causal,
                                                        monkeypatch):
    """Dh = 384 and 512: multiples of 128 that K2dw (16-bit) and K2dt (f32)
    take on the card; the reference takes its flash kernel for them too."""
    _ulysses_takes_flash(dh, causal, monkeypatch)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dh", [640, 1024])
def test_ulysses_heads_past_512_take_flash_as_the_reference(dh, causal,
                                                            monkeypatch):
    """Dh = 640 and 1024: multiples of 128 past 512, which K2dw (16-bit)
    and K2dt (f32) take on the card; the reference takes its flash kernel
    for them too."""
    _ulysses_takes_flash(dh, causal, monkeypatch)


def test_ulysses_past_the_widest_kernel_head_runs_dense(monkeypatch):
    """Dh = 600, not a multiple of 128: dense, by the reference's rule (K2dw
    or K2dt would take it, but the rule does not send it), and equal to the
    reference's dense Ulysses."""
    def refuse(*a, **kw):
        raise AssertionError("flash path taken")
    n, t, h, dh = 2, 16, 2, 600
    q, k, v = np.random.default_rng(4).standard_normal((3, t, h, dh),
                                                       dtype=np.float32)
    jmesh = JaxMesh(np.array(jax.devices()[:n]), ("model",))
    shard = NamedSharding(jmesh, P("model", None, None))
    want = np.asarray(jax_ulysses(
        *(jax.device_put(a, shard) for a in (q, k, v)), jmesh, causal=True,
        interpret=True))
    monkeypatch.setattr(port, "flash_attention", refuse)
    got = _ulysses_port(q, k, v, n, True)
    assert got.shape == (t, h, dh)
    tol = attention_tolerance(torch.float32, dh)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
