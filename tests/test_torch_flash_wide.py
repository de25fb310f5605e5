"""Flash attention on the wide kernels: the routing of every 16-bit head
past 256 to K2dw and every f32 head past 512 to K2dt, at any D (a head
off 8 or 4 goes through a padded row stride, ``padded_width``), their
wrappers on the CPU, the workspace row they share, and the schedule both
run, in plain PyTorch.

On the card K2dw and K2dt cut the output's head dim into chunks of
``WIDE_CHUNK`` columns, one block a (unit, chunk), and every block forms
the scores from all of D again. ``flash_chunked_plain`` runs that schedule
with the kernels' roundings. Both it and the port's ``flash_attention`` (on the CPU,
its plain version) are held to the reference's Pallas kernel in interpret
mode on the same numpy inputs, within the attention tolerance, and the
schedule, for 16-bit inputs, to the per-element limit of the f32 oracle
that the kernel is held to on the card; a chunk that forms its scores from
its own columns only, or a chunk never written, must fail that limit.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import limit_ratio
from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance

DTYPES = {"float32": (jnp.float32, torch.float32),
          "float16": (jnp.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@functools.lru_cache(maxsize=None)
def _case(dtype, shape, causal, blocks):
    """Numpy inputs of ``shape`` ([T, D]) and the reference's Pallas kernel
    on them in interpret mode, in ``dtype``."""
    t, d = shape
    rng = np.random.default_rng(d * 3 + t)
    arrays = [rng.standard_normal(shape, dtype=np.float32) for _ in range(3)]
    jdt = DTYPES[dtype][0]
    want = jax_flash(*(jnp.asarray(a, jdt) for a in arrays), causal=causal,
                     block_q=blocks[0], block_k=blocks[1], interpret=True)
    return arrays, np.asarray(want, np.float32)


def _torch(arrays, dtype):
    return [torch.from_numpy(a).to(DTYPES[dtype][1]) for a in arrays]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("t,d,blocks", [(96, 520, (32, 96)),
                                        (128, 640, (64, 64)),
                                        (64, 1000, (64, 32)),
                                        (128, 1024, (128, 64))])
def test_flash_attention_past_512_matches_the_pallas_kernel(t, d, blocks,
                                                            dtype, causal):
    arrays, want = _case(dtype, (t, d), causal, blocks)
    q, k, v = _torch(arrays, dtype)
    got = port.flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                               block_k=blocks[1])
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = attention_tolerance(q.dtype, d)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # the routed kernel's own wrapper computes the same on the CPU
    wrapper = WIDE_WRAPPERS[port.kernel_for(q.dtype, d, t)]
    torch.testing.assert_close(wrapper(q, k, v, causal=causal), got, rtol=0,
                               atol=0)


WIDE_WRAPPERS = {"K2dw": port.flash_wide_wgmma, "K2dt": port.flash_wide_tf32}


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,t,d,blocks", [
    ("float16", 64, 1001, (64, 32)), ("bfloat16", 96, 300, (32, 96)),
    ("bfloat16", 64, 1020, (64, 64)), ("float32", 128, 514, (64, 64)),
    ("float32", 64, 1001, (64, 32))])
def test_unaligned_heads_match_the_pallas_kernel(dtype, t, d, blocks,
                                                 causal):
    """The heads off 8 (16-bit) or 4 (f32) that K2dw and K2dt now take
    through a padded row stride: ``flash_attention`` and the wrapper the
    routing names (on the CPU, the plain version) against the reference's
    Pallas kernel in interpret mode, within the attention tolerance."""
    arrays, want = _case(dtype, (t, d), causal, blocks)
    q, k, v = _torch(arrays, dtype)
    assert port.padded_width(q.dtype, d) != d
    kernel = port.kernel_for(q.dtype, d, t)
    assert kernel == ("K2dt" if dtype == "float32" else "K2dw")
    tol = attention_tolerance(q.dtype, d)
    for got in (port.flash_attention(q, k, v, causal=causal,
                                     block_q=blocks[0], block_k=blocks[1]),
                WIDE_WRAPPERS[kernel](q, k, v, causal=causal)):
        assert got.dtype == q.dtype and got.shape == q.shape
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_padded_width_gives_a_16_byte_row_and_no_chunk_more(dtype):
    """For every D from 257 to 4096: the padded row is a multiple of 16
    bytes, less than one 16-byte group past D, and holds the same number
    of 256-column chunks as D."""
    size = torch.empty((), dtype=dtype).element_size()
    group = 16 // size
    for d in range(257, 4097):
        dp = port.padded_width(dtype, d)
        assert dp * size % 16 == 0, d
        assert 0 <= dp - d < group, d
        assert -(-dp // port.WIDE_CHUNK) == -(-d // port.WIDE_CHUNK), d
        assert port.wide_columns(dp) == port.wide_columns(d), d


# T = 200: four q tiles, the last one short; blocks the reference takes
RAGGED = (200, 1000)
RAGGED_BLOCKS = (40, 200)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("chunk", [128, 256])
def test_chunked_schedule_matches_the_reference(chunk, split, causal):
    """bf16 at T = 200, D = 1000 (a last chunk of 232 or 104 columns):
    within the per-element limit and the reference's tolerance."""
    arrays, want = _case("bfloat16", RAGGED, causal, RAGGED_BLOCKS)
    q, k, v = _torch(arrays, "bfloat16")
    got = port.flash_chunked_plain(q, k, v, causal, split=split, chunk=chunk)
    assert got.dtype == q.dtype and got.shape == q.shape
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, RAGGED[1])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype,chunk,split", [("float16", 256, 8),
                                               ("float16", 128, 1),
                                               ("float32", 256, 2),
                                               ("float32", 128, 8)])
def test_chunked_schedule_in_f16_and_f32(dtype, chunk, split, causal):
    """f16 within the per-element limit at its own unit roundoff; f32 (no
    rounding of P) within the attention tolerance of the reference."""
    arrays, want = _case(dtype, RAGGED, causal, RAGGED_BLOCKS)
    q, k, v = _torch(arrays, dtype)
    got = port.flash_chunked_plain(q, k, v, causal, split=split, chunk=chunk)
    if q.dtype == torch.float16:
        ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
        assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(q.dtype, RAGGED[1])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [False, True])
def test_chunked_schedule_on_heads(causal):
    """Three heads of [128, 640] at the kernel's chunk and split: the
    chunks of one head do not mix with another's."""
    rng = np.random.default_rng(31)
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 128, 640),
                                                    dtype=np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = port.flash_chunked_plain(q, k, v, causal)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    for h in range(3):
        torch.testing.assert_close(
            port.flash_chunked_plain(q[h], k[h], v[h], causal), got[h],
            rtol=0, atol=0)


def test_one_chunk_is_the_split_schedule():
    """A chunk as wide as D leaves one block a unit: the schedule is the
    unchunked one (``flash_split_plain``) bit for bit."""
    arrays, _ = _case("bfloat16", RAGGED, True, RAGGED_BLOCKS)
    q, k, v = _torch(arrays, "bfloat16")
    torch.testing.assert_close(
        port.flash_chunked_plain(q, k, v, True, split=2, chunk=RAGGED[1]),
        port.flash_split_plain(q, k, v, True, split=2), rtol=0, atol=0)
    with pytest.raises(ValueError, match="chunk"):
        port.flash_chunked_plain(q, k, v, True, chunk=0)


def _own_columns_only(q, k, v, causal, chunk):
    """The planted fault: each chunk forms its scores from its own columns
    of Q and K, at the scale of the whole head."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    outs = []
    for c0 in range(0, q.shape[-1], chunk):
        cols = slice(c0, c0 + chunk)
        parts = port.split_partials(q[..., cols], k[..., cols], v[..., cols],
                                    causal, port.SPLIT, scale)
        outs.append(torch.cat([port.combine_partials(parts[row])
                               for row in range(len(parts))], dim=-2))
    return torch.cat(outs, dim=-1).to(q.dtype)


def _dropped_chunk(q, k, v, causal, chunk):
    """The planted fault: the second chunk's columns never written (zeros
    in place of the block's output)."""
    out = port.flash_chunked_plain(q, k, v, causal, chunk=chunk)
    out[..., chunk:2 * chunk] = 0
    return out


@pytest.mark.parametrize("fault", [_own_columns_only, _dropped_chunk])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_a_wrong_chunk_is_rejected_by_the_limit(dtype, causal, fault):
    arrays, _ = _case(dtype, (128, 640), causal, (64, 64))
    q, k, v = _torch(arrays, dtype)
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    chunk = port.WIDE_CHUNK
    assert limit_ratio(port.flash_chunked_plain(q, k, v, causal, chunk=chunk),
                       ref, limit) <= 1.0
    assert limit_ratio(fault(q, k, v, causal, chunk), ref, limit) > 1.0


@pytest.mark.parametrize("t", [1, 4096])
@pytest.mark.parametrize("d", [513, 600, 1024, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_kernel_for_sends_every_head_past_512_to_a_tensor_core_kernel(
        dtype, d, t):
    """Past 512, 16-bit heads go to K2dw and f32 heads to K2dt, D = 513
    and 600 (off 8, and 513 off 4) as much as the aligned ones."""
    want = "K2dt" if dtype == torch.float32 else "K2dw"
    assert port.kernel_for(dtype, d, t) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_kernel_for_keeps_512_and_below_where_they_were(dtype):
    """Up to 256, f32 goes to K2dt (the CUDA-core K2s's inputs until it was
    retired) and 16-bit heads go to K2w, off 8 or not; past 256 up to 512,
    K2dt takes f32 and K2dw 16-bit, at any D."""
    wide = "K2dt" if dtype == torch.float32 else "K2dw"
    assert port.kernel_for(dtype, 512, 4096) == wide
    assert port.kernel_for(dtype, 384, 4096) == wide
    assert port.kernel_for(dtype, 300, 4096) == wide
    assert port.kernel_for(dtype, 256, 4096) == (
        "K2dt" if dtype == torch.float32 else "K2w")
    assert port.kernel_for(dtype, 250, 4096) == (
        "K2dt" if dtype == torch.float32 else "K2w")


COUNTERS = ("flash_attention", "flash_wgmma", "flash_wide_wgmma",
            "flash_wide_tf32")


def test_wide_wrapper_on_the_cpu_launches_nothing():
    """K2dw's and K2dt's wrappers at heads off 8 and 4 (f16 D = 1001, f32
    D = 514) on CPU tensors are the plain version, bit for bit, as is the
    routing, and launch nothing."""
    before = [getattr(port, n).launches for n in COUNTERS]
    rng = np.random.default_rng(5)
    for dtype, d, wrapper in ((torch.float16, 1001, port.flash_wide_wgmma),
                              (torch.float32, 514, port.flash_wide_tf32)):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, d),
                                                        dtype=np.float32))
                   .to(dtype) for _ in range(3))
        got = wrapper(q, k, v, sm_scale=0.05, causal=True)
        want = port.attention_plain(q, k, v, 0.05, causal=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(
            port.flash_attention(q, k, v, sm_scale=0.05, causal=True), want,
            rtol=0, atol=0)
    assert [getattr(port, n).launches for n in COUNTERS] == before


@pytest.mark.parametrize("wrapper,dtype,name", [
    (port.flash_wide_wgmma, torch.bfloat16, "K2dw"),
    (port.flash_wide_tf32, torch.float32, "K2dt")])
def test_wide_wrapper_refuses_what_no_kernel_takes(wrapper, dtype, name):
    """At an unaligned head (D = 1001) each wide wrapper refuses another
    dtype, a device that is not the card's and mismatched shapes before it
    launches; ``flash_attention`` refuses a dtype no kernel takes."""
    x = torch.empty((64, 1001), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match=f"{name} takes float"):
        wrapper(x, x, x)
    with pytest.raises(ValueError, match="take float32, float16 and bfloat16"):
        port.flash_attention(x, x, x)
    y = torch.empty((64, 1001), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(y, y, y)
    with pytest.raises(ValueError, match="share a"):
        wrapper(y, y[:32], y)


def test_wide_wgmma_wrapper_on_the_cpu_runs_the_plain_version():
    """K2dw's wrapper on CPU tensors is the plain version, bit for bit, and
    launches no kernel."""
    before = [getattr(port, n).launches for n in COUNTERS]
    rng = np.random.default_rng(6)
    for dtype in (torch.float16, torch.bfloat16):
        q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, 1024),
                                                        dtype=np.float32))
                   .to(dtype) for _ in range(3))
        for causal in (False, True):
            got = port.flash_wide_wgmma(q, k, v, sm_scale=0.04, causal=causal)
            assert got.dtype == dtype and got.shape == q.shape
            torch.testing.assert_close(
                got, port.attention_plain(q, k, v, 0.04, causal=causal),
                rtol=0, atol=0)
    assert [getattr(port, n).launches for n in COUNTERS] == before


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float32, 1024, "takes float16 and bfloat16"),
    (torch.bfloat16, 256, "above 256, got 256"),
    (torch.float16, 200, "above 256, got 200")])
def test_wide_wgmma_wrapper_refuses_what_it_does_not_take(dtype, d, match):
    """f32, D = 256 and D = 200 are refused before any device is asked:
    K2dt or K2w takes them, never K2dw."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        port.flash_wide_wgmma(x, x, x)


def test_wide_columns_hold_every_chunk_block():
    """For every D from 513 to 4096 the workspace row is D rounded up to
    ``WIDE_CHUNK``: room for all of a unit's chunk blocks, a multiple of 4
    (the C entries refuse anything else) and no chunk more."""
    for d in range(513, 4097):
        cols = port.wide_columns(d)
        assert cols % port.WIDE_CHUNK == 0 and cols % 4 == 0, d
        assert d <= cols < d + port.WIDE_CHUNK, d
        assert cols // port.WIDE_CHUNK == math.ceil(d / port.WIDE_CHUNK), d
    assert port.wide_columns(1001) == 1024 and port.wide_columns(1024) == 1024


def test_wide_wgmma_wrapper_takes_what_the_routing_sends_it():
    """For every D from 513 to 4096 and every dtype, K2dw's wrapper takes
    an input (and then asks for its device) exactly where ``kernel_for``
    names K2dw, and refuses it where ``kernel_for`` names K2dt."""
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in range(513, 4097):
            x = torch.empty((64, d), dtype=dtype, device="meta")
            kernel = port.kernel_for(dtype, d, 64)
            assert kernel in ("K2dw", "K2dt"), (dtype, d)
            match = ("unsupported device" if kernel == "K2dw"
                     else "K2dw takes")
            with pytest.raises(ValueError, match=match):
                port.flash_wide_wgmma(x, x, x)


@pytest.mark.parametrize("wrapper,dtype,d", [
    (port.flash_wide_wgmma, torch.float16, 388),
    (port.flash_wide_wgmma, torch.bfloat16, 1001),
    (port.flash_wide_tf32, torch.float32, 514),
    (port.flash_wide_tf32, torch.float32, 1001)])
def test_wide_wrappers_take_heads_they_used_to_refuse(wrapper, dtype, d):
    """Heads off 8 (16-bit) or 4 (f32), which the wide wrappers refused
    before they took a padded row stride: accepted (a meta tensor then
    fails only for its device), and on the CPU the plain version."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        wrapper(x, x, x)
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((96, d),
                                                    dtype=np.float32))
               .to(dtype) for _ in range(3))
    torch.testing.assert_close(wrapper(q, k, v, causal=True),
                               port.attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
