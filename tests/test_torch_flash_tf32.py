"""K2dt's arithmetic and the routing after it: every f32 head on the
tensor cores in three TF32 products (3xTF32), at a chunk as wide as the
head up to 256; 16-bit heads past 256 on K2dw.

On the card K2dt splits every operand x into big = tf32(x) and small =
tf32(x − big) and forms each product of Q·Kᵀ and P·V as small·big +
big·small + big·big in f32, on K2dw's chunked schedule.
``flash_chunked_tf32_plain`` runs that arithmetic in plain PyTorch, with
the kernel's rounding by bit mask. It is held to the reference's Pallas
kernel in interpret mode on the same numpy inputs within the f32 attention
tolerance of the card, and a single TF32 product, or the split with any of
its three products left out, must exceed that tolerance: that is what the
split is for.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_operator.ops.flash_attention import flash_attention as jax_flash
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance

# (T, D, the reference's blocks): T = 128 and T = 200, which 64 does not
# divide (four q tiles, the last one short); D = 264, 384 and 510 (off 4),
# the heads from 257 to 512 that K2dt took from K2s
CASES = [(128, 520, (64, 64)), (128, 1024, (128, 64)),
         (200, 520, (40, 200)), (200, 1024, (40, 200)),
         (128, 264, (64, 64)), (128, 384, (64, 64)), (128, 510, (64, 64))]


@functools.lru_cache(maxsize=None)
def _case(t, d, causal, blocks):
    """f32 numpy inputs of shape [t, d] and the reference's Pallas kernel on
    them in interpret mode."""
    rng = np.random.default_rng(d * 3 + t)
    arrays = [rng.standard_normal((t, d), dtype=np.float32) for _ in range(3)]
    want = jax_flash(*(jnp.asarray(a) for a in arrays), causal=causal,
                     block_q=blocks[0], block_k=blocks[1], interpret=True)
    return arrays, np.asarray(want, np.float32)


def _error_share(got, want, d):
    """The largest absolute difference over the card's f32 tolerance."""
    tol = attention_tolerance(torch.float32, d, "cuda")
    return float(np.abs(got.numpy() - want).max()) / tol


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,blocks", CASES)
def test_tf32_schedule_matches_the_pallas_kernel(t, d, blocks, causal):
    """3xTF32 on K2dw's schedule is within the f32 tolerance of the card;
    the port's ``flash_attention`` and K2dt's wrapper (on the CPU, the
    plain version) too."""
    arrays, want = _case(t, d, causal, blocks)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = port.flash_chunked_tf32_plain(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _error_share(got, want, d) <= 1.0
    routed = port.flash_attention(q, k, v, causal=causal, block_q=blocks[0],
                                  block_k=blocks[1])
    assert _error_share(routed, want, d) <= 1.0
    torch.testing.assert_close(port.flash_wide_tf32(q, k, v, causal=causal),
                               routed, rtol=0, atol=0)


# f32 heads off 4, which K2dt takes through a padded row stride: T = 128,
# and T = 200 at D = 1001
UNALIGNED = [(128, 514, (64, 64)), (200, 1001, (40, 200))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,blocks", UNALIGNED)
def test_tf32_schedule_matches_the_pallas_kernel_off_4(t, d, blocks, causal):
    """The 3xTF32 model at D = 514 and 1001 within the card's f32
    tolerance of the reference's Pallas kernel (the pad columns of the
    card's split copies enter no product: the model has none)."""
    arrays, want = _case(t, d, causal, blocks)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = port.flash_chunked_tf32_plain(q, k, v, causal)
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _error_share(got, want, d) <= 1.0


# the heads up to 256 that K2dt took from K2s, each at the chunk width of
# its bucket (tf32_chunk: 64, 128 or 256 output columns a block): the
# buckets, 96 between two of them, and 3, 100 and 250, off 4 and 8
NARROW = [(t, d, (64, 64) if t == 128 else (40, 200))
          for d in (3, 64, 96, 100, 128, 250, 256) for t in (128, 200)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,blocks", NARROW)
def test_tf32_schedule_at_the_heads_chunk_matches_the_pallas_kernel(
        t, d, blocks, causal):
    """The 3xTF32 model at K2dt's own chunk width for D ≤ 256 (the head
    bucket) within the card's f32 tolerance of the reference's Pallas
    kernel, and the same bits as at a chunk of 256 (a block's columns
    enter no other column's arithmetic)."""
    arrays, want = _case(t, d, causal, blocks)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = port.flash_chunked_tf32_plain(q, k, v, causal,
                                        chunk=port.tf32_chunk(d))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _error_share(got, want, d) <= 1.0
    torch.testing.assert_close(port.flash_chunked_tf32_plain(q, k, v, causal),
                               got, rtol=0, atol=0)


def test_tf32_chunk_is_the_head_bucket_up_to_256():
    """K2dt's chunk width: the head bucket (64, 128, 256) up to D = 256,
    256 past it; its workspace row is D rounded up to it."""
    for d in range(1, 2049):
        want = port.head_bucket(d) if d <= 256 else 256
        assert port.tf32_chunk(d) == want
        assert port.wide_columns(d, want) == -(-d // want) * want
    assert [port.tf32_chunk(d) for d in (1, 64, 65, 128, 129, 256, 257)] == [
        64, 64, 128, 128, 256, 256, 256]


# the planted faults: one TF32 product, and each of the three left out
FAULTS = {"one_tf32_product": ("big_big",),
          "no_small_big": ("big_small", "big_big"),
          "no_big_small": ("small_big", "big_big"),
          "no_big_big": ("small_big", "big_small")}
# the fault cases: the wide heads, and the chunks of 64 and 128 columns
FAULT_CASES = CASES + [case for case in NARROW if case[1] in (64, 128)]


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,d,blocks", FAULT_CASES)
def test_a_missing_product_fails_the_tolerance(t, d, blocks, causal, fault):
    arrays, want = _case(t, d, causal, blocks)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = port.flash_chunked_tf32_plain(q, k, v, causal,
                                        products=FAULTS[fault])
    assert _error_share(got, want, d) > 1.0


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("split", [1, 2])
def test_tf32_schedule_on_heads_and_units(split, causal):
    """Two heads of [200, 640] with units of 1 and 2 kv tiles: each head
    equals its own run, and the units' merge stays within the tolerance of
    the exact f32 schedule."""
    rng = np.random.default_rng(41)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 200, 640),
                                                    dtype=np.float32))
               for _ in range(3))
    got = port.flash_chunked_tf32_plain(q, k, v, causal, split=split)
    exact = port.flash_chunked_plain(q, k, v, causal, split=split)
    tol = attention_tolerance(torch.float32, 640, "cuda")
    assert (got - exact).abs().max().item() <= tol
    for h in range(2):
        torch.testing.assert_close(
            port.flash_chunked_tf32_plain(q[h], k[h], v[h], causal,
                                          split=split), got[h],
            rtol=0, atol=0)


def test_tf32_split_rounds_as_the_kernel_does():
    """big keeps 10 mantissa bits (the low 13 bits zero), rounded to
    nearest with ties away from zero; big + small is x to 2⁻²¹ of it."""
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 1.0 + 3 * 2.0 ** -11, 3.0e-7,
                      -123.456, 0.0])
    big, small = port.tf32_split(x)
    assert not bool((big.view(torch.int32) & 0x1FFF).any())
    assert not bool((small.view(torch.int32) & 0x1FFF).any())
    # a tie goes away from zero; below half an ulp goes down
    assert big[1].item() == 1.0 + 2.0 ** -10
    assert big[2].item() == -(1.0 + 2.0 ** -10)
    assert big[3].item() == 1.0
    assert big[4].item() == 1.0 + 2.0 ** -9
    rng = np.random.default_rng(3)
    y = torch.from_numpy(rng.standard_normal(4096, dtype=np.float32))
    big, small = port.tf32_split(y)
    assert bool(((big - y).abs() <= 2.0 ** -11 * y.abs()).all())
    assert bool(((big + small - y).abs() <= 2.0 ** -21 * y.abs()).all())


def test_tf32_matmul_takes_only_its_products():
    with pytest.raises(ValueError, match="products"):
        port.tf32_matmul(("big_big", "small_small"))
    with pytest.raises(ValueError, match="products"):
        port.tf32_matmul(())
    x = torch.ones((2, 2), dtype=torch.float16)
    with pytest.raises(ValueError, match="for float32"):
        port.flash_chunked_tf32_plain(x, x, x)


# every row of the routing table, at a T that 64 divides and one it does not
ROUTES = [
    (torch.bfloat16, 128, "K2"),
    (torch.float16, 256, "K2w"), (torch.bfloat16, 64, "K2w"),
    (torch.bfloat16, 264, "K2dw"), (torch.float16, 384, "K2dw"),
    (torch.bfloat16, 512, "K2dw"), (torch.bfloat16, 1024, "K2dw"),
    (torch.float32, 128, "K2dt"), (torch.float32, 384, "K2dt"),
    (torch.float32, 512, "K2dt"), (torch.float16, 100, "K2w"),
    (torch.bfloat16, 250, "K2w"), (torch.float32, 300, "K2dt"),
    (torch.bfloat16, 510, "K2dw"), (torch.bfloat16, 300, "K2dw"),
    (torch.float16, 257, "K2dw"),
    (torch.float32, 516, "K2dt"), (torch.float32, 1024, "K2dt"),
    (torch.float32, 2048, "K2dt"),
    (torch.float32, 514, "K2dt"), (torch.float32, 1001, "K2dt"),
    (torch.float16, 1001, "K2dw"), (torch.bfloat16, 1020, "K2dw")]


@pytest.mark.parametrize("t", [4096, 200])
@pytest.mark.parametrize("dtype,d,kernel", ROUTES)
def test_kernel_for_gives_the_routing_table(dtype, d, kernel, t):
    want = "K2w" if kernel == "K2" and t % port.BLOCK else kernel
    assert port.kernel_for(dtype, d, t) == want


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float16, 1024, "K2dt takes float32, got torch.float16"),
    (torch.bfloat16, 1024, "K2dt takes float32"),
    (torch.float16, 256, "K2dt takes float32, got torch.float16"),
    (torch.bfloat16, 1001, "K2dt takes float32, got torch.bfloat16"),
    (torch.bfloat16, 130, "K2dt takes float32, got torch.bfloat16")])
def test_tf32_wrapper_refuses_what_it_does_not_take(dtype, d, match):
    """Refused before any device is asked: a 16-bit kernel takes these,
    never K2dt."""
    x = torch.empty((64, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        port.flash_wide_tf32(x, x, x)


@pytest.mark.parametrize("dtype,d,match", [
    (torch.float32, 384, "K2dw takes float16 and bfloat16"),
    (torch.bfloat16, 256, "above 256, got 256"),
    (torch.float16, 100, "above 256, got 100"),
    (torch.float32, 513, "K2dw takes float16 and bfloat16")])
def test_wide_wgmma_wrapper_refuses_below_its_range(dtype, d, match):
    x = torch.empty((64, d), dtype=dtype, device="meta")
    with pytest.raises(ValueError, match=match):
        port.flash_wide_wgmma(x, x, x)


def test_each_wide_wrapper_takes_what_the_routing_sends_it():
    """For every D from 1 to 2048 and every dtype, K2dt's and K2dw's
    wrappers take an input (and then ask for its device) exactly where
    ``kernel_for`` names them, and refuse it elsewhere."""
    wrappers = {"K2dt": port.flash_wide_tf32, "K2dw": port.flash_wide_wgmma}
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        for d in range(1, 2049):
            x = torch.empty((64, d), dtype=dtype, device="meta")
            kernel = port.kernel_for(dtype, d, 64)
            for name, wrapper in wrappers.items():
                match = ("unsupported device" if kernel == name
                         else f"{name} takes")
                with pytest.raises(ValueError, match=match):
                    wrapper(x, x, x)


def test_tf32_wrapper_on_the_cpu_runs_the_plain_version():
    """K2dt's wrapper on CPU tensors is the plain version, bit for bit, and
    launches no kernel."""
    counters = (port.flash_attention, port.flash_wgmma,
                port.flash_wide_wgmma, port.flash_wide_tf32)
    before = [fn.launches for fn in counters]
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 96, 1024),
                                                    dtype=np.float32))
               for _ in range(3))
    for causal in (False, True):
        got = port.flash_wide_tf32(q, k, v, sm_scale=0.04, causal=causal)
        assert got.dtype == torch.float32 and got.shape == q.shape
        torch.testing.assert_close(
            got, port.attention_plain(q, k, v, 0.04, causal=causal), rtol=0,
            atol=0)
    assert [fn.launches for fn in counters] == before
