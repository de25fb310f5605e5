"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; elsewhere they skip. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full shapes. The ring kernels (K3–K6) hold n virtual ranks
on the one card, in one launch or a launch a rank, or ranks on distinct
cards where the machine has two or more (those tests skip on one card), and
must give their plain versions' bits exactly.
"""

import math

import pytest
import torch

from tpu_operator_torch.ops import flash_attention as flash_mod
from tpu_operator_torch.ops import hbm
from tpu_operator_torch.parallel import ring
from tpu_operator_torch.parallel.numerics import (attention_tolerance,
                                                  reduction_tolerance)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("sweeps", [1, 3])
def test_read_kernel_is_exact_on_ones(cuda, sweeps):
    x, _ = hbm._alloc(8, cuda)
    before = hbm.read_sum.launches
    got = hbm.read_sum(x, sweeps).item()
    assert hbm.read_sum.launches == before + 1
    assert got == hbm.read_sum_plain(x, sweeps).item() == x.numel() * sweeps


def test_read_kernel_matches_plain_on_random_data(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.rand((2 * hbm.CHUNK_ROWS, hbm.LANES), generator=gen,
                   device=cuda)
    got = hbm.read_sum(x, 2).item()
    want = hbm.read_sum_plain(x, 2).item()
    per_thread = math.ceil(x.numel() / (hbm.read_grid(cuda) * hbm.THREADS))
    assert abs(got - want) <= reduction_tolerance(torch.float32,
                                                  per_thread) * want


def test_read_kernel_rejects_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        hbm.read_sum(torch.ones(1024, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="16-byte"):
        hbm.read_sum(torch.ones(1026, device=cuda)[1:1025])


@pytest.mark.parametrize("shape,causal", [
    ((256, 128), True), ((256, 128), False), ((4, 256, 128), True),
    ((64, 128), True), ((128, 128), True),
    # 9 q tiles: q tile 8 is one unit of SPLIT = 8 kv tiles and a remainder
    ((576, 128), True), ((576, 128), False), ((2, 576, 128), True),
    ((4096, 128), True), ((4096, 128), False)])
def test_flash_kernel_matches_plain(cuda, shape, causal):
    gen = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    before = flash_mod.flash_attention.launches
    out = flash_mod.flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_mod.flash_attention.launches == before + 1
    want = flash_mod.attention_plain(q, k, v, causal=causal)
    err = (out.float() - want.float()).abs().max().item()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert err <= attention_tolerance(torch.bfloat16, shape[-1], "cuda")
    ref, limit = flash_mod.kernel_error_limit(q, k, v, causal=causal)
    assert bool(((out.float() - ref).abs() <= limit).all())


@pytest.mark.parametrize("split", [1, 3, 100])
def test_flash_kernel_units_of_any_length(cuda, split):
    """Units of one kv tile (every q tile but the first split), of three
    (ragged against nine tiles) and whole rows (no combine)."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn((2, 576, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    for causal in (True, False):
        out = flash_mod.flash_launch(q, k, v, 128 ** -0.5, causal, split)
        ref, limit = flash_mod.kernel_error_limit(q, k, v, causal=causal)
        assert bool(((out.float() - ref).abs() <= limit).all())


@pytest.mark.parametrize("t", [4096, 16384])
def test_flash_kernel_takes_the_rules_units(cuda, t):
    """K2's own schedule is its rule's for the shape on this card: the
    launch's units and partial states are those of the work list at
    ``k2_split``'s length, and the output keeps the per-element limit."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn((t, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    out = flash_mod.flash_attention(q, k, v, causal=True)
    split = flash_mod.k2_split(1, t, True, flash_mod.card_slots(cuda))
    units, merges = flash_mod.work_list(1, t, True, split)
    assert (flash_mod.flash_launch.units,
            flash_mod.flash_launch.partial_slots) == (
        len(units), sum(count for *_, count in merges))
    ref, limit = flash_mod.kernel_error_limit(q, k, v, causal=True)
    assert bool(((out.float() - ref).abs() <= limit).all())


def test_flash_kernel_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((4096, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    for causal in (True, False):
        first = flash_mod.flash_attention(q, k, v, causal=causal)
        assert torch.equal(first, flash_mod.flash_attention(q, k, v,
                                                            causal=causal))


def test_flash_kernel_rejects_what_it_cannot_take(cuda, monkeypatch):
    """Only a dtype outside f32, f16 and bf16 is refused; every other CUDA
    input goes to K2, K2w, K2dw or K2dt, heads off 8 or 4 included, never
    to the plain version. K2w's own wrapper refuses heads wider than its
    own, K2dt's every 16-bit input. bf16 with D = 128 and T a multiple of 64
    keeps K2, whatever blocks were asked for."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    monkeypatch.setattr(flash_mod, "attention_plain", refuse)
    x = torch.zeros((256, 128), device=cuda)
    xd = x.double()
    with pytest.raises(ValueError, match="float32, float16 and bfloat16"):
        flash_mod.flash_attention(xd, xd, xd)
    wide = torch.zeros((256, 640), device=cuda)
    wide16 = wide.to(torch.bfloat16)
    with pytest.raises(ValueError, match="K2dt takes float32"):
        flash_mod.flash_wide_tf32(wide16, wide16, wide16)
    with pytest.raises(ValueError, match="at most 256, got 640"):
        flash_mod.flash_wgmma(wide16, wide16, wide16)
    xb = x.to(torch.bfloat16)
    counters = (flash_mod.flash_attention, flash_mod.flash_wgmma,
                flash_mod.flash_wide_wgmma, flash_mod.flash_wide_tf32)
    counts = [fn.launches for fn in counters]
    flash_mod.flash_attention(xb, xb, xb, block_q=128, block_k=128)
    flash_mod.flash_attention(x, x, x)
    odd = torch.zeros((256, 96), device=cuda, dtype=torch.bfloat16)
    flash_mod.flash_attention(odd, odd, odd)
    off4 = torch.zeros((256, 642), device=cuda)
    flash_mod.flash_attention(off4, off4, off4)
    off8 = torch.zeros((256, 1001), device=cuda, dtype=torch.bfloat16)
    flash_mod.flash_attention(off8, off8, off8)
    torch.cuda.synchronize()
    # K2 once, K2w once, K2dw once, K2dt twice (f32 at D = 128 and 642)
    assert [fn.launches for fn in counters] == [
        n + added for n, added in zip(counts, (1, 1, 1, 2))]


def _within(out, q, k, v, causal):
    """16-bit outputs within the per-element limit, f32 within the
    attention tolerance, against the plain version."""
    if q.dtype == torch.float32:
        want = flash_mod.attention_plain(q, k, v, causal=causal)
        err = (out - want).abs().max().item()
        return err <= attention_tolerance(q.dtype, q.shape[-1], "cuda")
    ref, limit = flash_mod.kernel_error_limit(q, k, v, causal=causal)
    return bool(((out.float() - ref).abs() <= limit).all())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 96, 128, 256, 384, 512, 3, 100, 250,
                               320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_generic_kernel_matches_plain(cuda, dtype, d, causal):
    """K2dt over the head-dim buckets that the CUDA-core K2s took until it
    was retired (its chunks of 64, 128 and 256 columns) and D off them and
    past them, at a T its 64-row tiles divide and ones they do not, with
    two heads; a 16-bit input is refused by K2dt's wrapper, launches
    nothing, and goes to the kernel the routing names."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    takes = dtype == torch.float32
    for t in (1024, 200, 96, 1):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = flash_mod.flash_wide_tf32.launches
        if takes:
            out = flash_mod.flash_wide_tf32(q, k, v, causal=causal)
        else:
            with pytest.raises(ValueError, match="K2dt takes"):
                flash_mod.flash_wide_tf32(q, k, v, causal=causal)
            out = flash_mod.flash_attention(q, k, v, causal=causal,
                                            block_q=t, block_k=t)
        torch.cuda.synchronize()
        assert flash_mod.flash_wide_tf32.launches == before + takes
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t


# heads off 8 (16-bit) or 4 (f32) that K2dw and K2dt take through a padded
# row stride, odd ones among them
UNALIGNED = [(torch.float16, 257), (torch.float16, 1001),
             (torch.bfloat16, 300), (torch.bfloat16, 1020),
             (torch.bfloat16, 2049), (torch.float32, 513),
             (torch.float32, 514), (torch.float32, 1001),
             (torch.float32, 1022), (torch.float32, 2050)]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype,d", UNALIGNED)
def test_wide_kernel_matches_plain(cuda, dtype, d, causal):
    """K2dw and K2dt at heads off 8 or 4, at a T their 64-row tiles divide
    and ones they do not, with two heads: through the wrapper the routing
    names, within the limit, and the same bits on a second call."""
    gen = torch.Generator(device=cuda).manual_seed(d + 2)
    wrapper = (flash_mod.flash_wide_tf32 if dtype == torch.float32
               else flash_mod.flash_wide_wgmma)
    assert flash_mod.padded_width(dtype, d) != d
    for t in (1024, 200, 96, 1):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = wrapper.launches
        out = wrapper(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t
        assert torch.equal(out, wrapper(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_wide_kernel_against_the_generic_kernel_where_both_take_it(cuda,
                                                                  dtype):
    """At a head off 8 and 4 below 256 (D = 250), which the routing sends
    to K2dt (f32) or K2w (16-bit), the wide kernel's launch (K2dt's or
    K2dw's, which take any D) and the narrow kernel's wrapper agree within
    the limit each is held to against the plain version; in f32, where no
    narrow kernel is left, K2dt against the plain version."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    d = 250
    q, k, v = (torch.randn((2, 1024, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    if dtype == torch.float32:
        wide = flash_mod._wide_tf32_launch(q, k, v, d ** -0.5, True)
        generic = flash_mod.attention_plain(q, k, v, causal=True)
    else:
        wide = flash_mod._wide_wgmma_launch(q, k, v, d ** -0.5, True)
        generic = flash_mod.flash_wgmma(q, k, v, causal=True)
    assert _within(wide, q, k, v, True) and _within(generic, q, k, v, True)
    if dtype == torch.float32:
        tol = attention_tolerance(dtype, d, "cuda")
        assert (wide - generic).abs().max().item() <= tol
    else:
        _, limit = flash_mod.kernel_error_limit(q, k, v, causal=True)
        assert bool(((wide.float() - generic.float()).abs()
                     <= 2 * limit).all())


def _zero_padded(x, width):
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))


WIDE_COUNTERS = ("flash_attention", "flash_wgmma", "flash_wide_wgmma",
                 "flash_wide_tf32")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [264, 300, 384, 512, 520, 640, 1000, 1001,
                               1020, 1024, 2048, 2304])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wide_wgmma_kernel_matches_plain(cuda, monkeypatch, dtype, d, causal):
    """K2dw over 16-bit heads past 256 (multiples of its 256-column chunks
    and D off them: a last chunk of 8, 128 or 232 columns, and 2304's nine
    chunks; D = 300, 1001 and 1020, off 8, through the padded row stride),
    at a T its 64-row tiles divide and ones they do not, two heads:
    within the per-element limit, through K2dw alone (its wrapper and the
    routing), and the same bits on a second call."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    plain = flash_mod.attention_plain
    gen = torch.Generator(device=cuda).manual_seed(d + 3)
    for t in (1024, 96, 200):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS}
        monkeypatch.setattr(flash_mod, "attention_plain", refuse)
        out = flash_mod.flash_wide_wgmma(q, k, v, causal=causal)
        routed = flash_mod.flash_attention(q, k, v, causal=causal,
                                           block_q=t, block_k=t)
        torch.cuda.synchronize()
        monkeypatch.setattr(flash_mod, "attention_plain", plain)
        assert {n: getattr(flash_mod, n).launches - before[n]
                for n in WIDE_COUNTERS} == {
            n: 2 * (n == "flash_wide_wgmma") for n in WIDE_COUNTERS}, t
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t
        assert torch.equal(out, routed), t


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wide_wgmma_kernel_off_8_is_the_kernel_on_zero_padded_heads(cuda,
                                                                   dtype):
    """At D = 1020 and 1001 K2dw (its padded row stride, the tensor maps
    filling zeros past D) gives the bits of K2dw at D = 1024 on the same
    heads padded with zero columns at the same scale, cut back to D: the
    pad columns enter no product."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    for d in (1020, 1001):
        q, k, v = (torch.randn((2, 1024, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        for causal in (True, False):
            got = flash_mod.flash_wide_wgmma(q, k, v, causal=causal)
            padded = flash_mod.flash_wide_wgmma(
                *(_zero_padded(x, 1024) for x in (q, k, v)),
                sm_scale=1.0 / math.sqrt(d), causal=causal)
            assert _within(got, q, k, v, causal)
            assert torch.equal(got, padded[..., :d]), (d, causal)


def test_wide_wgmma_wrapper_refuses_what_it_does_not_take(cuda):
    """On the card K2dw's wrapper refuses f32, D = 256 and D = 200 and
    launches nothing; nothing falls back to another kernel or the plain
    version."""
    before = {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS}
    for dtype, d in ((torch.float32, 1024), (torch.bfloat16, 256),
                     (torch.float16, 200)):
        x = torch.zeros((128, d), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="K2dw takes"):
            flash_mod.flash_wide_wgmma(x, x, x)
    assert {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS} == \
        before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [264, 510, 513, 514, 516, 520, 640, 1000,
                               1001, 1022, 1024, 2048])
def test_wide_tf32_kernel_matches_plain(cuda, monkeypatch, d, causal):
    """K2dt over f32 heads past 256 (multiples of its 256-column chunks and
    D off them: a last chunk of 1 to 8, 128 or 232 columns; D = 264 and
    510, heads it took from K2s; D = 510, 513, 514, 1001 and 1022, off 4,
    through the padded row stride), at a
    T its 64-row tiles divide and ones they do not, two heads: within the
    f32 attention tolerance, through K2dt alone (its wrapper and the
    routing), and the same bits on a second call."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    plain = flash_mod.attention_plain
    gen = torch.Generator(device=cuda).manual_seed(d + 4)
    for t in (1024, 96, 200, 1):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   for _ in range(3))
        before = {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS}
        monkeypatch.setattr(flash_mod, "attention_plain", refuse)
        out = flash_mod.flash_wide_tf32(q, k, v, causal=causal)
        routed = flash_mod.flash_attention(q, k, v, causal=causal,
                                           block_q=t, block_k=t)
        torch.cuda.synchronize()
        monkeypatch.setattr(flash_mod, "attention_plain", plain)
        assert {n: getattr(flash_mod, n).launches - before[n]
                for n in WIDE_COUNTERS} == {
            n: 2 * (n == "flash_wide_tf32") for n in WIDE_COUNTERS}, t
        assert out.dtype == torch.float32 and out.shape == q.shape
        assert _within(out, q, k, v, causal), t
        assert torch.equal(out, routed), t


def test_wide_tf32_kernel_off_4_is_the_kernel_on_zero_padded_heads(cuda):
    """At D = 1022 and 1001 K2dt (split copies at a padded row stride, the
    tensor maps filling zeros past D) gives the bits of K2dt at D = 1024 on
    the same heads padded with zero columns at the same scale, cut back to
    D: the pad columns enter no product."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for d in (1022, 1001):
        q, k, v = (torch.randn((2, 1024, d), generator=gen, device=cuda)
                   for _ in range(3))
        for causal in (True, False):
            got = flash_mod.flash_wide_tf32(q, k, v, causal=causal)
            padded = flash_mod.flash_wide_tf32(
                *(_zero_padded(x, 1024) for x in (q, k, v)),
                sm_scale=1.0 / math.sqrt(d), causal=causal)
            assert _within(got, q, k, v, causal)
            assert torch.equal(got, padded[..., :d]), (d, causal)


@pytest.mark.parametrize("narrow,padded", [(250, 252), (3, 4)])
def test_narrow_tf32_kernel_off_4_is_the_kernel_on_zero_padded_heads(
        cuda, narrow, padded):
    """At D = 250 and 3 (chunks of 256 and 64 columns, heads off 4) K2dt
    gives the bits of K2dt at D = 252 and 4 on the same heads padded with
    zero columns at the same scale, cut back to D: TMA's zero fill keeps the
    pad out of S and P V, and no store passes D."""
    gen = torch.Generator(device=cuda).manual_seed(narrow)
    for t in (1024, 200):
        q, k, v = (torch.randn((2, t, narrow), generator=gen, device=cuda)
                   for _ in range(3))
        for causal in (True, False):
            got = flash_mod.flash_wide_tf32(q, k, v, causal=causal)
            wide = flash_mod.flash_wide_tf32(
                *(_zero_padded(x, padded) for x in (q, k, v)),
                sm_scale=1.0 / math.sqrt(narrow), causal=causal)
            assert _within(got, q, k, v, causal)
            assert torch.equal(got, wide[..., :narrow]), (t, causal)


@pytest.mark.parametrize("d", [64, 128, 1024])
def test_wide_tf32_kernel_is_the_tf32_schedule(cuda, d):
    """K2dt on the card against its arithmetic in plain PyTorch
    (``flash_chunked_tf32_plain`` on the card's tensors, at K2dt's chunk
    width for D: 64, 128 and 256) and against one TF32 product: within
    half the f32 tolerance of the first (the tensor core adds its products
    in another order than the CPU's f32 sums), and the single product more
    than the tolerance away from the exact f32 output, so the kernel's
    agreement is the split's doing."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((128, d), generator=gen, device=cuda)
               for _ in range(3))
    tol = attention_tolerance(torch.float32, d, "cuda")
    out = flash_mod.flash_wide_tf32(q, k, v, causal=True)
    model = flash_mod.flash_chunked_tf32_plain(q, k, v, True)
    one = flash_mod.flash_chunked_tf32_plain(q, k, v, True,
                                             products=("big_big",))
    exact = flash_mod.attention_plain(q, k, v, causal=True)
    assert (out - model).abs().max().item() <= tol / 2
    assert (one - exact).abs().max().item() > tol


def test_wide_tf32_wrapper_refuses_what_it_does_not_take(cuda):
    """On the card K2dt's wrapper refuses 16-bit inputs at any head dim
    (D = 1024, 256 and 130) and launches nothing; nothing falls back to
    another kernel or the plain version."""
    before = {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS}
    for dtype, d in ((torch.bfloat16, 1024), (torch.float16, 256),
                     (torch.bfloat16, 130)):
        x = torch.zeros((128, d), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="K2dt takes"):
            flash_mod.flash_wide_tf32(x, x, x)
    assert {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS} == \
        before


@pytest.mark.parametrize("d,cols", [(1000, 768), (1000, 1026), (100, 64),
                                    (60, 60)])
def test_wide_tf32_kernel_refuses_a_narrow_workspace(cuda, d, cols):
    """K2dt's C entry, like K2dw's, refuses a partials workspace whose rows
    are narrower than D rounded up to its chunk width (256 past D = 256,
    the head bucket up to it), or not a multiple of 4 floats, with
    cudaErrorInvalidValue and no launch."""
    from tpu_operator_torch import _native
    q = torch.randn((1, 256, d), device=cuda)
    out, heads, work, _workspace = flash_mod._schedule(
        q, True, flash_mod.SPLIT, 1024)
    split = torch.empty((2, d, 256), device=cuda)
    before = flash_mod.flash_wide_tf32.launches
    err = _native.library().flash_fwd_wide_tf32(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *work, cols,
        split.data_ptr(), split.data_ptr(), split.data_ptr(), heads, 256,
        d, d ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1   # cudaErrorInvalidValue
    assert flash_mod.flash_wide_tf32.launches == before


def test_wide_wgmma_kernel_refuses_a_missing_pad_workspace(cuda):
    """K2dw's C entry refuses a head off 8 (D = 1001) without the padded
    workspace to copy it into, with cudaErrorInvalidValue and no launch."""
    from tpu_operator_torch import _native
    q = torch.randn((1, 256, 1001), device=cuda).to(torch.bfloat16)
    out, heads, work, _workspace = flash_mod._schedule(
        q, True, flash_mod.SPLIT, 1024)
    before = flash_mod.flash_wide_wgmma.launches
    err = _native.library().flash_fwd_wide_wgmma(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *work,
        1024, None, flash_mod.DTYPE_CODES[q.dtype], heads, 256, 1001,
        1001 ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1   # cudaErrorInvalidValue
    assert flash_mod.flash_wide_wgmma.launches == before


@pytest.mark.parametrize("cols", [768, 1026])
def test_wide_wgmma_kernel_refuses_a_narrow_workspace(cuda, cols):
    """K2dw's C entry, like K2dt's, refuses a partials workspace whose rows
    are narrower than D rounded up to its 256-column chunks, or not a
    multiple of 4 floats, with cudaErrorInvalidValue and no launch."""
    from tpu_operator_torch import _native
    q = torch.randn((1, 256, 1000), device=cuda).to(torch.bfloat16)
    out, heads, work, _workspace = flash_mod._schedule(
        q, True, flash_mod.SPLIT, 1024)
    before = flash_mod.flash_wide_wgmma.launches
    err = _native.library().flash_fwd_wide_wgmma(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *work, cols,
        None, flash_mod.DTYPE_CODES[q.dtype], heads, 256, 1000, 1000 ** -0.5,
        1, torch.cuda.current_stream().cuda_stream)
    assert err == 1   # cudaErrorInvalidValue
    assert flash_mod.flash_wide_wgmma.launches == before


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 96, 128, 256, 8, 40])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wgmma_kernel_matches_plain(cuda, dtype, d, causal):
    """K2w over its head-dim buckets and D off them (TMA fills the bucket's
    columns past D with zeros), at T 1024, 200, 96 and 1 (rows past T
    inside each head), two heads, with kv steps of 64 keys and, at DP =
    256, of 32 (at T = 1024 the causal rows past 8 kv tiles are split into
    units and merged)."""
    gen = torch.Generator(device=cuda).manual_seed(d + 1)
    for t in (1024, 200, 96, 1):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = flash_mod.flash_wgmma.launches
        out = flash_mod.flash_wgmma(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_mod.flash_wgmma.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t
        for block_k in sorted({64, 32 if d > 128 else 64}):
            out = flash_mod._wgmma_launch(q, k, v, d ** -0.5, causal,
                                          block_k)
            assert _within(out, q, k, v, causal), (t, block_k)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [3, 100, 250])
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wgmma_kernel_off_8_matches_plain(cuda, monkeypatch, dtype, d,
                                          causal):
    """K2w at heads off 8 (3 and 250 also off 4; 3 and 100 in the buckets
    of 64 and 128), through its padded row stride, at T = 200 and 4096,
    two heads: within the per-element limit, through K2w alone (its
    wrapper and the routing), and the same bits on both calls."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    plain = flash_mod.attention_plain
    gen = torch.Generator(device=cuda).manual_seed(d + 10)
    assert flash_mod.padded_width(dtype, d) != d
    for t in (200, 4096):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = {n: getattr(flash_mod, n).launches for n in WIDE_COUNTERS}
        monkeypatch.setattr(flash_mod, "attention_plain", refuse)
        out = flash_mod.flash_wgmma(q, k, v, causal=causal)
        routed = flash_mod.flash_attention(q, k, v, causal=causal,
                                           block_q=t, block_k=t)
        torch.cuda.synchronize()
        monkeypatch.setattr(flash_mod, "attention_plain", plain)
        assert {n: getattr(flash_mod, n).launches - before[n]
                for n in WIDE_COUNTERS} == {
            n: 2 * (n == "flash_wgmma") for n in WIDE_COUNTERS}, t
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t
        assert torch.equal(out, routed), t


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_wgmma_kernel_off_8_is_the_kernel_on_zero_padded_heads(cuda, dtype):
    """K2w at D = 100 (its padded row stride, the tensor maps filling zeros
    past D, the output stored up to D) gives the bits of K2w at D = 104 on
    the same heads padded with zero columns at the same scale (the same
    bucket and kv step), cut back to D: the pad columns enter no product,
    and no store of a row passes D into the next one."""
    gen = torch.Generator(device=cuda).manual_seed(11)
    for t in (1024, 200):
        q, k, v = (torch.randn((2, t, 100), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        for causal in (True, False):
            got = flash_mod.flash_wgmma(q, k, v, sm_scale=0.1, causal=causal)
            padded = flash_mod.flash_wgmma(
                *(_zero_padded(x, 104) for x in (q, k, v)), sm_scale=0.1,
                causal=causal)
            assert _within(got, q, k, v, causal)
            assert torch.equal(got, padded[..., :100]), (t, causal)


def test_wgmma_kernel_refuses_a_missing_pad_workspace(cuda):
    """K2w's C entry refuses a head off 8 (D = 100) without the padded
    workspace to copy it into, with cudaErrorInvalidValue and no launch:
    nothing gives way to another kernel."""
    from tpu_operator_torch import _native
    q = torch.randn((1, 256, 100), device=cuda).to(torch.bfloat16)
    out, heads, work, _workspace = flash_mod._schedule(
        q, True, flash_mod.SPLIT, 128)
    before = flash_mod.flash_wgmma.launches
    err = _native.library().flash_fwd_wgmma(
        q.data_ptr(), q.data_ptr(), q.data_ptr(), out.data_ptr(), *work,
        None, flash_mod.DTYPE_CODES[q.dtype], heads, 256, 100, 64,
        100 ** -0.5, 1, torch.cuda.current_stream().cuda_stream)
    assert err == 1   # cudaErrorInvalidValue
    assert flash_mod.flash_wgmma.launches == before


@pytest.mark.parametrize("dtype,d,t,kernel", [
    (torch.bfloat16, 128, 512, "K2"), (torch.bfloat16, 128, 200, "K2w"),
    (torch.float16, 128, 512, "K2w"), (torch.bfloat16, 256, 512, "K2w"),
    (torch.float16, 100, 512, "K2w"), (torch.bfloat16, 384, 256, "K2dw"),
    (torch.float16, 512, 200, "K2dw"), (torch.bfloat16, 264, 96, "K2dw"),
    (torch.float32, 128, 512, "K2dt"), (torch.float32, 512, 96, "K2dt"),
    (torch.float32, 64, 200, "K2dt"), (torch.float32, 250, 96, "K2dt"),
    (torch.bfloat16, 640, 256, "K2dw"), (torch.float16, 1000, 200, "K2dw"),
    (torch.float16, 1001, 200, "K2dw"), (torch.bfloat16, 1001, 96, "K2dw"),
    (torch.bfloat16, 300, 200, "K2dw"), (torch.float16, 202, 96, "K2w"),
    (torch.float32, 1024, 96, "K2dt"), (torch.float32, 520, 200, "K2dt"),
    (torch.float32, 1022, 96, "K2dt"), (torch.float32, 513, 200, "K2dt")])
def test_flash_attention_launches_the_kernel_the_routing_names(
        cuda, monkeypatch, dtype, d, t, kernel):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    plain = flash_mod.attention_plain
    monkeypatch.setattr(flash_mod, "attention_plain", refuse)
    gen = torch.Generator(device=cuda).manual_seed(t + d)
    q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    counters = {"K2": flash_mod.flash_attention,
                "K2w": flash_mod.flash_wgmma,
                "K2dw": flash_mod.flash_wide_wgmma,
                "K2dt": flash_mod.flash_wide_tf32}
    before = {name: fn.launches for name, fn in counters.items()}
    out = flash_mod.flash_attention(q, k, v, causal=True, block_q=t,
                                    block_k=t)
    torch.cuda.synchronize()
    assert {name: fn.launches - before[name]
            for name, fn in counters.items()} == {
        name: int(name == kernel) for name in counters}
    monkeypatch.setattr(flash_mod, "attention_plain", plain)
    assert _within(out, q, k, v, True)


def test_generic_kernel_takes_views_and_a_scale(cuda):
    """A transposed view and a tensor at an odd offset are copied for the
    kernel; the scale passes through."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    flat = torch.randn(256 * 64 + 1, generator=gen, device=cuda)
    q = flat[1:].view(256, 64)              # 4-byte offset: not aligned
    k = torch.randn((64, 256), generator=gen, device=cuda).t()  # strided
    v = torch.randn((256, 64), generator=gen, device=cuda)
    assert q.data_ptr() % 16 and not k.is_contiguous()
    out = flash_mod.flash_attention(q, k, v, sm_scale=0.3, causal=True)
    want = flash_mod.attention_plain(q, k, v, 0.3, causal=True)
    assert (out - want).abs().max().item() <= attention_tolerance(
        torch.float32, 64, "cuda")


def test_wgmma_kernel_keeps_bf16_head_dim_128(cuda):
    gen = torch.Generator(device=cuda).manual_seed(9)
    q, k, v = (torch.randn((4, 512, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    counters = (flash_mod.flash_attention, flash_mod.flash_wgmma,
                flash_mod.flash_wide_tf32)
    counts = [fn.launches for fn in counters]
    out = flash_mod.flash_attention(q, k, v, causal=True, block_q=32,
                                    block_k=256)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [counts[0] + 1, counts[1],
                                                counts[2]]
    ref, limit = flash_mod.kernel_error_limit(q, k, v, causal=True)
    assert bool(((out.float() - ref).abs() <= limit).all())


RING = {"all_gather": (ring.ring_all_gather, ring.all_gather_plain),
        "reduce_scatter": (ring.ring_reduce_scatter, ring.reduce_scatter_plain),
        "all_reduce": (ring.ring_all_reduce, ring.all_reduce_plain),
        "all_reduce_bidir": (ring.ring_all_reduce_bidir,
                             ring.all_reduce_bidir_plain)}


def _ranks(device, n, rows, cols, seed=3):
    gen = torch.Generator(device=device).manual_seed(seed)
    return [torch.randn((rows, cols), generator=gen, device=device)
            for _ in range(n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("name", sorted(RING))
def test_ring_kernel_equals_plain(cuda, name, n):
    fn, plain = RING[name]
    xs = _ranks(cuda, n, 2 * n * n, 128)
    before = fn.launches
    outs = fn(xs)
    assert fn.launches == before + 1
    want = plain(xs)
    assert len(outs) == n
    for got, exp in zip(outs, want):
        assert got.shape == exp.shape and torch.equal(got, exp)


@pytest.mark.parametrize("blocks", [None, 2, 6])
@pytest.mark.parametrize("name", sorted(RING))
def test_ring_kernel_equals_plain_over_many_blocks(cuda, name, blocks):
    fn, plain = RING[name]
    xs = _ranks(cuda, 4, 4096, 512, seed=4)
    outs = fn(xs, blocks=blocks)
    for got, exp in zip(outs, plain(xs)):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_launch_repeats_from_zeroed_signal_words(cuda, name):
    """A launch set up once (its signal words zeroed then, and only then)
    and made three times in a row, as a timing loop makes it, ends with
    the plain version's result."""
    _, plain = RING[name]
    xs = _ranks(cuda, 4, 4096, 512, seed=5)
    launch = ring.RingLaunch(name, xs)
    for _ in range(3):
        launch.launch()
    launch.raise_on_stall()
    for got, exp in zip(launch.outs, plain(xs)):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(RING))
def test_ring_kernel_a_launch_a_rank_equals_plain_and_one_launch(cuda, name,
                                                                 n):
    """Virtual ranks cut into a launch each, on streams of their own: the
    protocol ranks on distinct cards run, on one card. The bits are the
    plain version's and the single launch's."""
    fn, plain = RING[name]
    xs = _ranks(cuda, n, 2 * n * 64, 512, seed=10 + n)
    before = fn.launches
    outs = fn(xs, per_rank=True)
    assert fn.launches == before + 1
    for got, single, exp in zip(outs, fn(xs), plain(xs)):
        assert torch.equal(got, exp) and torch.equal(got, single)


@pytest.mark.parametrize("per_rank", [False, True])
@pytest.mark.parametrize("name", sorted(RING))
def test_ring_launch_takes_fresh_inputs_launch_after_launch(cuda, name,
                                                            per_rank):
    """Three back-to-back launches of one ``RingLaunch``, new inputs
    written in place before each and the outputs copied after each, with
    no synchronisation between them: every launch gives the plain
    version's bits on its own inputs, so none waited for a count of its
    predecessor's (the epochs) or read its data."""
    _, plain = RING[name]
    n = 4
    xs = _ranks(cuda, n, 2 * n * 256, 512, seed=20)
    launch = ring.RingLaunch(name, xs, per_rank=per_rank)
    gen = torch.Generator(device=cuda).manual_seed(21)
    inputs, outputs = [], []
    for _ in range(3):
        fresh = [torch.randn(x.shape, generator=gen, device=cuda) for x in xs]
        for x, f in zip(xs, fresh):
            x.copy_(f)
        launch.launch()
        inputs.append(fresh)
        outputs.append([o.clone() for o in launch.outs])
    launch.raise_on_stall()
    assert launch.epoch == 3
    for fresh, outs in zip(inputs, outputs):
        for got, exp in zip(outs, plain(fresh)):
            assert torch.equal(got, exp)


@pytest.mark.parametrize("name", sorted(RING))
def test_a_launch_a_rank_that_cannot_all_be_resident_stalls(cuda, name,
                                                            monkeypatch):
    """Two ranks of one card, each launch as large as the card holds at
    once, the second held back on its stream behind a sleeping kernel:
    the first rank's blocks wait at the entry barrier for blocks that
    cannot be resident, and time out. The wrapper raises RingStall and
    does not hang."""
    monkeypatch.setattr(ring, "TIMEOUT_NS", 200_000_000)
    xs = _ranks(cuda, 2, 2 * 2 * 4096, 512, seed=22)
    blocks = ring.resident_blocks(cuda, name)
    blocks -= blocks % (2 if name == "all_reduce_bidir" else 1)
    launch = ring.RingLaunch(name, xs, blocks=blocks, per_rank=True)
    launch.launches[1][3].wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(launch.launches[1][3]):
        torch.cuda._sleep(2_000_000_000)    # about a second
    launch.launch()
    with pytest.raises(ring.RingStall, match="timed out"):
        launch.raise_on_stall()
    # the card is still usable, and the kernel still right
    fn, plain = RING[name]
    for got, exp in zip(fn(xs, per_rank=True), plain(xs)):
        assert torch.equal(got, exp)


@pytest.fixture
def cards():
    """The machine's cards, when it has two or more."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: ranks on distinct cards")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_kernel_across_cards_equals_plain(cards, name):
    """One rank a card, on every count of cards from two up: a launch a
    card over peer pointers, bit-equal to the plain version run on the
    ranks' tensors gathered to one card, three calls and three
    back-to-back launches of one ring with fresh inputs."""
    fn, plain = RING[name]
    for n in range(2, len(cards) + 1):
        gen = torch.Generator(device="cpu").manual_seed(30 + n)
        for _ in range(3):
            host = [torch.randn((2 * n * 64, 512), generator=gen)
                    for _ in range(n)]
            xs = [h.to(d) for h, d in zip(host, cards)]
            before = fn.launches
            outs = fn(xs)
            assert fn.launches == before + 1
            assert [o.device for o in outs] == cards[:n]
            for got, exp in zip(outs, plain(host)):
                assert torch.equal(got.cpu(), exp)
        xs = [torch.zeros((2 * n * 64, 512), device=d) for d in cards[:n]]
        launch = ring.RingLaunch(name, xs)
        for _ in range(3):
            host = [torch.randn(x.shape, generator=gen) for x in xs]
            for x, h in zip(xs, host):
                x.copy_(h)
            launch.launch()
            copies = [o.cpu() for o in launch.outs]
            for got, exp in zip(copies, plain(host)):
                assert torch.equal(got, exp)
        launch.raise_on_stall()


def test_validator_default_ranks_go_on_the_cards(cards, tmp_path):
    """With its default ranks (one a card), the validator's multi-device
    leg runs over peer pointers, the hand rings included."""
    from tpu_operator_torch.validator.components import WorkloadComponent
    counters = [ring.ring_all_reduce, ring.ring_all_reduce_bidir]
    before = [fn.launches for fn in counters]
    info = WorkloadComponent(device="cuda", collective_mb=8,
                             validations_dir=str(tmp_path)).validate()
    assert info["fabric"] == "peer"
    assert info["rank_devices"] == [str(d) for d in cards]
    assert list(info["collectives"])[-2:] == ["ring_allreduce",
                                              "ring_allreduce_bidir"]
    assert len(info["collectives"]) == 7 and info["ring_attention"]["ok"]
    assert all(fn.launches > b for fn, b in zip(counters, before))


def test_ulysses_across_cards_keeps_each_rank_on_its_card(cards):
    """One rank a card, 2·cards heads: each rank's heads run K2 on its own
    card, and the result is held to K2's per-element limit against the
    single-card computation."""
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, t, d = len(cards), 512 * len(cards), 128
    h = 2 * n
    gen = torch.Generator(device=cards[0]).manual_seed(13)
    q, k, v = (torch.randn((t, h, d), generator=gen, device=cards[0])
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(n, MeshPlan(data=1, model=n), devices=cards)
    before = flash_mod.flash_attention.launches
    outs = ulysses_attention(*([c.to(dev) for c, dev in zip(x.chunk(n), cards)]
                               for x in (q, k, v)), mesh, "model",
                             causal=True)
    assert flash_mod.flash_attention.launches == before + n
    assert [o.device for o in outs] == cards
    out = torch.cat([o.to(cards[0]) for o in outs])
    ref, limit = flash_mod.kernel_error_limit(
        *(x.permute(1, 0, 2) for x in (q, k, v)), causal=True)
    assert bool(((out.permute(1, 0, 2).float() - ref).abs() <= limit).all())


def test_dryrun_across_cards_goes_through_the_ring_kernels(cards, capsys):
    from tpu_operator_torch.entry import dryrun_multigpu
    counters = [fn for fn, _ in RING.values()]
    before = [fn.launches for fn in counters]
    assert math.isfinite(dryrun_multigpu(len(cards)))
    assert all(fn.launches > b for fn, b in zip(counters, before))
    printed = capsys.readouterr().out
    assert all(str(d) in printed for d in cards)


@pytest.mark.parametrize("name", sorted(RING))
def test_ring_grid_too_large_to_be_resident_raises(cuda, name):
    fn, _ = RING[name]
    xs = _ranks(cuda, 4, 32, 128)
    too_many = 2 * ring.resident_blocks(cuda, name)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fn(xs, blocks=too_many)
    # the card is still usable, and the kernel still right
    fn(xs)


def test_ring_stall_raises_instead_of_hanging(cuda, monkeypatch):
    """With no time to wait, a rank that has to wait for its neighbour
    gives up: the wrapper raises on the status words."""
    monkeypatch.setattr(ring, "TIMEOUT_NS", 0)
    xs = _ranks(cuda, 8, 8 * 4096, 512)
    with pytest.raises(ring.RingStall, match="timed out"):
        ring.ring_all_reduce(xs)


def test_all_gather_stall_raises_instead_of_hanging(cuda, monkeypatch):
    monkeypatch.setattr(ring, "TIMEOUT_NS", 0)
    xs = _ranks(cuda, 8, 4096, 512)
    with pytest.raises(ring.RingStall, match="timed out"):
        ring.ring_all_gather(xs)


def test_all_reduce_bidir_stall_raises_instead_of_hanging(cuda, monkeypatch):
    monkeypatch.setattr(ring, "TIMEOUT_NS", 0)
    xs = _ranks(cuda, 8, 8 * 4096, 512)
    with pytest.raises(ring.RingStall, match="timed out"):
        ring.ring_all_reduce_bidir(xs)


def test_reduce_scatter_stall_raises_instead_of_hanging(cuda, monkeypatch):
    monkeypatch.setattr(ring, "TIMEOUT_NS", 0)
    xs = _ranks(cuda, 8, 8 * 4096, 512)
    with pytest.raises(ring.RingStall, match="timed out waiting for its "
                                             "(arrival|entry barrier)"):
        ring.ring_reduce_scatter(xs)


DIRECT = {"all_gather": ring.all_gather_direct_plain,
          "reduce_scatter": ring.reduce_scatter_direct_plain,
          "all_reduce": ring.all_reduce_direct_plain,
          "all_reduce_bidir": ring.all_reduce_bidir_direct_plain}


def _blocks(name, per_direction):
    """K6 splits its blocks over two directions."""
    return 2 * per_direction if name == "all_reduce_bidir" else per_direction


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_kernel_equals_its_schedule_and_the_slot_schedule(cuda, name,
                                                                  n):
    """Each kernel gives the bits of its own schedule's plain version
    (run here with other blocks and pieces: the bits do not depend on them)
    and of the slot schedule's."""
    fn, slots = RING[name]
    xs = _ranks(cuda, n, 2 * n * 64, 128, seed=6)
    outs = fn(xs)
    for got, direct, slot in zip(outs, DIRECT[name](
            xs, blocks=_blocks(name, 3), piece_bytes=4096), slots(xs)):
        assert torch.equal(got, direct) and torch.equal(got, slot)


@pytest.mark.parametrize("piece_bytes", [16, 4112, 24576, 1 << 30])
@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_kernel_pieces_need_not_divide_the_slice(cuda, name,
                                                        piece_bytes):
    """Slices of 4096 (K3), 1024 (K4, K5) and 512 (K6) vectors cut into pieces
    of 1, 257 (a prime) and 1536 vectors, or one piece a slice."""
    _, slots = RING[name]
    xs = _ranks(cuda, 4, 4 * 56, 512, seed=7)
    launch = ring.RingLaunch(name, xs, blocks=_blocks(name, 7),
                             piece_bytes=piece_bytes)
    launch.launch()
    launch.raise_on_stall()
    for got, exp in zip(launch.outs, slots(xs)):
        assert torch.equal(got, exp)


@pytest.mark.parametrize("rows", ["dry run", "one per chunk"])
@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("name", sorted(DIRECT))
def test_direct_kernel_on_chunks_smaller_than_a_block(cuda, name, n, rows):
    """The dry run's (2n², 128) shapes (a K4 or K5 chunk of 2n rows of 32
    vectors, K6's of n rows: fewer than a block's 256 threads at n = 2) and
    one row of 128 per rank and chunk (32 vectors)."""
    _, slots = RING[name]
    rows = 2 * n * n if rows == "dry run" else _blocks(name, 1) * n
    xs = _ranks(cuda, n, rows, 128, seed=8)
    launch = ring.RingLaunch(name, xs)
    launch.launch()
    launch.raise_on_stall()
    for got, exp in zip(launch.outs, slots(xs)):
        assert torch.equal(got, exp)


def test_ring_kernels_reject_what_they_cannot_take(cuda):
    xs = [torch.zeros((8, 128), dtype=torch.float64, device=cuda)] * 2
    with pytest.raises(ValueError, match="float32"):
        ring.ring_all_reduce(xs)
    with pytest.raises(ValueError, match="16-byte"):
        ring.ring_all_reduce([torch.zeros((4, 3), device=cuda)] * 2)
    with pytest.raises(ValueError, match="several devices"):
        ring.ring_all_reduce([torch.zeros((4, 4), device=cuda),
                              torch.zeros((4, 4))])


def test_dryrun_on_the_card_goes_through_the_ring_kernels(cuda):
    from tpu_operator_torch.entry import dryrun_multigpu
    counters = [fn for fn, _ in RING.values()]
    before = [fn.launches for fn in counters]
    assert math.isfinite(dryrun_multigpu(4))
    assert all(fn.launches > b for fn, b in zip(counters, before))


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_on_the_card_goes_through_the_flash_kernel(cuda, causal):
    """4 virtual ranks, 8 heads: each rank's [2, T, 128] takes K2 once; the
    result is held to K2's per-element limit against the single-device
    computation."""
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, t, h, d = 4, 512, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(12)
    q, k, v = (torch.randn((t, h, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=cuda)
    before = flash_mod.flash_attention.launches
    out = torch.cat(ulysses_attention(
        *(list(x.chunk(n)) for x in (q, k, v)), mesh, "model", causal=causal))
    assert flash_mod.flash_attention.launches == before + n
    assert out.shape == (t, h, d) and out.dtype == torch.bfloat16
    ref, limit = flash_mod.kernel_error_limit(
        *(x.permute(1, 0, 2) for x in (q, k, v)), causal=causal)
    assert bool(((out.permute(1, 0, 2).float() - ref).abs() <= limit).all())


def test_validator_on_four_ranks_runs_the_hand_rings(cuda, tmp_path):
    from tpu_operator_torch.validator.components import WorkloadComponent
    counters = [ring.ring_all_reduce, ring.ring_all_reduce_bidir]
    before = [fn.launches for fn in counters]
    info = WorkloadComponent(device="cuda", ranks=4, collective_mb=8,
                             validations_dir=str(tmp_path)).validate()
    assert list(info["collectives"])[-2:] == ["ring_allreduce",
                                              "ring_allreduce_bidir"]
    assert len(info["collectives"]) == 7 and info["ring_attention"]["ok"]
    assert all(fn.launches > b for fn, b in zip(counters, before))


@pytest.mark.parametrize("d,kernel,dtype", [
    (256, "flash_wgmma", torch.bfloat16),
    (384, "flash_wide_wgmma", torch.bfloat16),
    (1024, "flash_wide_wgmma", torch.bfloat16),
    (1024, "flash_wide_tf32", torch.float32),
    (128, "flash_wide_tf32", torch.float32),
    (256, "flash_wide_tf32", torch.float32)])
def test_ulysses_head_dim_256_goes_through_the_generic_kernel(cuda, d,
                                                              kernel, dtype):
    """Dh = 256 goes through K2w (the tensor-core kernel that replaced the
    generic one there), Dh = 384 through K2dw, Dh = 1024 through K2dw in
    bf16 and K2dt in f32, and f32 at Dh = 128 and 256 through K2dt, once
    per rank."""
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, t, h = 4, 256, 8
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn((t, h, d), generator=gen, device=cuda)
               .to(dtype) for _ in range(3))
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=cuda)
    counters = {name: getattr(flash_mod, name) for name in WIDE_COUNTERS}
    before = {name: fn.launches for name, fn in counters.items()}
    out = torch.cat(ulysses_attention(
        *(list(x.chunk(n)) for x in (q, k, v)), mesh, "model", causal=True))
    assert {name: fn.launches - before[name]
            for name, fn in counters.items()} == {
        name: n if name == kernel else 0 for name in counters}
    assert _within(out.permute(1, 0, 2),
                   *(x.permute(1, 0, 2) for x in (q, k, v)), True)


def test_driver_component_passes_on_the_machine(cuda, tmp_path):
    """The machine's own ``libcuda.so.1``, device nodes and kernel module:
    the library loads, and its version, where both are known, is the
    module's."""
    from tpu_operator_torch.validator import driver_build
    from tpu_operator_torch.validator.components import DriverComponent
    info = DriverComponent(validations_dir=str(tmp_path)).validate()
    assert info["devices"] and info["skew"] is False
    module = driver_build.kernel_module_version("/")
    if info["build"] is not None and module is not None:
        assert driver_build.build_epoch(info["build"]) == \
            driver_build.build_epoch(module)


@pytest.mark.parametrize("component", ["driver", "fabric"])
def test_cli_components_pass_on_the_machine(cuda, tmp_path, capsys,
                                            component):
    import json
    from tpu_operator_torch.cli.validator import main
    assert main(["--component", component, "--validations-dir",
                 str(tmp_path)]) == 0
    line = json.loads(capsys.readouterr().out)
    assert line["ok"] is True and line["component"] == component
    if component == "fabric":
        n = torch.cuda.device_count()
        assert line["info"]["nvlink"] == (
            "skipped (single device)" if n == 1
            else f"ring round-trip ok over {n} devices")


@pytest.mark.parametrize("size_mb", [8, 256])
def test_hbm_sweep_probe_launches_the_read_kernel(cuda, size_mb):
    from tpu_operator_torch.health.probes import HbmSweepProbe
    before = hbm.read_sum.launches
    results = HbmSweepProbe(size_mb=size_mb).run()
    assert hbm.read_sum.launches > before
    assert len(results) == 1 and results[0].healthy
    assert results[0].gpu_index is None and "GB/s" in results[0].detail


def test_nvml_sees_the_cards_the_device_nodes_show(cuda):
    """NVML loads, keys each card it sees by a ``/dev/nvidia[0-9]*`` node's
    minor number (a container's ``/dev`` may hold nodes of cards NVML does
    not show it), and names the card torch runs on."""
    from tpu_operator_torch.deviceplugin.discovery import GpuDiscovery
    from tpu_operator_torch.utils.nvml import NvmlSource
    source = NvmlSource()
    assert source.library() is not None
    attrs = source.attributes()
    nodes = GpuDiscovery().scan()
    assert attrs and set(attrs) <= {d.index for d in nodes}
    assert torch.cuda.get_device_name(0) in {a["name"] for a in
                                             attrs.values()}
    assert source.driver_version()


def test_health_monitor_once_on_the_machine(cuda, tmp_path, capsys):
    import json
    from tpu_operator_torch.cli.health_monitor import main
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    state = tmp_path / "state.json"
    FileBackedFakeClient(str(state)).add_node("n0", {})
    before = hbm.read_sum.launches
    rc = main(["--client", f"fake:{state}", "--node-name", "n0", "--once",
               "--hbm-sweep", "--health-file", str(tmp_path / "health")])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and line["healthy"] is True
    assert hbm.read_sum.launches > before
    assert (tmp_path / "health").read_text() == ""
