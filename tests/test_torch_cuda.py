"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; elsewhere they skip. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full shapes. The ring kernels (K3–K6) hold n virtual ranks
on the one card and must give their plain versions' bits exactly.
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


def test_flash_kernel_gives_the_same_bits_twice(cuda):
    gen = torch.Generator(device=cuda).manual_seed(4)
    q, k, v = (torch.randn((4096, 128), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    for causal in (True, False):
        first = flash_mod.flash_attention(q, k, v, causal=causal)
        assert torch.equal(first, flash_mod.flash_attention(q, k, v,
                                                            causal=causal))


def test_flash_kernel_rejects_what_it_cannot_take(cuda, monkeypatch):
    """Only a dtype outside f32, f16 and bf16, or a head dim above 512, is
    refused; every other CUDA input goes to K2, K2w or K2s, never to the
    plain version. bf16 with D = 128 and T a multiple of 64 keeps K2,
    whatever blocks were asked for."""
    def refuse(*a, **kw):
        raise AssertionError("a CUDA input reached the plain version")
    monkeypatch.setattr(flash_mod, "attention_plain", refuse)
    x = torch.zeros((256, 128), device=cuda)
    xd = x.double()
    with pytest.raises(ValueError, match="float32, float16 and bfloat16"):
        flash_mod.flash_attention(xd, xd, xd)
    wide = torch.zeros((256, 640), device=cuda)
    with pytest.raises(ValueError, match="head dim at most 512"):
        flash_mod.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError, match="head dim at most 512"):
        flash_mod.flash_generic(wide, wide, wide)
    wide16 = wide.to(torch.bfloat16)
    with pytest.raises(ValueError, match="at most 256, got 640"):
        flash_mod.flash_wgmma(wide16, wide16, wide16)
    xb = x.to(torch.bfloat16)
    counters = (flash_mod.flash_attention, flash_mod.flash_wgmma,
                flash_mod.flash_generic)
    counts = [fn.launches for fn in counters]
    flash_mod.flash_attention(xb, xb, xb, block_q=128, block_k=128)
    flash_mod.flash_attention(x, x, x)
    odd = torch.zeros((256, 96), device=cuda, dtype=torch.bfloat16)
    flash_mod.flash_attention(odd, odd, odd)
    torch.cuda.synchronize()
    assert [fn.launches for fn in counters] == [counts[0] + 1,
                                                counts[1] + 1,
                                                counts[2] + 1]


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
@pytest.mark.parametrize("d", [64, 96, 128, 256, 384, 512, 3, 100, 320])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_generic_kernel_matches_plain(cuda, dtype, d, causal):
    """K2s over its head-dim buckets and D off them, at a T its 64-row
    tiles divide and ones they do not, with two heads."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    for t in (1024, 200, 96, 1):
        q, k, v = (torch.randn((2, t, d), generator=gen, device=cuda)
                   .to(dtype) for _ in range(3))
        before = flash_mod.flash_generic.launches
        out = flash_mod.flash_generic(q, k, v, causal=causal)
        torch.cuda.synchronize()
        assert flash_mod.flash_generic.launches == before + 1
        assert out.dtype == dtype and out.shape == q.shape
        assert _within(out, q, k, v, causal), t


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


@pytest.mark.parametrize("dtype,d,t,kernel", [
    (torch.bfloat16, 128, 512, "K2"), (torch.bfloat16, 128, 200, "K2w"),
    (torch.float16, 128, 512, "K2w"), (torch.bfloat16, 256, 512, "K2w"),
    (torch.float16, 100, 512, "K2s"), (torch.bfloat16, 384, 256, "K2s"),
    (torch.float32, 128, 512, "K2s"), (torch.float32, 512, 96, "K2s")])
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
                "K2s": flash_mod.flash_generic}
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
                flash_mod.flash_generic)
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
    """A launch set up once and made three times in a row, as a timing
    loop makes it, ends with the plain version's result."""
    _, plain = RING[name]
    xs = _ranks(cuda, 4, 4096, 512, seed=5)
    launch = ring.RingLaunch(name, xs)
    for _ in range(3):
        launch.launch()
    launch.raise_on_stall()
    for got, exp in zip(launch.outs, plain(xs)):
        assert torch.equal(got, exp)


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


@pytest.mark.parametrize("d,kernel", [(256, "flash_wgmma"),
                                      (384, "flash_generic")])
def test_ulysses_head_dim_256_goes_through_the_generic_kernel(cuda, d,
                                                              kernel):
    """Dh = 256 goes through K2w (the tensor-core kernel that replaced the
    generic one there), Dh = 384 through K2s, once per rank."""
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, t, h = 4, 256, 8
    gen = torch.Generator(device=cuda).manual_seed(14)
    q, k, v = (torch.randn((t, h, d), generator=gen, device=cuda)
               .to(torch.bfloat16) for _ in range(3))
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=cuda)
    counters = {name: getattr(flash_mod, name) for name in
                ("flash_attention", "flash_wgmma", "flash_generic")}
    before = {name: fn.launches for name, fn in counters.items()}
    out = torch.cat(ulysses_attention(
        *(list(x.chunk(n)) for x in (q, k, v)), mesh, "model", causal=True))
    assert {name: fn.launches - before[name]
            for name, fn in counters.items()} == {
        name: n if name == kernel else 0 for name in counters}
    ref, limit = flash_mod.kernel_error_limit(
        *(x.permute(1, 0, 2) for x in (q, k, v)), causal=True)
    assert bool(((out.permute(1, 0, 2).float() - ref).abs() <= limit).all())


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
