"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and nvcc; elsewhere they skip. This file
imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

``chip_smoke.py`` holds the same kernels against the same plain versions at
the main path's full shapes.
"""

import math

import pytest
import torch

from tpu_operator_torch.ops import flash_attention as flash_mod
from tpu_operator_torch.ops import hbm
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
    ((64, 128), True)])
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


def test_flash_kernel_rejects_what_it_cannot_take(cuda):
    x = torch.zeros((256, 128), device=cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        flash_mod.flash_attention(x, x, x)
    xb = x.to(torch.bfloat16)
    with pytest.raises(ValueError, match="tiles"):
        flash_mod.flash_attention(xb, xb, xb, block_q=128, block_k=128)
    odd = torch.zeros((256, 96), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        flash_mod.flash_attention(odd, odd, odd)
