"""The plain references at small sizes, and their controls."""

import math

import pytest
import torch

from port_bench.reference import attention, hbm_sum, matmul_chain
from port_bench.reference.precision import fp8


def _dense(q, k, v, causal):
    q, k, v = (x.double() for x in (q, k, v))
    s = q @ k.T / math.sqrt(q.shape[-1])
    if causal:
        t = q.shape[0]
        s = s.masked_fill(torch.ones(t, t).triu(1).bool(), float("-inf"))
    return torch.softmax(s, -1) @ v


@pytest.mark.parametrize("causal", [True, False])
def test_blocked_attention_matches_dense(monkeypatch, causal):
    monkeypatch.setattr(attention, "BLOCK_ROWS", 64)
    gen = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((200, 32), generator=gen) for _ in range(3))
    got = attention.attention(q, k, v, causal)
    assert attention.max_abs_err(got, _dense(q, k, v, causal)) < 1e-5
    heads = attention.attention(torch.stack([q, q]), torch.stack([k, k]),
                                torch.stack([v, v]), causal)
    assert torch.equal(heads[0], got) and torch.equal(heads[1], got)


def test_fp8_control_errs_far_above_bf16_rounding():
    gen = torch.Generator().manual_seed(2)
    q, k, v = (torch.randn((256, 128), generator=gen).to(torch.bfloat16)
               for _ in range(3))
    ref = attention.attention(q, k, v, True)
    bf16 = attention.max_abs_err(ref.to(torch.bfloat16), ref)
    low = attention.max_abs_err(attention.attention_fp8(q, k, v, True), ref)
    assert low > 5 * bf16


def test_max_abs_err_is_inf_for_a_wrong_shape_or_nan():
    x = torch.zeros(4, 2)
    assert attention.max_abs_err(x[:3], x) == math.inf
    assert attention.max_abs_err(x + float("nan"), x) == math.inf


def test_fp8_keeps_one_scale_and_rounds_to_three_bits():
    x = torch.tensor([448.0 * 3, 1.0, -2.5, 0.0])
    y = fp8(x)
    assert y[0] == x[0] and y[3] == 0
    assert (y - x).abs().max() <= x.abs().max() / 448 * 0.125 + 1e-6
    assert torch.equal(fp8(torch.zeros(3)), torch.zeros(3))


def test_matmul_chain_matches_float64():
    a, b = matmul_chain.inputs(64, 0, "cpu")
    got = matmul_chain.chain(a, b, {1, 3}, 0.01)
    x = a.double()
    for depth in (1, 2, 3):
        x = x @ b.double() * 0.01
        if depth in got:
            total, norm = got[depth]
            assert abs(total - x.sum().item()) <= 1e-5 * norm
            assert abs(norm - x.norm().item()) <= 1e-5 * norm
    low = matmul_chain.chain_fp8(a, b, {3}, 0.01)
    assert abs(low[3][0] - got[3][0]) > 1e-3 * got[3][1]


def test_matmul_inputs_are_drawn_as_the_probe_draws_them():
    gen = torch.Generator().manual_seed(0)
    a = torch.randn((8, 8), generator=gen).to(torch.bfloat16)
    b = torch.randn((8, 8), generator=gen).to(torch.bfloat16)
    ra, rb = matmul_chain.inputs(8, 0, "cpu")
    assert torch.equal(a, ra) and torch.equal(b, rb)


def test_hbm_sum_is_exact_and_its_bf16_control_saturates():
    rows = hbm_sum.rows(256, 1024, 512)
    assert rows == 65536
    assert hbm_sum.rows(1, 1024, 512) == 512
    assert hbm_sum.exact_sum(rows * 1024, 2048) == 2**26 * 2**11
    assert hbm_sum.bf16_sum(1024, 10) == 10 * 1024
    assert hbm_sum.bf16_sum(1024, rows * 2048) == 256 * 1024
