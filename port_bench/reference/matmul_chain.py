"""The matmul probe's chain in plain PyTorch.

The probe multiplies ``a`` by ``b`` ``depth`` times, rescaling by
``scale`` after each product, and fetches the f32 sum of the result. Its
inputs are two standard normal matrices drawn from one generator seeded
with the configuration's seed, in that order, and rounded to bf16: the
reference draws them again.
"""

from __future__ import annotations

import torch

from port_bench.reference.precision import fp8, pinned_f32


def inputs(dim: int, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.randn((dim, dim), generator=gen, device=device)
    b = torch.randn((dim, dim), generator=gen, device=device)
    return a.to(torch.bfloat16), b.to(torch.bfloat16)


def chain(a, b, depths, scale: float, quantize=None) -> dict:
    """{depth: (sum, Frobenius norm)} of the chain's result after each of
    ``depths`` products, in float32 with TF32 off and sums in float64;
    ``quantize`` (the control) rounds every operand and result."""
    rnd = quantize or (lambda x: x.float())
    out = {}
    with pinned_f32():
        x, b = rnd(a), rnd(b)
        for i in range(1, max(depths) + 1):
            x = rnd((x @ b) * scale)
            if i in depths:
                y = x.double()
                out[i] = (y.sum().item(), y.norm().item())
    return out


def chain_fp8(a, b, depths, scale: float) -> dict:
    """The control of the bf16 chain: every operand and result in fp8."""
    return chain(a, b, depths, scale, quantize=fp8)
