"""K2's split schedule in plain PyTorch (``flash_split_plain``) at
T = 576 in bf16, one head and four, full, in units of 1, 2 and
8 kv tiles: within the per-element limit of the f32 oracle and the
attention tolerance of the reference's Pallas kernel in interpret mode, on
the same numpy inputs (``tests/torch_flash_split.py``)."""

import numpy as np
import pytest
import torch

from chip_smoke import limit_ratio
from torch_flash_split import D, bf16_inputs, reference
from tpu_operator_torch.ops import flash_attention as port
from tpu_operator_torch.parallel.numerics import attention_tolerance


@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("causal", [False])
@pytest.mark.parametrize("split", [1, 2, 8])
def test_split_plain_within_the_kernel_limit_and_the_reference(split, causal,
                                                               heads):
    q, k, v = bf16_inputs(heads)
    got = port.flash_split_plain(q, k, v, causal, split)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    ref, limit = port.kernel_error_limit(q, k, v, causal=causal)
    assert limit_ratio(got, ref, limit) <= 1.0
    tol = attention_tolerance(torch.bfloat16, D)
    np.testing.assert_allclose(got.float().numpy(), reference(heads, causal),
                               rtol=tol, atol=tol)
