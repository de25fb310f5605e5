"""The grid of K2's split schedule in plain PyTorch against the
reference's Pallas kernel in interpret mode: f16 at D = 256, causal and full,
T = 96, 200 and 1024, one head and three.
``tests/torch_flash_split.py`` holds the inputs and the check; the grid
is spread over ``test_torch_flash_split_grid_*.py``, about a minute of
one worker each."""

import pytest

from torch_flash_split import check_grid


@pytest.mark.parametrize("heads", [1, 3])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t", [96, 200, 1024])
@pytest.mark.parametrize("d", [256])
def test_split_plain_at_any_shape_matches_the_reference(d, t, causal, heads):
    check_grid("float16", d, t, causal, heads)
