"""The cells on the card at their own sizes, with short windows: a sound
run is correct, the control is not, and a traced run's shares stay under
the roofline. Each test skips inside the ``cuda`` fixture without a card.

    python -m pytest port_bench/tests/test_port_bench_card.py -q
"""

import pytest

from port_bench.harness import run_cell

CELLS = ["validate.default", "attn.causal-16k"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_and_its_control_is_not(cuda, cell):
    line = run_cell(cell, 2**31 + 17, 2.0, False)
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert all(m["value"] > 0 for m in line["metrics"].values())
    control = run_cell(cell, 2**31 + 18, 1.0, False, control=True)
    assert control["correct"] is False, control["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_traced_shares_stay_under_the_roofline(cuda, cell):
    line = run_cell(cell, 2**31 + 19, 3.0, True)
    assert line["correct"] is True
    for name, m in line["metrics"].items():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 100, (name, m)
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
