"""The reference's ``tests/test_pump.py`` on both copies of the relay tier:
each of its scenarios runs on the reference and on the port, and every
value its assertions look at must be equal after the name map
(``tests/torch_relay.py``). So does the ``--ci`` report of its harness,
``e2e/pump_speed.py``, whose 5x speedup bar on the host clock is held by
a test of its own."""

import pytest

from torch_relay import check_harness, ported_cases, run_case

#: the harness's ``--ci`` arguments to its throughput leg
CI_THROUGHPUT = {"rounds": 2, "depth": 1536, "repeats": 2}
SPEEDUP_BAR = 5.0
#: measurements of the bar at most: a machine loaded by other test
#: workers can read one under it, a regression reads every one under it
ATTEMPTS = 3


@pytest.mark.parametrize("name, fn, params", ported_cases("test_pump"))
def test_same_as_the_reference(name, fn, params, tmp_path):
    run_case(name, fn, params, tmp_path)


def test_the_harness_reports_what_the_reference_reports():
    check_harness("pump_speed")


def test_the_vectorized_pump_clears_its_speedup_bar():
    """The harness's own bar (``measure_pump_speed``: vectorized pump
    speedup ≥ 5x over the scalar core) on the port's throughput leg at the
    ``--ci`` arguments, measured up to three times."""
    from tpu_operator_torch.e2e import pump_speed

    readings = []
    for _ in range(ATTEMPTS):
        thr = pump_speed._leg_throughput(
            pump_speed.DEFAULT_SEED, keys=pump_speed.BACKLOG_KEYS,
            **CI_THROUGHPUT)
        assert thr["lost"] == 0, thr
        readings.append(thr["speedup"])
        if thr["speedup"] >= SPEEDUP_BAR:
            return
    pytest.fail(f"vectorized pump speedup {readings} all < {SPEEDUP_BAR}x")
