"""The reference's ``tests/test_federation.py`` on both copies of the relay
tier: home cells, capacity-typed spill, cell kills and drains (with the
two 100-seed exactly-once properties), cache replication, the
federation's metrics, operand and CLI; every value its assertions look
at must be equal after the name map (``tests/torch_relay.py``). So does
the ``--ci`` report of ``e2e/federation.py``. The wiring-pass scenario
runs the port's analyzer (``tpu_operator_torch/analysis``) on the port's
chart, CRDs, transforms and CLIs."""

import pytest

from torch_relay import check_harness, ported_cases, run_case


@pytest.mark.parametrize("name, fn, params", ported_cases("test_federation"))
def test_same_as_the_reference(name, fn, params, tmp_path):
    run_case(name, fn, params, tmp_path)


def test_the_harness_reports_what_the_reference_reports():
    check_harness("federation")

