"""The relay half of the reference's ``tests/test_reshard.py`` on both
copies of the relay tier: the compile cache's plan generations, the plan
watcher, the working set's projection, the service's cutover and the
router's (``tests/torch_relay.py::RESHARD_RELAY``, ``RESHARD_ROUTER``),
and the analyzer's wiring pass over the resharding chain
(``RESHARD_WIRING``);
every value the assertions look at must be equal after the name map. So
does the ``--ci`` report of ``e2e/reshard.py``. The controller half runs
in ``tests/test_torch_reshard.py``."""

import pytest

from torch_relay import (RESHARD_RELAY, RESHARD_ROUTER, RESHARD_WIRING,
                         cases, check_harness, run_case)


@pytest.mark.parametrize("name, fn, params", [
    c for c in cases("test_reshard")
    if c.values[1] in RESHARD_RELAY + RESHARD_ROUTER + RESHARD_WIRING])
def test_same_as_the_reference(name, fn, params, tmp_path):
    run_case(name, fn, params, tmp_path)


def test_the_harness_reports_what_the_reference_reports():
    check_harness("reshard")
