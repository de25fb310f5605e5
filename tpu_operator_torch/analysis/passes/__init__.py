"""gpucheck pass registry.

Each pass module exposes ``run(ctx: Context) -> list[Finding]`` plus a
``RULES`` tuple naming the rule ids it can emit (used by ``--list`` and the
docs test).  Order here is report order.
"""

from . import (allocations, clocks, errors, locks, metrics_docs, pump_alloc,
               randomness, wiring)

PASSES = {
    "locks": locks,
    "clocks": clocks,
    "errors": errors,
    "randomness": randomness,
    "allocations": allocations,
    "pump-alloc": pump_alloc,
    "wiring": wiring,
    "metrics-docs": metrics_docs,
}
