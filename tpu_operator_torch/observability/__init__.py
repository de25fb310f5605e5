"""Fleet observability — ML Productivity Goodput scoring (goodput.py).

The port of ``tpu_operator/observability``.

The package exists so goodput scoring (and future SLO machinery) lives
beside, not inside, the controllers: the engine only *reads* signals the
rest of the operator already publishes, and the controllers only *ask*
it for pacing verdicts.
"""

from .goodput import (EFFICIENCY_ANN, SLICE_LABEL, GoodputEngine,
                      GoodputReport, SliceGoodput)

__all__ = ["GoodputEngine", "GoodputReport", "SliceGoodput",
           "EFFICIENCY_ANN", "SLICE_LABEL"]
