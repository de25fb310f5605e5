"""GPU node health monitoring (reference analogue: DCGM health checks
feeding node conditions).

The port of ``tpu_operator/health``. Node side: ``probes`` (device
presence, NVLink, NVML counter thresholds, a bounded HBM sweep on K1) run
through ``hysteresis`` debouncing, and ``monitor`` publishes the result as
a ``nvidia.com/GPUHealthy`` NodeCondition, per-GPU annotations, a health
file the device plugin consumes, and Prometheus families.
"""

from .hysteresis import Debouncer                              # noqa: F401
from .monitor import (GPU_ANNOTATION_FMT, NODE_CONDITION_TYPE,  # noqa: F401
                      HealthMonitor, HealthMonitorMetrics)
from .probes import (CounterThresholdProbe, DevicePresenceProbe,  # noqa: F401
                     HbmSweepProbe, NvLinkProbe, ProbeResult)
