"""The cluster policy's spec types, as far as the node operands need them.

The port of ``tpu_operator/api/v1alpha1.py``: ``SpecBase`` (the dict ⇄
dataclass round trip with camelCase keys), ``ComponentSpec`` (the fields
every operand shares) and ``HealthMonitorSpec``, copied with the health
file's default on the GPU path. The rest of the policy (the other
components' specs, the policy object and its validation) is ported with
the control plane.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field, fields, is_dataclass

#: where the health monitor writes the unhealthy GPU indices, one a line;
#: the device plugin's ``GpuDiscovery`` reads it
DEFAULT_HEALTH_FILE = "/run/nvidia/gpu-health"

_CAMEL_RE = re.compile(r"_([a-z])")


def _camel(s: str) -> str:
    return _CAMEL_RE.sub(lambda m: m.group(1).upper(), s)


def _snake(s: str) -> str:
    return re.sub(r"([A-Z])", lambda m: "_" + m.group(1).lower(), s)


class SpecBase:
    """dict ⇄ dataclass round-trip with camelCase keys; unknown keys are
    preserved on a side channel so user manifests survive a
    read-modify-write."""

    @classmethod
    def from_dict(cls, d: dict | None):
        d = d or {}
        kwargs, extra = {}, {}
        names = {f.name: f for f in fields(cls)}
        for k, v in d.items():
            name = _snake(k)
            f = names.get(name)
            if f is None:
                extra[k] = v
                continue
            sub = _SPEC_TYPES.get(name)
            if sub is not None and isinstance(v, dict):
                kwargs[name] = sub.from_dict(v)
            else:
                kwargs[name] = v
        obj = cls(**kwargs)
        obj._extra = extra
        return obj

    def to_dict(self) -> dict:
        out = dict(getattr(self, "_extra", {}))
        for f in fields(self):
            v = getattr(self, f.name)
            if v is None:
                continue
            if is_dataclass(v):
                v = v.to_dict()
                if not v:
                    continue
            out[_camel(f.name)] = v
        return out


@dataclass
class ComponentSpec(SpecBase):
    """Fields shared by every operand (reference: the repeated
    repository/image/version/imagePullPolicy/env block on each spec)."""
    enabled: bool | None = None
    repository: str | None = None
    image: str | None = None
    version: str | None = None
    image_pull_policy: str = "IfNotPresent"
    image_pull_secrets: list = field(default_factory=list)
    env: list = field(default_factory=list)          # [{name, value}]
    resources: dict | None = None
    args: list = field(default_factory=list)

    DEFAULT_ENABLED = True   # core states default on

    def is_enabled(self) -> bool:
        if self.enabled is None:
            return self.DEFAULT_ENABLED
        return bool(self.enabled)


@dataclass
class HealthMonitorSpec(ComponentSpec):
    """Node health surveillance operand (reference analogue: DCGM health
    checks feeding node conditions). Probes — device presence, per-GPU
    NVLink state, counter thresholds, optional bounded HBM sweep — run
    every ``intervalSeconds``; results pass a hysteresis filter before
    anything is published, so a flapping probe cannot oscillate the node
    condition."""
    interval_seconds: int = 30
    # hysteresis windows: a GPU/node must observe CONTINUOUSLY bad for
    # unhealthyAfterSeconds before the published state flips to unhealthy,
    # and continuously good for healthyAfterSeconds before it flips back
    unhealthy_after_seconds: int = 60
    healthy_after_seconds: int = 120
    # counter name → max tolerated value (NVML counters, e.g.
    # {"ecc_uncorrected_volatile": 0})
    counter_thresholds: dict = field(default_factory=dict)
    # opt-in bounded HBM bandwidth sweep via ops/hbm.py (needs a quiesced
    # card; keep off where workloads share the device)
    hbm_sweep: dict = field(default_factory=dict)  # {enable, sizeMb, minGbps}
    # one unhealthy GPU index per line; consumed by the device plugin
    # (GpuDiscovery health_file)
    health_file: str = DEFAULT_HEALTH_FILE

    def hbm_sweep_enabled(self) -> bool:
        return bool(self.hbm_sweep.get("enable", False))


_SPEC_TYPES = {
    "health_monitor": HealthMonitorSpec,
}
