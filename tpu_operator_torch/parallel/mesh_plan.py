"""How an N-rank mesh factors into (data, model) axes, without torch.

``MeshPlan`` and ``MeshPlan.auto``, copied from
``tpu_operator/parallel/mesh.py``. They live apart from ``mesh.py``, which
imports torch, so that the operator's reshard controller plans with the
same factorization the validator's workload runs, and the control plane
loads no torch. ``parallel/mesh.py`` re-exports them.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class MeshPlan:
    """How to factor an N-rank mesh into named parallelism axes.

    data  — data parallelism (gradient sum; the outer axis)
    model — tensor parallelism (activation sums; the inner axis)
    """

    data: int
    model: int

    @property
    def n_devices(self) -> int:
        return self.data * self.model

    @staticmethod
    def auto(n_devices: int, max_model: int = 8) -> "MeshPlan":
        """Factor ``n_devices`` preferring a wide model axis, but no wider
        than ``max_model``."""
        model = 1
        for cand in range(min(n_devices, max_model), 0, -1):
            if n_devices % cand == 0:
                model = cand
                break
        return MeshPlan(data=n_devices // model, model=model)
