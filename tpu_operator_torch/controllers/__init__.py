"""The operator's controllers: the reconciler with its Events, metrics,
leader election and watch trigger; the state pipeline (the asset loader,
the per-object apply and transforms, the state manager); and the upgrade,
remediation and reshard controllers (the port of
``tpu_operator/controllers/``)."""
from .state_manager import STATES, StateManager, WorkloadConfig
from .clusterpolicy_controller import Reconciler, ReconcileResult
