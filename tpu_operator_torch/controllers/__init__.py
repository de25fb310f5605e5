"""The operator's state pipeline: the asset loader, the per-object apply
and transforms, and the state manager (the port of
``tpu_operator/controllers/``; the reconciler and the other controllers
come with the next slice)."""
from .state_manager import STATES, StateManager, WorkloadConfig
