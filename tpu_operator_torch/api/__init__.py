"""The port's custom-resource types; see ``v1alpha1``."""
from .v1alpha1 import (
    GPUClusterPolicy,
    GPUClusterPolicySpec,
    State,
    ValidationError,
)
