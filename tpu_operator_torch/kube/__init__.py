"""The Kubernetes client layer, copied from the reference package: objects,
selectors, the client interface with its errors, the fake cluster, the
in-cluster client, and the read-through cache, the retrying client and
the chaos wrapper the operator stacks on them."""

from .objects import Obj, gvr_for, REGISTRY
from .selectors import match_labels, parse_selector
from .client import (KubeClient, KubeError, NotFoundError, ConflictError,
                     AlreadyExistsError, TransientError, ThrottledError,
                     ServerUnavailableError, NetworkError)
from .fake import FakeClient
from .cache import CachedKubeClient
from .retry import RetryingKubeClient, RetryPolicy, CircuitOpenError
from .chaos import ChaosKubeClient, ChaosRules, FaultInjector
