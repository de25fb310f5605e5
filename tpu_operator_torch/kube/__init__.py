"""The Kubernetes client layer the validator needs, copied from the
reference package: objects, selectors, the client interface with its
errors, the fake cluster and the in-cluster client."""

from .objects import Obj, gvr_for, REGISTRY
from .selectors import match_labels, parse_selector
from .client import (KubeClient, KubeError, NotFoundError, ConflictError,
                     AlreadyExistsError, TransientError, ThrottledError,
                     ServerUnavailableError, NetworkError)
from .fake import FakeClient
