"""gpucheck: project-specific static analysis for the GPU operator.

The upstream GPU Operator leans on Go's toolchain (``go vet``,
golangci-lint, the race detector) to keep a privileged, concurrent control
plane honest.  This package is the Python operator's analogue: an
AST-walking analyzer that machine-checks the conventions the codebase's
correctness actually rests on —

- **locks**: no blocking calls (``time.sleep``, subprocess, sockets,
  ``Future.result()``) while a ``threading.Lock``/``RLock`` is held, no
  nested acquisition of a non-reentrant lock, no cross-function lock-order
  inversions within a module.
- **clocks**: modules that declare an injectable ``clock=`` parameter
  (the virtual-time test contract) must not read wall time directly.
- **errors**: every ``raise`` in the ``relay/``/``kube/`` data planes
  stays inside the ``KubeError`` taxonomy that drives retry
  classification, and broad ``except Exception:`` handlers must re-raise
  or log.
- **randomness**: ``e2e/`` and ``tests/`` must draw from seeded
  ``random.Random(seed)`` instances, never the module-level RNG.
- **wiring**: the five-way CRD ↔ chart ↔ env projection contract
  (``api/v1alpha1.py`` ↔ ``api/crdgen.py`` ↔ both checked-in CRD YAML
  copies ↔ chart ``values.yaml`` ↔ ``transform_*`` env projections) is
  proven consistent instead of hand-maintained.
- **metrics-docs**: registered Prometheus families ⇄ ``docs/metrics.md``
  rows ⇄ Grafana dashboard queries stay in sync.

Paths are relative to the repository root: the package with its chart,
CRDs and docs lives under ``tpu_operator_torch/``, and ``tests/`` beside
it is scanned too.

Run it with ``python -m tpu_operator_torch.analysis --all`` (or
``make -C tpu_operator_torch lint-invariants``).  See
``tpu_operator_torch/docs/invariants.md`` for each rule's rationale and
the suppression syntax (``# gpucheck: ignore[rule] -- justification``).
"""

from .core import Context, Finding, load_baseline  # noqa: F401
