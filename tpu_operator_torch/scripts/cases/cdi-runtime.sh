#!/usr/bin/env bash
# CDI-runtime test case (the port of tests/cases/cdi-runtime.sh; upstream
# analogue: tests/cases/experimental-runtime.sh): rerun the full e2e cycle
# with a non-default runtime wiring injected through chart options.
#
# Pins CDI on (instead of the operator's autodetect) and schedules cards
# under a product-specific resource name; asserts the overrides actually
# land in the rendered chart before paying for the full cycle. CI_RUN
# names another entry point to hand over to (default: ../ci-run-e2e.sh).
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
ROOT="$(cd "${HERE}/../../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"
export CHART_SET_OPTIONS="--set containerToolkit.cdiEnabled=true --set devicePlugin.resourceName=nvidia.com/gpu-h100"

rendered="$(python -m tpu_operator_torch.cli.cfg render chart ${CHART_SET_OPTIONS})"
# a here-string, not `echo | grep -q`: grep -q stops at its first match,
# and under pipefail the echo it leaves writing dies of SIGPIPE and fails
# the check
grep -q "cdiEnabled: true" <<< "${rendered}" \
  || { echo "[case] FAIL: cdiEnabled override missing from render"; exit 1; }
grep -q "resourceName: nvidia.com/gpu-h100" <<< "${rendered}" \
  || { echo "[case] FAIL: resourceName override missing from render"; exit 1; }
echo "[case] render check OK: cdiEnabled and resourceName overrides rendered"

exec bash "${CI_RUN:-${HERE}/../ci-run-e2e.sh}" "$@"
