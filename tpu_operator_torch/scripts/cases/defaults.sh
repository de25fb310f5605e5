#!/usr/bin/env bash
# Default-options test case (the port of tests/cases/defaults.sh): run the
# port's CI entry point (static gates, the install/verify/mutate/uninstall
# cycle in both cluster modes, the harnesses) with stock chart values.
# CI_RUN names another entry point to hand over to (default: ../ci-run-e2e.sh).
set -euo pipefail
HERE="$(cd "$(dirname "${BASH_SOURCE[0]}")" && pwd)"
exec bash "${CI_RUN:-${HERE}/../ci-run-e2e.sh}" "$@"
