#!/usr/bin/env bash
# CI e2e entry point for the port (the port of tests/ci-run-e2e.sh): the
# full scenario against the file-backed fake cluster, then against the
# port's wire-protocol apiserver (real TLS + REST + watches), then the
# control plane's harnesses and the relay tier's. Against a real cluster:
# KCTL=kubectl OPERATOR="..." tpu_operator_torch/scripts/e2e/end-to-end.sh
#
# The static gates run first (`make -C tpu_operator_torch lint`:
# compileall and the gpucheck invariants). The relay tier's mode runs
# last: its scaling gate fails on the h100 kind while fault F13 is open
# (ROADMAP queue 3), and the other relay modes run before it.
set -euo pipefail
HERE="$(dirname "${BASH_SOURCE[0]}")"
ROOT="$(cd "${HERE}/../.." && pwd)"
export PYTHONPATH="${ROOT}${PYTHONPATH:+:$PYTHONPATH}"
# a harness prints one JSON report; its "ok" (chaos: "converged") decides
harness() {
  timeout -k 10 600 python -m "tpu_operator_torch.e2e.$1" "${@:2}" \
    | tee /dev/stderr | python -c "
import json, sys
rep = json.load(sys.stdin)
sys.exit(0 if rep.get('ok', rep.get('converged')) is True else 1)"
}
echo "[e2e] ===== mode 1/20: static gates (compileall + gpucheck invariants) ====="
make -C "${ROOT}/tpu_operator_torch" lint
echo "[e2e] ===== mode 2/20: file-backed fake cluster ====="
"${HERE}/e2e/end-to-end.sh" "$@"
echo "[e2e] ===== mode 3/20: wire-protocol apiserver ====="
E2E_APISERVER=1 "${HERE}/e2e/end-to-end.sh" "$@"
echo "[e2e] ===== mode 4/20: chaos convergence (seeded fault injection) ====="
harness chaos_convergence
echo "[e2e] ===== mode 5/20: steady-state zero-work benchmark ====="
harness steady_state
echo "[e2e] ===== mode 6/20: remediation MTTR (seeded device chaos) ====="
harness mttr
echo "[e2e] ===== mode 7/20: fleet scale (sharded reconcile) ====="
harness fleet_scale --ci
echo "[e2e] ===== mode 8/20: goodput scoring + pacing-vs-static chaos ====="
harness goodput --ci
echo "[e2e] ===== mode 9/20: relay serving (pooled+batched vs per-request dial) ====="
harness relay_serving --ci
echo "[e2e] ===== mode 10/20: serving SLO (continuous batching + warm cache vs window) ====="
harness serving_slo --ci
echo "[e2e] ===== mode 11/20: request tracing (phase attribution + overhead + replay) ====="
harness request_trace --ci
echo "[e2e] ===== mode 12/20: relay memory discipline (arena steady-state + donated-vs-copying + torn-stream) ====="
harness relay_mem --ci
echo "[e2e] ===== mode 13/20: elastic resharding (node kill mid-serving -> replan -> zero-loss cutover) ====="
harness reshard --ci
echo "[e2e] ===== mode 14/20: multi-tenant QoS (3-class contention matrix + shed-order invariant) ====="
harness relay_qos --ci
echo "[e2e] ===== mode 15/20: vectorized pump (columnar core >=5x + byte-identity + alloc discipline) ====="
harness pump_speed --ci
echo "[e2e] ===== mode 16/20: utilization ledger (conservation + fault isolation + burn rate) ====="
harness utilization --ci
echo "[e2e] ===== mode 17/20: multi-cell federation (cell-kill failover + warm cache + drain) ====="
harness federation --ci
echo "[e2e] ===== mode 18/20: SPMD sharded dispatch (plan sweep >=2x + exactly-once mid-flight reshard) ====="
harness spmd --ci
echo "[e2e] ===== mode 19/20: stateful sessions (QoS split >=2x + zero-alloc decode + kill migration) ====="
harness sessions --ci
echo "[e2e] ===== mode 20/20: relay tier (affinity router scaling + autoscaler + kill) ====="
harness relay_tier --ci
