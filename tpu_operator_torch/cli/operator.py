"""The operator binary: ``python -m tpu_operator_torch.cli.operator``.

The port of ``tpu_operator/cli/operator.py``: the Lease is
``gpu-operator-leader``, the variables ``GPU_OPERATOR_*``, the namespace
``gpu-operator``, and ``--client fake:`` seeds one node that NFD labels an
NVIDIA PCI device (``feature.node.kubernetes.io/pci-10de.present``) and
the sample ``GPUClusterPolicy`` (``config/samples/``). Nothing here loads
torch: the reconcile loop runs no device code. ``--leader-elect`` uses the
epoch-fenced elector of ``controllers/leader.py``; the reference's older
unfenced elector in this module, which its loop no longer uses, is not
copied.

Reference analogue: main.go — flags, metrics/health endpoints, leader
election, then the reconcile loop: level-triggered with a requeue-interval
floor, woken early by watch events (controllers/watch.py) when the client
supports them; leader election via a Lease CR.

``--client fake:`` runs against an in-memory cluster seeded with GPU nodes —
the zero-cluster demo/debug mode (and what e2e harness smoke uses).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

from tpu_operator_torch.api.v1alpha1 import _IMAGE_ENV
from tpu_operator_torch.controllers.clusterpolicy_controller import Reconciler
from tpu_operator_torch.controllers.leader import LeaderElector
from tpu_operator_torch.controllers.metrics import OperatorMetrics
from tpu_operator_torch.kube.fake import FakeClient
from tpu_operator_torch.kube.objects import Obj
from tpu_operator_torch.utils import prom, trace

log = logging.getLogger("gpu-operator")

#: the sample cluster policy ``--client fake:`` seeds
SAMPLE_CR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "config",
    "samples", "v1alpha1_gpuclusterpolicy.yaml")
#: the operands' image variables, each once
IMAGE_ENVS = tuple(dict.fromkeys(_IMAGE_ENV.values()))


def _seed_image_env():
    for env in IMAGE_ENVS:
        os.environ.setdefault(env, "registry.invalid/gpu-operator:dev")


def build_client(spec: str):
    if spec == "fake:":
        c = FakeClient(auto_ready=True)
        c.add_node("fake-gpu-node", {
            "feature.node.kubernetes.io/pci-10de.present": "true"})
        import yaml
        with open(SAMPLE_CR) as f:
            c.create(Obj(yaml.safe_load(f)))
        _seed_image_env()
        return c
    if spec.startswith("fake:"):
        # file-backed shared fake cluster (e2e harness): fake:/path.json —
        # NOT auto-seeded; the harness creates nodes/CR via the kubectl shim
        from tpu_operator_torch.kube.fake import FileBackedFakeClient
        _seed_image_env()
        return FileBackedFakeClient(spec[len("fake:"):])
    if spec == "incluster":
        from tpu_operator_torch.kube.incluster import InClusterClient
        return InClusterClient()
    if spec.startswith(("https://", "http://")):
        # an explicit apiserver URL (the in-repo wire-protocol apiserver, a
        # kubeconfig-less dev cluster, a port-forward)
        from tpu_operator_torch.cli._client import url_client
        _seed_image_env()
        return url_client(spec)
    raise SystemExit(f"unknown --client {spec!r} (use 'incluster', "
                     f"'https://host:port' with KUBE_TOKEN/KUBE_CA_FILE "
                     f"env, 'fake:' or 'fake:/state.json')")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-operator",
                                description="GPU cluster operator")
    p.add_argument("--client", default="incluster",
                   help="'incluster' or 'fake:' (demo mode)")
    p.add_argument("--namespace",
                   default=os.environ.get(
                       "GPU_OPERATOR_NAMESPACE",
                       os.environ.get("OPERATOR_NAMESPACE",  # downward API
                                      "gpu-operator")))
    p.add_argument("--assets", default=None, help="assets dir override")
    p.add_argument("--metrics-port", type=int, default=8080)
    p.add_argument("--trace-out", default=None, metavar="FILE",
                   help="write the last reconcile traces as Chrome "
                        "trace-event JSON after every pass (load in "
                        "chrome://tracing or Perfetto); traces are also "
                        "served live at /debug/traces on the metrics port")
    p.add_argument("--leader-elect", action="store_true")
    p.add_argument("--once", action="store_true",
                   help="single reconcile; print result JSON and exit "
                        "(exit 0 iff ready)")
    # retry layer (kube/retry.py): on by default — a transient apiserver
    # blip should cost a jittered backoff, not a failed pass
    retry = p.add_argument_group("retry/circuit-breaker")
    retry.add_argument("--retry-max-attempts", type=int, default=5)
    retry.add_argument("--retry-base-s", type=float, default=0.1,
                       help="first backoff envelope (doubles per attempt)")
    retry.add_argument("--retry-cap-s", type=float, default=5.0,
                       help="backoff envelope ceiling")
    retry.add_argument("--retry-breaker-threshold", type=int, default=5,
                       help="consecutive transient failures that trip the "
                            "circuit breaker to fast-fail")
    retry.add_argument("--retry-breaker-cooldown-s", type=float,
                       default=10.0,
                       help="seconds the breaker stays open before letting "
                            "one half-open probe through")
    retry.add_argument("--no-retry", action="store_true",
                       help="disable the retry layer (raw client errors)")
    # chaos layer (kube/chaos.py): all off by default; seeded fault
    # injection for resilience drills against a live stack
    chaos = p.add_argument_group("chaos (fault injection)")
    chaos.add_argument("--chaos-rate", type=float, default=0.0,
                       help="probability an API request gets an injected "
                            "HTTP 429/500/503")
    chaos.add_argument("--chaos-seed", type=int, default=0)
    chaos.add_argument("--chaos-latency-s", type=float, default=0.0)
    chaos.add_argument("--chaos-latency-rate", type=float, default=0.0)
    chaos.add_argument("--chaos-verbs", default="",
                       help="comma-separated verb scope (empty = all)")
    chaos.add_argument("--chaos-kinds", default="",
                       help="comma-separated kind scope (empty = all)")
    chaos.add_argument("--chaos-watch-drop-rate", type=float, default=0.0,
                       help="probability a watch stream is torn after a "
                            "few events")
    chaos.add_argument("--chaos-gone-rate", type=float, default=0.0,
                       help="probability a watch is answered 410 Gone")
    from tpu_operator_torch.utils.logs import add_logging_flags, setup_logging
    add_logging_flags(p)
    args = p.parse_args(argv)

    setup_logging(args.verbose, args.log_format)

    client = build_client(args.client)
    # the base client owns the keep-alive pool; capture it before the
    # chaos/retry wrappers rebind `client` (shared /debug/pools surface)
    base_pool = getattr(client, "pool", None)

    def pools_json() -> dict:
        out = {}
        if base_pool is not None:
            out["apiserver"] = base_pool.stats()
        return out

    metrics = OperatorMetrics()
    metrics.set_build_info()
    # client stack, innermost out: chaos (optional) → retry → cache (the
    # Reconciler adds the cache): retries see injected faults exactly as
    # they would see a hostile apiserver, and the cache only ever sees
    # settled results
    from tpu_operator_torch.kube.chaos import ChaosKubeClient, rules_from_flags
    injector = rules_from_flags(
        args.chaos_rate, args.chaos_seed, latency_s=args.chaos_latency_s,
        latency_rate=args.chaos_latency_rate, verbs=args.chaos_verbs,
        kinds=args.chaos_kinds, watch_drop_rate=args.chaos_watch_drop_rate,
        gone_rate=args.chaos_gone_rate)
    if injector is not None:
        log.warning("chaos fault injection ENABLED (rate=%s seed=%s)",
                    args.chaos_rate, args.chaos_seed)
        client = ChaosKubeClient(client, injector, metrics=metrics)
    if not args.no_retry:
        from tpu_operator_torch.kube.retry import RetryPolicy, RetryingKubeClient
        client = RetryingKubeClient(client, RetryPolicy(
            max_attempts=args.retry_max_attempts, base_s=args.retry_base_s,
            cap_s=args.retry_cap_s,
            breaker_threshold=args.retry_breaker_threshold,
            breaker_cooldown_s=args.retry_breaker_cooldown_s),
            metrics=metrics)
    # The read-through cache pays off on wire clients (every converged GET
    # is a real API round-trip saved) and is invalidated by their watch
    # streams. File-backed fake clusters are mutated by OTHER processes the
    # in-process watch cannot see, and the in-memory fake has no reads
    # worth saving — keep those uncached. GPU_OPERATOR_CACHE=0 opts out.
    use_cache = (os.environ.get("GPU_OPERATOR_CACHE", "1") != "0"
                 and not args.client.startswith("fake:"))
    # ring eviction is counted, not silent: a dropped reconcile trace
    # increments gpu_operator_traces_dropped_total
    tracer = trace.Tracer(
        on_drop=lambda n: metrics.traces_dropped_total.inc(n))
    # epoch-fenced elector (controllers/leader.py): the Reconciler wraps
    # its writes in a fencing barrier so a stale leader aborts mid-pass
    # instead of racing the standby that replaced it
    elector = (LeaderElector(client, args.namespace, metrics=metrics)
               if args.leader_elect else None)
    rec = Reconciler(client, args.namespace, args.assets, metrics,
                     cache=use_cache, tracer=tracer, elector=elector)

    if args.once:
        res = rec.reconcile()
        if args.trace_out:
            tracer.write_chrome(args.trace_out)
        json.dump({"ready": res.ready, "message": res.message,
                   "requeueAfter": res.requeue_after,
                   "states": res.statuses}, sys.stdout, indent=2,
                  sort_keys=True)
        print()
        return 0 if res.ready else 1

    srv = prom.serve(metrics.registry, args.metrics_port,
                     ready_check=rec.is_ready, tracer=tracer,
                     goodput_json=rec.goodput.debug_json,
                     pools_json=pools_json)
    log.info("metrics/health on :%d", srv.server_address[1])
    from tpu_operator_torch.controllers.watch import WatchTrigger
    trigger = WatchTrigger(client, args.namespace).start()
    MIN_INTERVAL_S = 1.0   # debounce ceiling for event bursts (reference:
    #                        the 100ms-3s expo rate limiter,
    #                        clusterpolicy_controller.go:46)
    try:
        while True:
            if elector and not elector.try_acquire():
                log.debug("not leader; standing by")
                time.sleep(5)
                continue
            try:
                res = rec.reconcile()
                log.info("reconcile: ready=%s %s (requeue %ss)",
                         res.ready, res.message, res.requeue_after)
                sleep_s = res.requeue_after
                if args.trace_out:
                    # atomic replace: a crashed pass never strands a torn file
                    tracer.write_chrome(args.trace_out)
            except Exception:
                # any error (apiserver blip, bad asset) → log and retry, never
                # crash-loop the operator
                log.exception("reconcile failed")
                metrics.reconciliation_failed_total.inc()
                metrics.reconciliation_status.set(-1)
                sleep_s = 5
            if elector:
                # renew well inside the lease window or leadership flaps
                sleep_s = min(sleep_s, elector.lease_seconds / 3)
            # requeue timer is the floor; a watch event wakes us early.
            # After a wake, coalesce the burst instead of a fixed stall: a
            # single event reacts near-instantly, a storm still costs one pass
            if trigger.wait(sleep_s):
                trigger.drain(max_s=MIN_INTERVAL_S)
    except KeyboardInterrupt:
        trigger.stop()
        srv.shutdown()
        return 0


if __name__ == "__main__":
    sys.exit(main())
