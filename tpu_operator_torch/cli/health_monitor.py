"""``gpu-health-monitor`` — the DCGM-health-check-analogue operand entry
point: probe engine + hysteresis + NodeCondition/annotation/health-file
publication (``tpu_operator_torch/health/``).

The port of ``tpu_operator/cli/health_monitor.py``: the same flags, with
the GPU's environment names. ``--sysfs-root`` (``GPU_SYSFS_ROOT``) points
the link and counter probes at attribute files ``<root>/nvidia<N>/<attr>``;
without it they read NVML. ``--once`` prints one JSON line and exits 0
when the node is healthy, 1 when not.

    python -m tpu_operator_torch.cli.health_monitor \\
        --client fake:/tmp/c.json --node-name n0 --once --hbm-sweep
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading

log = logging.getLogger("gpu-operator")


def main(argv=None) -> int:
    from tpu_operator_torch.api.v1alpha1 import (DEFAULT_HEALTH_FILE,
                                                 HealthMonitorSpec)
    from tpu_operator_torch.deviceplugin.discovery import HEALTH_FILE_ENV

    env = os.environ
    p = argparse.ArgumentParser(prog="gpu-health-monitor")
    p.add_argument("--client", default="incluster")
    p.add_argument("--node-name", default=env.get("NODE_NAME"))
    p.add_argument("--interval", type=float,
                   default=float(env.get("HEALTH_INTERVAL_S", "30")))
    p.add_argument("--unhealthy-after", type=float,
                   default=float(env.get("HEALTH_UNHEALTHY_AFTER_S", "60")))
    p.add_argument("--healthy-after", type=float,
                   default=float(env.get("HEALTH_HEALTHY_AFTER_S", "120")))
    p.add_argument("--health-file",
                   default=env.get(HEALTH_FILE_ENV, DEFAULT_HEALTH_FILE))
    p.add_argument("--dev-root", default="/dev")
    p.add_argument("--sysfs-root", default=env.get("GPU_SYSFS_ROOT", ""),
                   help="attribute files <root>/nvidia<N>/<attr> for the "
                        "link and counter probes (default: NVML)")
    p.add_argument("--counter-thresholds",
                   default=env.get("HEALTH_COUNTER_THRESHOLDS", ""),
                   help='JSON map, e.g. {"ecc_uncorrected_volatile": 0}')
    p.add_argument("--hbm-sweep", action="store_true",
                   default=env.get("HEALTH_HBM_SWEEP") == "true")
    p.add_argument("--hbm-sweep-config",
                   default=env.get("HEALTH_HBM_SWEEP_JSON", ""),
                   help='JSON hbmSweep spec, e.g. '
                        '{"enable": true, "sizeMb": 256, "minGbps": 2500}')
    p.add_argument("--expected-gpus", "--expected-chips", type=int,
                   dest="expected_gpus",
                   default=int(env.get("HEALTH_EXPECTED_GPUS", "0")),
                   help="GPUs this node must expose; 0 = learn from the "
                        "first non-empty device scan")
    p.add_argument("--metrics-port", type=int,
                   default=int(env.get("HEALTH_METRICS_PORT", "9403")))
    p.add_argument("--once", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)
    if not args.node_name:
        p.error("--node-name (or NODE_NAME) is required")

    from tpu_operator_torch.cli._client import build_operand_client
    from tpu_operator_torch.health.monitor import HealthMonitor
    from tpu_operator_torch.health.probes import probes_from_spec
    from tpu_operator_torch.utils import trace

    thresholds = {}
    if args.counter_thresholds:
        try:
            thresholds = json.loads(args.counter_thresholds)
        except ValueError:
            p.error("--counter-thresholds must be a JSON object")
    hbm_sweep = {}
    if args.hbm_sweep_config:
        try:
            hbm_sweep = json.loads(args.hbm_sweep_config)
        except ValueError:
            hbm_sweep = None
        if not isinstance(hbm_sweep, dict):
            p.error("--hbm-sweep-config must be a JSON object")
    if args.hbm_sweep:
        hbm_sweep.setdefault("enable", True)
    spec = HealthMonitorSpec(
        counter_thresholds=thresholds, hbm_sweep=hbm_sweep)
    client = build_operand_client(args.client)
    tracer = trace.Tracer()
    mon = HealthMonitor(
        client, args.node_name,
        probes=probes_from_spec(spec, dev_root=args.dev_root,
                                sysfs_root=args.sysfs_root or None,
                                expected_gpus=args.expected_gpus),
        health_file=args.health_file,
        unhealthy_after_s=args.unhealthy_after,
        healthy_after_s=args.healthy_after,
        tracer=tracer)
    if args.once:
        out = mon.reconcile_once()
        json.dump(out, sys.stdout)
        print()
        return 0 if out["healthy"] else 1

    if args.metrics_port > 0:
        from tpu_operator_torch.utils.prom import serve
        try:
            serve(mon.metrics.registry, args.metrics_port, tracer=tracer)
        except OSError as e:
            log.warning("metrics port %d unavailable: %s",
                        args.metrics_port, e)
    stop = threading.Event()
    mon.run(interval_s=args.interval, stop=stop)
    return 0


if __name__ == "__main__":
    sys.exit(main())
