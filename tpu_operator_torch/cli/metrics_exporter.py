"""Metrics-exporter binary: ``python -m tpu_operator_torch.cli.metrics_exporter``.

The port of ``tpu_operator/cli/metrics_exporter.py``: the dcgm-exporter
analogue, which scrapes the node-local ``gpu-metrics-agent`` and serves its
samples relabeled. Env contract: ``GPU_METRICS_AGENT_ADDR``,
``GPU_METRICS_EXPORTER_PORT``, ``NODE_NAME``, ``GPU_ACCELERATOR_TYPE``.
"""

from __future__ import annotations

import argparse
import os
import sys

from tpu_operator_torch.operands.metrics_exporter import MetricsExporter


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-metrics-exporter")
    p.add_argument("--agent-addr",
                   default=os.environ.get("GPU_METRICS_AGENT_ADDR",
                                          "127.0.0.1:9401"),
                   help="host:port (or URL) of gpu-metrics-agent")
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("GPU_METRICS_EXPORTER_PORT",
                                              "9400")))
    p.add_argument("--node-name",
                   default=os.environ.get("NODE_NAME", ""))
    p.add_argument("--accelerator-type",
                   default=os.environ.get("GPU_ACCELERATOR_TYPE", ""))
    p.add_argument("--validations-dir", default="/run/nvidia/validations")
    p.add_argument("--scrape-interval", type=float, default=15.0)
    p.add_argument("--once", action="store_true",
                   help="scrape once, print the exporter page, exit "
                        "(non-zero if the agent is unreachable)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)

    exporter = MetricsExporter(
        agent_addr=args.agent_addr,
        node_name=args.node_name,
        accelerator=args.accelerator_type,
        validations_dir=args.validations_dir)
    if args.once:
        ok = exporter.scrape_once()
        sys.stdout.write(exporter.render())
        return 0 if ok else 1
    exporter.run(port=args.port, interval=args.scrape_interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
