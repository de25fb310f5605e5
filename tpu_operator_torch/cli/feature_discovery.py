"""``gpu-feature-discovery`` — the GFD-analogue operand entry point.

The port of ``tpu_operator/cli/feature_discovery.py``:

    python -m tpu_operator_torch.cli.feature_discovery \\
        --client fake:/tmp/c.json --node-name n0 --once
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-feature-discovery")
    p.add_argument("--client", default="incluster")
    p.add_argument("--node-name", default=None)
    p.add_argument("--interval", type=float, default=None,
                   help="seconds between passes (env GFD_INTERVAL_SECONDS)")
    p.add_argument("--once", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"),
                   default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)

    from tpu_operator_torch.cli._client import build_operand_client
    from tpu_operator_torch.operands.feature_discovery import (
        FeatureDiscovery)
    client = build_operand_client(args.client)
    interval = args.interval if args.interval is not None else float(
        os.environ.get("GFD_INTERVAL_SECONDS", 60))
    fd = FeatureDiscovery(client, args.node_name)
    if args.once:
        json.dump(fd.apply_once(), sys.stdout)
        print()
        return 0
    fd.run(interval=interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
