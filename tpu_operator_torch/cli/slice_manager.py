"""``gpu-slice-manager`` — the NVLink slice manager's entry point:
``python -m tpu_operator_torch.cli.slice_manager``.

The port of ``tpu_operator/cli/slice_manager.py``. ``--once`` runs one
pass of the state machine, prints ``{"state": ...}`` and exits 0 on
``success``, 1 otherwise; without it the manager loops every
``--interval`` seconds. The node's cards and NVLink topology are the
machine's own (``/dev``, NVML); ``SLICE_CONFIG_FILE``, ``SLICE_STATE_DIR``,
``SLICE_PARTITIONS_FILE`` and ``GPU_DEVICE_GLOB`` point it elsewhere.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-slice-manager")
    p.add_argument("--client", default="incluster")
    p.add_argument("--node-name", default=None)
    p.add_argument("--interval", type=float, default=15.0)
    p.add_argument("--once", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"),
                   default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)

    from tpu_operator_torch.cli._client import build_operand_client
    from tpu_operator_torch.operands.slice_manager import SliceManager
    client = build_operand_client(args.client)
    sm = SliceManager(client, args.node_name)
    if args.once:
        state = sm.reconcile_once()
        json.dump({"state": state}, sys.stdout)
        print()
        return 0 if state == "success" else 1
    sm.run(interval=args.interval)
    return 0


if __name__ == "__main__":
    sys.exit(main())
