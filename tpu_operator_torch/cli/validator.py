"""The node validator binary: ``python -m tpu_operator_torch.cli.validator``
(installed as ``gpu-validator`` in the operand image).

The port of ``tpu_operator/cli/validator.py``; reference analogue: the
nvidia-validator CLI (validator/main.go:207-315) — one ``--component`` per
subsystem, ``--wait`` for the barrier semantics, and a ``metrics`` mode
serving per-node Prometheus gauges. ``--component all`` runs every
component but ``gate``. It prints one JSON line per component and exits 1
at the first that fails.

``--device`` picks where the workload and fabric components run: the card
by default, where they fail without CUDA; ``--device cpu`` runs their plain
PyTorch paths (the workload small, the fabric over one device).
"""

from __future__ import annotations

import argparse
import json
import logging
import sys

from tpu_operator_torch.validator.components import (
    DEFAULT_VALIDATIONS_DIR, ValidationFailed, VALID_COMPONENTS,
    build_component)

log = logging.getLogger("gpu-validator")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpu-validator",
                                description="GPU node validation")
    p.add_argument("--component", required=True,
                   choices=VALID_COMPONENTS + ("metrics", "all"))
    p.add_argument("--wait", action="store_true",
                   help="retry until ready instead of failing fast")
    p.add_argument("--gates", default="",
                   help="comma-separated components for --component gate")
    p.add_argument("--validations-dir", default=DEFAULT_VALIDATIONS_DIR)
    p.add_argument("--no-status-file", action="store_true",
                   help="validate only; do not write the status file "
                        "(used by the plugin child pod)")
    p.add_argument("--device", default="cuda",
                   help="device of the workload and fabric components "
                        "(default cuda: every card for the fabric)")
    p.add_argument("--metrics-port", type=int, default=8000)
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--log-format", choices=("text", "json"),
                   default="text")
    args = p.parse_args(argv)

    from tpu_operator_torch.utils.logs import setup_logging
    setup_logging(args.verbose, args.log_format)

    if args.component == "metrics":
        from tpu_operator_torch.validator.metrics import NodeMetrics
        NodeMetrics(args.validations_dir, args.metrics_port).run()
        return 0

    names = [c for c in VALID_COMPONENTS if c != "gate"] \
        if args.component == "all" else [args.component]
    on_card = args.device.split(":")[0] == "cuda"
    for name in names:
        kw = {"validations_dir": args.validations_dir, "wait": args.wait}
        if name == "gate":
            gates = [g for g in args.gates.split(",") if g]
            if not gates:
                p.error("--component gate requires --gates a,b,...")
            kw["gates"] = gates
        elif name == "workload":
            kw["device"] = args.device
        elif name == "fabric" and not on_card:
            kw["devices"] = [args.device]
        comp = build_component(name, **kw)
        if args.no_status_file:
            comp.write_status = lambda info=None: None
            comp.clear_status = lambda: None
        try:
            info = comp.run()
            json.dump({"component": name, "ok": True, "info": info},
                      sys.stdout)
            print()
        except ValidationFailed as e:
            json.dump({"component": name, "ok": False, "error": str(e)},
                      sys.stdout)
            print()
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
