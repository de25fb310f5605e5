"""gpucheck CLI: ``python -m tpu_operator_torch.analysis [pass ...] [--all]``.

Exit status 0 when no findings survive the baseline, 1 otherwise (2 for
usage errors).  ``make -C tpu_operator_torch lint-invariants`` runs ``--all`` and gates
the port's CI script.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .core import (BASELINE_NAME, Context, apply_baseline, load_baseline)
from .passes import PASSES


def _default_root() -> str:
    # the package lives at <root>/tpu_operator_torch/analysis
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m tpu_operator_torch.analysis",
        description="gpucheck: project-specific invariant analyzer "
                    "(see tpu_operator_torch/docs/invariants.md)")
    p.add_argument("passes", nargs="*", metavar="pass",
                   help=f"passes to run ({', '.join(PASSES)}); "
                        f"default: all")
    p.add_argument("--all", action="store_true",
                   help="run every pass (the default when none are named)")
    p.add_argument("--list", action="store_true",
                   help="list passes and their rule ids, then exit")
    p.add_argument("--root", default=_default_root(),
                   help="repo root to analyze (default: this checkout)")
    p.add_argument("--baseline", default=None,
                   help=f"baseline file (default: <root>/{BASELINE_NAME})")
    p.add_argument("--format", choices=("text", "json"), default="text")
    args = p.parse_args(argv)

    if args.list:
        for name, mod in PASSES.items():
            print(f"{name}: {', '.join(mod.RULES)}")
        return 0

    selected = args.passes or list(PASSES)
    if args.all:
        selected = list(PASSES)
    unknown = [s for s in selected if s not in PASSES]
    if unknown:
        print(f"unknown pass(es): {', '.join(unknown)} "
              f"(known: {', '.join(PASSES)})", file=sys.stderr)
        return 2

    ctx = Context(args.root)
    findings = []
    for name in selected:
        findings.extend(PASSES[name].run(ctx))
    findings.extend(ctx.parse_failures)

    baseline_path = args.baseline or os.path.join(ctx.root, BASELINE_NAME)
    findings = apply_baseline(findings, load_baseline(baseline_path))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.format == "json":
        json.dump({"findings": [vars(f) for f in findings]}, sys.stdout,
                  indent=2, sort_keys=True)
        print()
    else:
        for f in findings:
            print(f.render())
    n = len(findings)
    print(f"gpucheck: {n} finding(s) from {len(selected)} pass(es)",
          file=sys.stderr)
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
