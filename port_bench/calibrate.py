"""The readings that the limits of ``correct`` are set from.

    python3 port_bench/calibrate.py --workload <cell> --seconds <s> \\
        --seeds 1,2,...,12 --control-seeds 101,102,103

In one process, for each seed a whole run of the cell with a window of
``--seconds`` (its set-up, the loop at the cell's own load, the check),
untraced: the program's numbers over ``--seeds``, and over
``--control-seeds`` the control's, the reference in the nearest precision
below the configuration's in the program's place. Prints one JSON line a
run, then the summary: for each number the largest reading of the program,
the smallest of the control, and the configuration's limit. A limit lies
above the first and below the second.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def readings(workload: str, seeds, seconds: float, control: bool) \
        -> list[dict]:
    from port_bench.harness import run_cell
    out = []
    for seed in seeds:
        line = run_cell(workload, seed, seconds, False, control=control)
        out.append({"seed": seed, "control": control,
                    "correct": line["correct"],
                    "units": line["window"]["units"],
                    "numbers": {k: c["value"]
                                for k, c in line["checks"].items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def summary(program: list[dict], controls: list[dict], limits: dict) -> dict:
    names = sorted({n for r in program + controls for n in r["numbers"]})
    return {n: {"program_max": max((r["numbers"][n] for r in program),
                                   default=None),
                "control_min": min((r["numbers"][n] for r in controls),
                                   default=None),
                "limit": limits.get(n, 0)} for n in names}


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="port_bench/calibrate.py")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", required=True)
    args = parser.parse_args(argv)
    from port_bench import harness, spec
    here = spec.Pieces()
    bench = here.benchmark()
    cell = spec.cell(bench, args.workload)
    missing = harness.cards_missing(cell["chips"])
    if missing:
        print(f"calibrate: no run: {missing}", file=sys.stderr)
        return 2
    seeds = [int(s) for s in args.seeds.split(",")]
    cseeds = [int(s) for s in args.control_seeds.split(",")]
    program = readings(args.workload, seeds, args.seconds, False)
    controls = readings(args.workload, cseeds, args.seconds, True)
    limits = here.config(bench, cell["config"])["limits"]
    print(json.dumps({"summary": summary(program, controls, limits)}))
    return 0


if __name__ == "__main__":
    if not __package__:
        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
    sys.exit(main(sys.argv[1:]))
