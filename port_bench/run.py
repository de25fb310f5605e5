"""Run one cell of the benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> \\
        --seconds <s> --trace <0|1>

(or ``python3 -m port_bench.run ...``) from the root of a checkout on a
machine with the cards the cell asks for. Exits 0 with one JSON line last
on standard output, or non-zero with no result: no card, too few cards,
a forbidden import, a missing piece, or a crash.
"""

import os
import sys
import time

T_START = time.perf_counter()

if __name__ == "__main__":
    if not __package__:
        # run as a script: the checkout's root, not this folder, goes first
        sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
            __file__)))
    from port_bench.harness import main
    sys.exit(main(sys.argv[1:], T_START))
