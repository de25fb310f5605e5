"""The benchmark of ``tpu_operator_torch``, the PyTorch and CUDA package.

One run measures one cell of ``BENCHMARK.json`` (a configuration under a
traffic mix) on the cards of the machine it starts on, and prints one JSON
line::

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name, so a new cell, configuration, traffic mix or
metric is new files and entries, never an edit:

- the cells and metrics: ``BENCHMARK.json`` at the root of the checkout;
- a configuration: ``configs/<config>.json`` (its sizes, the entry that
  drives the program, and the limits of the comparison that decides
  ``correct``);
- a traffic mix: ``traffic/<traffic>.json``, parameters that the general
  loop in :mod:`port_bench.harness` reads, its pacing among them;
- an entry: ``entries/<entry>.py``, which builds the system under test
  from a configuration and runs one unit of its work;
- a metric: ``metrics/<metric>.py``, a reader of the run's record;
- the plain references and their lower-precision controls:
  ``reference/``.

Nothing here imports JAX or the JAX package: :mod:`port_bench.guard`
checks it before the program loads and again before the result prints.
"""
