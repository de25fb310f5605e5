"""Seeded-randomness pass.

Every chaos schedule, fault-injection sweep, and benchmark workload in
this repo is reproducible because it draws from an explicitly seeded
``random.Random(seed)`` instance.  One ``random.random()`` against the
module-level RNG breaks replayability of the exact run that failed.

Rule ``unseeded-random``: in ``tpu_operator_torch/e2e/`` and ``tests/``, any
call through the module-level ``random.*`` API is an error (construct
``random.Random(seed)`` / ``random.SystemRandom()`` instead — those two
constructors are the allowed exceptions).  ``jax.random`` is untouched:
the receiver must be the bare name ``random``.
"""

from __future__ import annotations

import ast

from ..core import Context, Finding, filter_findings

RULES = ("unseeded-random",)

SCAN_PREFIXES = ("tpu_operator_torch/e2e", "tests", "e2e")

_ALLOWED_ATTRS = {"Random", "SystemRandom"}


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        mods[mod.path] = mod
        for node in ast.walk(mod.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "random"
                    and node.func.attr not in _ALLOWED_ATTRS):
                findings.append(Finding(
                    "unseeded-random", mod.path, node.lineno,
                    f"random.{node.func.attr}() uses the unseeded "
                    f"module-level RNG — draw from random.Random(seed) so "
                    f"the run is replayable"))
    return filter_findings(mods, findings)
