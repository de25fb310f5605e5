"""Clock-discipline pass.

Modules that declare an injectable ``clock=`` parameter have opted into
the virtual-time test contract (relay/, ``health/hysteresis.py``,
``utils/trace.py``, ...): every timestamp they take must come through the
injected clock, or the chaos/e2e harnesses silently mix wall time into
virtual time and the deterministic replays stop being deterministic.

Rule ``clock-direct-call``: inside such a module, a direct call to
``time.time()`` / ``time.monotonic()`` / ``time.perf_counter()`` /
``datetime.now()`` (and ``_ns``/``utcnow`` variants) is an error.  The
default parameter itself (``clock=time.monotonic``) is a function
*reference*, not a call, so it is naturally allowed.  ``time.sleep`` is
pacing, not a clock read, and is the lock pass's concern.

Scope: ``tpu_operator_torch/`` excluding ``cli/`` and ``e2e/`` — binaries'
main loops and harness entry points legitimately run on wall time even
though they *construct* clock-parameterized components.
"""

from __future__ import annotations

import ast

from ..core import Context, Finding, dotted_name, filter_findings

RULES = ("clock-direct-call",)

SCAN_PREFIXES = ("tpu_operator_torch",)
EXCLUDE_PREFIXES = ("tpu_operator_torch/cli/", "tpu_operator_torch/e2e/",
                    "tpu_operator_torch/analysis/")

_CLOCK_CALLS = {
    "time.time", "time.monotonic", "time.perf_counter",
    "time.time_ns", "time.monotonic_ns", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow",
    "datetime.datetime.now", "datetime.datetime.utcnow",
}


def _declares_clock(tree: ast.AST) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            a = node.args
            for arg in (a.posonlyargs + a.args + a.kwonlyargs):
                if arg.arg == "clock":
                    return True
    return False


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        if mod.path.startswith(EXCLUDE_PREFIXES):
            continue
        if not _declares_clock(mod.tree):
            continue
        mods[mod.path] = mod
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            dotted = dotted_name(node.func)
            if dotted in _CLOCK_CALLS:
                findings.append(Finding(
                    "clock-direct-call", mod.path, node.lineno,
                    f"direct {dotted}() in a module with an injectable "
                    f"clock= — route it through the injected clock so "
                    f"virtual-time tests stay deterministic"))
    return filter_findings(mods, findings)
