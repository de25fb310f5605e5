"""Pump allocation-discipline pass.

The relay pump is the single-replica throughput ceiling: every object the
interpreter allocates per request inside ``pump()`` / ``_form`` / ``_run``
is pure overhead multiplied by the request rate — and the columnar
scheduling core (relay/sched_core.py) exists precisely so the pump's
decisions are array passes, not per-request container churn. This pass
keeps it that way:

- ``pump-comprehension``: a list/set/dict comprehension inside the call
  tree of a pump root — each evaluation builds a fresh container sized by
  its input, i.e. a per-request allocation when the input is the batch or
  the backlog. Generator expressions are NOT flagged: they stream without
  materializing.
- ``pump-fresh-append``: ``.append`` onto a local name bound to a fresh
  container (a ``[]``/``{}``-style literal, an empty ``list()`` /
  ``dict()`` / ``set()`` call, or a comprehension) in the same function —
  the accumulate-into-a-new-list idiom the in-place compaction in
  ``ContinuousScheduler._form`` replaces. Appending to an *attribute*
  (e.g. the bounded ``self.last_sizes`` deque) is bookkeeping, not a
  per-request allocation, and stays legal; so does ``list(x)`` — a copy
  the author asked for by name.

Roots are functions named exactly ``pump``, ``_form``, or ``_run`` in
``tpu_operator_torch/relay/`` modules; the tree follows same-module calls
(``self.method()`` and bare local names), the same intentionally
intra-module resolution as the locks pass — every pump hot path in this
codebase lives in one file, and staying intra-module keeps false
positives at zero so ``make -C tpu_operator_torch lint-invariants`` can
gate CI. A justified
exception carries ``# gpucheck: ignore[pump-comprehension] -- why`` on
the offending line.
"""

from __future__ import annotations

import ast

from ..core import Context, Finding, filter_findings

RULES = ("pump-comprehension", "pump-fresh-append")

SCAN_PREFIXES = ("tpu_operator_torch/relay",)

_ROOT_NAMES = ("pump", "_form", "_run")

_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp)
_COMP_LABEL = {ast.ListComp: "list", ast.SetComp: "set",
               ast.DictComp: "dict"}
_FRESH_CALLS = ("list", "dict", "set")


def _is_fresh_container(value: ast.AST) -> bool:
    """Does this expression build a brand-new container?"""
    if isinstance(value, (ast.List, ast.Dict, ast.Set)):
        return True
    if isinstance(value, _COMPREHENSIONS):
        return True
    if (isinstance(value, ast.Call) and isinstance(value.func, ast.Name)
            and value.func.id in _FRESH_CALLS
            and not value.args and not value.keywords):
        return True     # empty list()/dict()/set(); list(x) is a copy-by-name
    return False


class _ModulePump:
    """Per-module root discovery, call-tree closure, and body checks."""

    def __init__(self, mod):
        self.mod = mod
        self.funcs: dict[str, ast.FunctionDef] = {}
        self.func_class: dict[str, str | None] = {}
        self.findings: list[Finding] = []
        self._collect()

    def _collect(self):
        for cls in [n for n in ast.walk(self.mod.tree)
                    if isinstance(n, ast.ClassDef)]:
            for item in cls.body:
                if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    key = f"{cls.name}.{item.name}"
                    self.funcs[key] = item
                    self.func_class[key] = cls.name
        for item in self.mod.tree.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.funcs[item.name] = item
                self.func_class[item.name] = None

    def _local_callee(self, call: ast.Call, cls: str | None) -> str | None:
        if (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self" and cls):
            key = f"{cls}.{call.func.attr}"
            return key if key in self.funcs else None
        if isinstance(call.func, ast.Name) and call.func.id in self.funcs:
            return call.func.id
        return None

    def analyze(self):
        roots = [k for k in self.funcs
                 if k.rsplit(".", 1)[-1] in _ROOT_NAMES]
        # closure over same-module calls; remember which root reached each
        # function first so the finding names the hot path it sits on
        via: dict[str, str] = {r: r for r in roots}
        work = list(roots)
        while work:
            fkey = work.pop()
            cls = self.func_class[fkey]
            for node in ast.walk(self.funcs[fkey]):
                if not isinstance(node, ast.Call):
                    continue
                callee = self._local_callee(node, cls)
                if callee is not None and callee not in via:
                    via[callee] = via[fkey]
                    work.append(callee)
        for fkey, root in via.items():
            self._check(fkey, root)

    def _check(self, fkey: str, root: str):
        fn = self.funcs[fkey]
        fresh: set[str] = set()
        for node in ast.walk(fn):
            targets = ()
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = (node.target,)
            if targets and _is_fresh_container(node.value):
                for tgt in targets:
                    if isinstance(tgt, ast.Name):
                        fresh.add(tgt.id)
        where = fkey if fkey == root else f"{fkey} (reached from {root})"
        for node in ast.walk(fn):
            if isinstance(node, _COMPREHENSIONS):
                self.findings.append(Finding(
                    "pump-comprehension", self.mod.path, node.lineno,
                    f"{_COMP_LABEL[type(node)]} comprehension in pump hot "
                    f"path {where}() — materializes a fresh container per "
                    f"evaluation; restructure as an in-place pass or a "
                    f"streaming generator"))
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "append"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id in fresh):
                self.findings.append(Finding(
                    "pump-fresh-append", self.mod.path, node.lineno,
                    f"append onto fresh container "
                    f"'{node.func.value.id}' in pump hot path {where}() — "
                    f"accumulating a new list per turn allocates per "
                    f"request; reuse a preallocated buffer or compact in "
                    f"place"))


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        analysis = _ModulePump(mod)
        analysis.analyze()
        findings.extend(analysis.findings)
        mods[mod.path] = mod
    return filter_findings(mods, findings)
