"""Lock-discipline pass.

Builds a per-module lock-acquisition graph and flags:

- ``lock-blocking-call``: a known-blocking call (``time.sleep``,
  ``subprocess.*``, socket/HTTP dials, ``Future.result()``) made while a
  ``threading.Lock``/``RLock`` is held — directly, or through a call to a
  same-module function whose body (transitively) blocks.
- ``lock-nested-acquire``: re-acquiring a non-reentrant ``threading.Lock``
  already held on the current path (self-deadlock).
- ``lock-order-inversion``: two locks acquired in both orders somewhere in
  the module (the classic AB/BA deadlock shape).

The analysis is intentionally intra-module: every threaded component in
this codebase (pool, cache, batcher, scheduler, router, incluster client)
keeps its locks private to one file, so cross-module aliasing is not a
shape that occurs — and staying intra-module keeps false positives at
zero, which is what lets ``make -C tpu_operator_torch lint-invariants``
gate CI.

Lock identity is ``ClassName.attr`` for ``self.attr = threading.Lock()``
and the bare name for module/function-level locks, so two classes in one
file that each name their lock ``_lock`` do not alias.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from ..core import Context, Finding, dotted_name, filter_findings

RULES = ("lock-blocking-call", "lock-nested-acquire", "lock-order-inversion")

SCAN_PREFIXES = ("tpu_operator_torch",)

# dotted-prefix → human label for the report
_BLOCKING_PREFIXES = (
    ("time.sleep", "time.sleep"),
    ("subprocess.", "subprocess"),
    ("socket.create_connection", "socket dial"),
    ("socket.socket", "socket"),
    ("requests.", "HTTP request"),
    ("urllib.request.", "HTTP request"),
    ("http.client.", "HTTP request"),
)

_LOCK_CTORS = {"threading.Lock": "Lock", "threading.RLock": "RLock",
               "Lock": "Lock", "RLock": "RLock"}


def _blocking_label(dotted: str | None) -> str | None:
    if dotted is None:
        return None
    for prefix, label in _BLOCKING_PREFIXES:
        if dotted == prefix or (prefix.endswith(".")
                                and dotted.startswith(prefix)):
            return label
    return None


@dataclass
class _FuncSummary:
    """What a function does that matters to a caller holding a lock."""
    acquires: set = field(default_factory=set)          # lock keys
    blocking: dict = field(default_factory=dict)        # desc -> line
    calls: set = field(default_factory=set)             # local callee keys


class _ModuleLocks:
    """Per-module lock table + function summaries + acquisition edges."""

    def __init__(self, mod):
        self.mod = mod
        self.locks: dict[str, str] = {}     # key -> "Lock" | "RLock"
        self.funcs: dict[str, ast.FunctionDef] = {}
        self.func_class: dict[str, str | None] = {}
        self.summaries: dict[str, _FuncSummary] = {}
        self.edges: dict[tuple, int] = {}   # (outer, inner) -> first line
        self.findings: list[Finding] = []
        self._collect()

    # -- discovery --------------------------------------------------------
    def _collect(self):
        for node in ast.walk(self.mod.tree):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                kind = _LOCK_CTORS.get(dotted_name(node.value.func) or "")
                if not kind:
                    continue
                for tgt in node.targets:
                    key = self._target_key(tgt, node)
                    if key:
                        self.locks[key] = kind
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

    def _target_key(self, tgt: ast.AST, assign: ast.Assign) -> str | None:
        if (isinstance(tgt, ast.Attribute)
                and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self"):
            cls = self._enclosing_class(assign)
            return f"{cls}.{tgt.attr}" if cls else tgt.attr
        if isinstance(tgt, ast.Name):
            return tgt.id
        return None

    def _enclosing_class(self, node: ast.AST) -> str | None:
        # cheap parent walk: find the ClassDef whose subtree contains node
        for cls in ast.walk(self.mod.tree):
            if isinstance(cls, ast.ClassDef):
                for sub in ast.walk(cls):
                    if sub is node:
                        return cls.name
        return None

    def _lock_key(self, expr: ast.AST, cls: str | None) -> str | None:
        """Resolve an expression to a known lock key, if any."""
        if (isinstance(expr, ast.Attribute)
                and isinstance(expr.value, ast.Name)
                and expr.value.id == "self" and cls):
            key = f"{cls}.{expr.attr}"
            return key if key in self.locks else None
        if isinstance(expr, ast.Name) and expr.id in self.locks:
            return expr.id
        return None

    # -- per-function walk ------------------------------------------------
    def analyze(self):
        for key, fn in self.funcs.items():
            self.summaries[key] = _FuncSummary()
        for key, fn in self.funcs.items():
            self._walk_body(fn.body, held=[], fkey=key)
        self._propagate()
        for key, fn in self.funcs.items():
            self._walk_body(fn.body, held=[], fkey=key, report=True)
        self._report_inversions()

    def _walk_body(self, stmts, held: list, fkey: str, report=False):
        cls = self.func_class[fkey]
        for stmt in stmts:
            if isinstance(stmt, ast.With):
                pushed = []
                for item in stmt.items:
                    lk = self._lock_key(item.context_expr, cls)
                    if lk:
                        self._on_acquire(lk, held, stmt.lineno, fkey, report)
                        pushed.append(lk)
                        held = held + [lk]
                # scan the `with` header expressions for blocking calls too
                for item in stmt.items:
                    self._scan_expr(item.context_expr, held[:len(held)
                                    - len(pushed)] if pushed else held,
                                    fkey, report, skip_lock=True)
                self._walk_body(stmt.body, held, fkey, report)
                held = held[:len(held) - len(pushed)]
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue   # nested defs are analyzed as their own unit only
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test, held, fkey, report)
                self._walk_body(stmt.body, held, fkey, report)
                self._walk_body(stmt.orelse, held, fkey, report)
            elif isinstance(stmt, ast.For):
                self._scan_expr(stmt.iter, held, fkey, report)
                self._walk_body(stmt.body, held, fkey, report)
                self._walk_body(stmt.orelse, held, fkey, report)
            elif isinstance(stmt, ast.Try):
                self._walk_body(stmt.body, held, fkey, report)
                for h in stmt.handlers:
                    self._walk_body(h.body, held, fkey, report)
                self._walk_body(stmt.orelse, held, fkey, report)
                self._walk_body(stmt.finalbody, held, fkey, report)
            else:
                self._scan_stmt_exprs(stmt, held, fkey, report)
                # linear acquire()/release() tracking inside one block
                rel = self._release_target(stmt, cls)
                if rel and rel in held:
                    held.remove(rel)
                acq = self._acquire_target(stmt, cls)
                if acq:
                    self._on_acquire(acq, held, stmt.lineno, fkey, report)
                    held.append(acq)

    def _acquire_target(self, stmt, cls) -> str | None:
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "acquire"):
            return self._lock_key(stmt.value.func.value, cls)
        return None

    def _release_target(self, stmt, cls) -> str | None:
        if (isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call)
                and isinstance(stmt.value.func, ast.Attribute)
                and stmt.value.func.attr == "release"):
            return self._lock_key(stmt.value.func.value, cls)
        return None

    def _on_acquire(self, lock: str, held: list, line: int, fkey: str,
                    report: bool):
        self.summaries[fkey].acquires.add(lock)
        for outer in held:
            self.edges.setdefault((outer, lock), line)
        if lock in held and self.locks[lock] == "Lock" and report:
            self.findings.append(Finding(
                "lock-nested-acquire", self.mod.path, line,
                f"non-reentrant lock '{lock}' acquired while already held "
                f"(self-deadlock); use RLock or restructure"))

    def _scan_stmt_exprs(self, stmt, held, fkey, report):
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                self._scan_expr(node, held, fkey, report, walk=False)

    def _scan_expr(self, node, held, fkey, report, skip_lock=False,
                   walk=True):
        calls = ([n for n in ast.walk(node) if isinstance(n, ast.Call)]
                 if walk else [node] if isinstance(node, ast.Call) else [])
        cls = self.func_class[fkey]
        for call in calls:
            dotted = dotted_name(call.func)
            label = _blocking_label(dotted)
            if label:
                self.summaries[fkey].blocking.setdefault(label, call.lineno)
                if held and report:
                    self.findings.append(Finding(
                        "lock-blocking-call", self.mod.path, call.lineno,
                        f"blocking call ({label}) while holding "
                        f"{', '.join(held)}"))
                continue
            if (isinstance(call.func, ast.Attribute)
                    and call.func.attr == "result"
                    and not call.args and not call.keywords):
                self.summaries[fkey].blocking.setdefault("Future.result()",
                                                         call.lineno)
                if held and report:
                    self.findings.append(Finding(
                        "lock-blocking-call", self.mod.path, call.lineno,
                        f"Future.result() while holding {', '.join(held)}"))
                continue
            callee = self._local_callee(call, cls)
            if callee:
                self.summaries[fkey].calls.add(callee)
                if held and report:
                    summ = self.summaries.get(callee)
                    if summ and summ.blocking:
                        desc, line = next(iter(summ.blocking.items()))
                        self.findings.append(Finding(
                            "lock-blocking-call", self.mod.path, call.lineno,
                            f"call to {callee}() which may block ({desc} at "
                            f"line {line}) while holding {', '.join(held)}"))
                    if summ:
                        for m in summ.acquires:
                            for outer in held:
                                self.edges.setdefault((outer, m),
                                                      call.lineno)
                            if (m in held and self.locks[m] == "Lock"):
                                self.findings.append(Finding(
                                    "lock-nested-acquire", self.mod.path,
                                    call.lineno,
                                    f"call to {callee}() re-acquires "
                                    f"non-reentrant lock '{m}' already "
                                    f"held here"))

    def _local_callee(self, call: ast.Call, cls: str | None) -> str | None:
        if (isinstance(call.func, ast.Attribute)
                and isinstance(call.func.value, ast.Name)
                and call.func.value.id == "self" and cls):
            key = f"{cls}.{call.func.attr}"
            return key if key in self.funcs else None
        if isinstance(call.func, ast.Name) and call.func.id in self.funcs:
            return call.func.id
        return None

    # -- cross-function fixed point ---------------------------------------
    def _propagate(self):
        for _ in range(len(self.funcs) + 1):
            changed = False
            for key, summ in self.summaries.items():
                for callee in summ.calls:
                    csum = self.summaries.get(callee)
                    if csum is None:
                        continue
                    before = (len(summ.blocking), len(summ.acquires))
                    for desc, line in csum.blocking.items():
                        summ.blocking.setdefault(f"via {callee}: {desc}",
                                                 line)
                    summ.acquires |= csum.acquires
                    if (len(summ.blocking), len(summ.acquires)) != before:
                        changed = True
            if not changed:
                break

    def _report_inversions(self):
        seen = set()
        for (a, b), line in sorted(self.edges.items(),
                                   key=lambda kv: kv[1]):
            if a == b or (b, a) not in self.edges:
                continue
            pair = tuple(sorted((a, b)))
            if pair in seen:
                continue
            seen.add(pair)
            other = self.edges[(b, a)]
            self.findings.append(Finding(
                "lock-order-inversion", self.mod.path, min(line, other),
                f"lock-order inversion: '{a}' -> '{b}' at line {line} but "
                f"'{b}' -> '{a}' at line {other}; pick one global order"))


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        if mod.path.startswith("tpu_operator_torch/analysis/"):
            continue
        analysis = _ModuleLocks(mod)
        if not analysis.locks:
            continue
        analysis.analyze()
        findings.extend(analysis.findings)
        mods[mod.path] = mod
    return filter_findings(mods, findings)
