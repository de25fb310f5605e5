"""Shared AST-walk core for gpucheck passes.

A pass is a function ``run(ctx: Context) -> list[Finding]``.  The core owns
the pieces every pass needs: parsed-module caching, repo-relative paths,
inline suppressions, and the checked-in baseline file.

Suppression syntax (on the flagged line or the line directly above)::

    x = time.time()  # gpucheck: ignore[clocks] -- boot banner, not logic

The justification after ``--`` is required by convention (code review
rejects bare ignores); the analyzer only parses the rule list.

The baseline file (``tpu_operator_torch/gpucheck-baseline.json``) exists
so the tool could be introduced into a codebase with pre-existing
findings; this repo fixes its violations instead, so the shipped baseline
is empty and ``tests/test_torch_analysis.py`` pins it empty.
"""

from __future__ import annotations

import ast
import json
import os
import re
from dataclasses import dataclass

BASELINE_NAME = "tpu_operator_torch/gpucheck-baseline.json"

_SUPPRESS_RE = re.compile(r"#\s*gpucheck:\s*ignore\[([a-zA-Z0-9_,\- ]+)\]")

# directories never worth parsing (build output, VCS, caches)
_SKIP_DIRS = {".git", "__pycache__", "build", ".pytest_cache", "node_modules",
              ".venv", "venv"}


@dataclass(frozen=True)
class Finding:
    """One rule violation at a location."""
    rule: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def baseline_key(self) -> tuple:
        # line-insensitive so unrelated edits above a baselined finding
        # don't resurrect it
        return (self.rule, self.path, self.message)


class Module:
    """A parsed source file: text, line list, AST, suppression map."""

    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._suppressed: dict[int, set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = _SUPPRESS_RE.search(line)
            if m:
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
                self._suppressed[i] = rules

    def suppressed(self, rule: str, line: int) -> bool:
        for at in (line, line - 1):
            rules = self._suppressed.get(at)
            if rules and (rule in rules or "all" in rules):
                return True
        return False


class Context:
    """Analysis context rooted at a repo checkout (or a test fixture dir).

    ``modules(prefix, ...)`` yields parsed ``Module`` objects for every
    ``.py`` file under the given repo-relative prefixes, cached across
    passes.  Files that fail to parse produce a ``syntax`` finding instead
    of raising (collected in ``parse_failures``).
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._cache: dict[str, Module] = {}
        self.parse_failures: list[Finding] = []
        self._listed: dict[str, list[str]] = {}

    # -- files ------------------------------------------------------------
    def exists(self, relpath: str) -> bool:
        return os.path.exists(os.path.join(self.root, relpath))

    def read(self, relpath: str) -> str:
        with open(os.path.join(self.root, relpath)) as f:
            return f.read()

    def _walk_py(self, prefix: str) -> list[str]:
        if prefix in self._listed:
            return self._listed[prefix]
        out: list[str] = []
        base = os.path.join(self.root, prefix)
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    out.append(os.path.relpath(full, self.root)
                               .replace(os.sep, "/"))
        self._listed[prefix] = out
        return out

    def module(self, relpath: str) -> Module | None:
        if relpath in self._cache:
            return self._cache[relpath]
        full = os.path.join(self.root, relpath)
        if not os.path.exists(full):
            return None
        try:
            mod = Module(relpath, open(full).read())
        except SyntaxError as e:
            self.parse_failures.append(Finding(
                "syntax", relpath, e.lineno or 1,
                f"failed to parse: {e.msg}"))
            return None
        self._cache[relpath] = mod
        return mod

    def modules(self, *prefixes: str) -> list[Module]:
        out = []
        for prefix in prefixes:
            if not os.path.isdir(os.path.join(self.root, prefix)):
                continue
            for rel in self._walk_py(prefix):
                mod = self.module(rel)
                if mod is not None:
                    out.append(mod)
        return out


# -- shared AST helpers ----------------------------------------------------

def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for Name/Attribute chains, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def filter_findings(mods_by_path: dict[str, Module],
                    findings: list[Finding]) -> list[Finding]:
    """Drop findings suppressed by inline ``# gpucheck: ignore[...]``."""
    out = []
    for f in findings:
        mod = mods_by_path.get(f.path)
        if mod is not None and mod.suppressed(f.rule, f.line):
            continue
        out.append(f)
    return out


# -- baseline --------------------------------------------------------------

def load_baseline(path: str) -> set[tuple]:
    """Baseline keys from the baseline file ({} / missing = empty)."""
    if not os.path.exists(path):
        return set()
    data = json.load(open(path))
    out = set()
    for entry in data.get("findings", []):
        out.add((entry["rule"], entry["path"], entry["message"]))
    return out


def apply_baseline(findings: list[Finding],
                   baseline: set[tuple]) -> list[Finding]:
    return [f for f in findings if f.baseline_key() not in baseline]
