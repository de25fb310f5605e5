"""Error-taxonomy pass.

Retry classification in the data plane is type-driven: callers catch
``TransientError``/``ThrottledError`` and back off, and everything else is
terminal.  A ``raise RuntimeError`` in ``relay/`` or ``kube/`` silently
opts out of that machinery, so:

- ``error-taxonomy-raise``: every exception class raised in
  ``tpu_operator_torch/relay/`` and ``tpu_operator_torch/kube/`` must derive from the
  ``KubeError`` tree.  Allowed outside the tree: caller-contract builtins
  (``ValueError``/``TypeError``/``KeyError``/``NotImplementedError``/
  ``AssertionError``), re-raising a caught/stored exception (``raise`` /
  ``raise e`` / ``raise obj.attr``), factory calls (lowercase names like
  ``_map_status(...)``), and module-private control-flow exceptions
  (``_StreamTorn`` — leading underscore, defined in the same module).
- ``error-swallow``: a broad ``except Exception:``/``except:`` handler
  whose body neither re-raises nor logs hides failures from operators and
  from the retry layer; narrow it, re-raise, or log.
"""

from __future__ import annotations

import ast

from ..core import Context, Finding, dotted_name, filter_findings

RULES = ("error-taxonomy-raise", "error-swallow")

SCAN_PREFIXES = ("tpu_operator_torch/relay", "tpu_operator_torch/kube")
TAXONOMY_ROOT = "KubeError"

_ALLOWED_BUILTINS = {"ValueError", "TypeError", "KeyError",
                     "NotImplementedError", "AssertionError",
                     "StopIteration", "TimeoutError"}


def taxonomy(ctx: Context, root: str = TAXONOMY_ROOT) -> set[str]:
    """Transitive subclasses of the taxonomy root across the package
    (classes are matched by name — the tree lives in ``kube/client.py``
    and every subclass names its base directly)."""
    bases: dict[str, set[str]] = {}
    for mod in ctx.modules("tpu_operator_torch"):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ClassDef):
                names = set()
                for b in node.bases:
                    d = dotted_name(b)
                    if d:
                        names.add(d.rsplit(".", 1)[-1])
                bases.setdefault(node.name, set()).update(names)
    known = {root}
    changed = True
    while changed:
        changed = False
        for cls, parents in bases.items():
            if cls not in known and parents & known:
                known.add(cls)
                changed = True
    return known


def _local_private_classes(mod) -> set[str]:
    return {n.name for n in ast.walk(mod.tree)
            if isinstance(n, ast.ClassDef) and n.name.startswith("_")}


def _raised_class_names(exc: ast.AST) -> list[tuple[str, int]]:
    """Class names this raise expression can instantiate.

    ``raise X(...)`` and ``raise X`` yield ``X`` when it looks like a
    class (leading capital, or ``_`` + capital); variables, attribute
    loads (``flight.error``), and lowercase factory calls yield nothing —
    we cannot type them, and in this codebase they re-raise stored or
    factory-built taxonomy errors.  ``or``-chains are checked per arm.
    """
    out: list[tuple[str, int]] = []
    if isinstance(exc, ast.BoolOp):
        for v in exc.values:
            out.extend(_raised_class_names(v))
        return out
    target = exc.func if isinstance(exc, ast.Call) else exc
    d = dotted_name(target)
    if d is None:
        return out
    name = d.rsplit(".", 1)[-1]
    looks_like_class = (name[:1].isupper()
                        or (name.startswith("_") and name[1:2].isupper()))
    if looks_like_class:
        out.append((name, exc.lineno))
    return out


def _handler_is_broad(handler: ast.ExceptHandler) -> bool:
    if handler.type is None:
        return True
    d = dotted_name(handler.type)
    return d in ("Exception", "BaseException")


def _body_reraises_or_logs(handler: ast.ExceptHandler) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            d = dotted_name(node.func) or ""
            head = d.split(".", 1)[0]
            if head in ("log", "logging", "logger", "warnings"):
                return True
            if ".log" in f".{d}":       # self.log.warning, cls._logger...
                return True
    return False


def run(ctx: Context) -> list[Finding]:
    tax = taxonomy(ctx)
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        mods[mod.path] = mod
        private = _local_private_classes(mod)
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Raise) and node.exc is not None:
                for name, line in _raised_class_names(node.exc):
                    if name in tax or name in _ALLOWED_BUILTINS:
                        continue
                    if name.startswith("_") and name in private:
                        continue
                    findings.append(Finding(
                        "error-taxonomy-raise", mod.path, line,
                        f"raise {name}(...) is outside the KubeError "
                        f"taxonomy — retry classification cannot see it; "
                        f"derive it from KubeError/TransientError"))
            elif isinstance(node, ast.ExceptHandler):
                if _handler_is_broad(node) and not _body_reraises_or_logs(
                        node):
                    findings.append(Finding(
                        "error-swallow", mod.path, node.lineno,
                        "broad except swallows the exception without "
                        "re-raise or log — narrow it, re-raise, or log"))
    return filter_findings(mods, findings)
