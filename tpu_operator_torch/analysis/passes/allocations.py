"""Hot-path allocation pass.

The relay data plane's memory discipline is that payload
bytes are touched zero times between submit and completion: donated
payloads ride through batch formation as ``memoryview`` segments and
batch outputs come back as refcounted slices of one arena lease.  A
single ``bytes(view)`` or ``a + b`` on a payload silently reintroduces
the per-request copy the arena exists to eliminate — and nothing fails,
it just gets slower.

Two rules, scanned over ``tpu_operator_torch/relay/``:

``payload-copy``: a call that materialises a copy of payload-ish data —
``bytes(...)``, ``bytearray(...)``, ``.copy()``, ``.tobytes()`` — where
an argument or the receiver is a payload-ish name (contains ``payload``,
``segment``, ``buf``, ``view``, or ``block``).

``payload-concat``: ``+`` / ``+=`` concatenation where either operand is
a payload-ish name (scatter-gather lists, never flattening).

Sanctioned copies (e.g. the non-donated staging path the e2e harness
A/Bs against) carry a same-line ``# gpucheck: ignore[payload-copy]``
suppression with a justification.
"""

from __future__ import annotations

import ast

from ..core import Context, Finding, filter_findings

RULES = ("payload-copy", "payload-concat")

SCAN_PREFIXES = ("tpu_operator_torch/relay",)

_COPY_CALLS = {"bytes", "bytearray"}
_COPY_METHODS = {"copy", "tobytes"}
_PAYLOADISH = ("payload", "segment", "buf", "view", "block")
# size/count arithmetic over payload names is fine — `payload_nbytes() +
# copied_bytes` adds integers, not buffers
_SIZEISH = ("nbytes", "bytes", "size", "len", "count", "offset")


def _name_of(node: ast.AST) -> str:
    """Best-effort dotted name for an expression (empty when anonymous)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _name_of(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    if isinstance(node, ast.Subscript):
        return _name_of(node.value)
    if isinstance(node, ast.Call):
        return _name_of(node.func)
    return ""


def _payloadish(node: ast.AST) -> bool:
    name = _name_of(node).lower()
    if not any(tok in name for tok in _PAYLOADISH):
        return False
    leaf = name.rsplit(".", 1)[-1]
    return not any(tok in leaf for tok in _SIZEISH)


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    mods = {}
    for mod in ctx.modules(*SCAN_PREFIXES):
        mods[mod.path] = mod
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Call):
                func = node.func
                if (isinstance(func, ast.Name)
                        and func.id in _COPY_CALLS
                        and any(_payloadish(a) for a in node.args)):
                    findings.append(Finding(
                        "payload-copy", mod.path, node.lineno,
                        f"{func.id}(...) materialises a copy of payload "
                        f"data on the relay hot path — pass the memoryview "
                        f"through, or lease from the arena"))
                elif (isinstance(func, ast.Attribute)
                        and func.attr in _COPY_METHODS
                        and _payloadish(func.value)):
                    findings.append(Finding(
                        "payload-copy", mod.path, node.lineno,
                        f".{func.attr}() copies payload data on the relay "
                        f"hot path — slice the existing buffer instead"))
            elif (isinstance(node, ast.BinOp)
                    and isinstance(node.op, ast.Add)
                    and (_payloadish(node.left) or _payloadish(node.right))):
                findings.append(Finding(
                    "payload-concat", mod.path, node.lineno,
                    "+ concatenation of payload data allocates a merged "
                    "buffer — keep the scatter-gather segment list"))
            elif (isinstance(node, ast.AugAssign)
                    and isinstance(node.op, ast.Add)
                    and (_payloadish(node.target)
                         or _payloadish(node.value))):
                findings.append(Finding(
                    "payload-concat", mod.path, node.lineno,
                    "+= concatenation of payload data allocates a merged "
                    "buffer — keep the scatter-gather segment list"))
    return filter_findings(mods, findings)
