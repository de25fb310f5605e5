"""Label selector matching (equality- and set-based), kubectl grammar subset.

The port's copy of ``tpu_operator/kube/selectors.py``, which uses no device:
the port imports nothing of the JAX package, so it keeps its own, and
``tests/test_torch_kube_copy.py`` holds the two equal on the same inputs.

Supports: ``k=v``, ``k==v``, ``k!=v``, ``k``, ``!k``, ``k in (a,b)``,
``k notin (a,b)`` joined by commas — the forms the operator itself uses for
workload/deploy labels (reference analogue: k8s.io/apimachinery labels).
"""

from __future__ import annotations

import re

_IN_RE = re.compile(r"^\s*([\w./-]+)\s+(in|notin)\s+\(([^)]*)\)\s*$")


def _split_terms(selector: str) -> list[str]:
    """Split on commas not inside parentheses."""
    terms, depth, cur = [], 0, []
    for ch in selector:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            terms.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        terms.append("".join(cur))
    return [t.strip() for t in terms if t.strip()]


def parse_selector(selector: str) -> list[tuple[str, str, list[str]]]:
    """Parse into (key, op, values) triples; op in {=, !=, in, notin, exists, !}."""
    out = []
    for term in _split_terms(selector):
        m = _IN_RE.match(term)
        if m:
            key, op, vals = m.groups()
            out.append((key, op, [v.strip() for v in vals.split(",") if v.strip()]))
        elif "!=" in term:
            k, v = term.split("!=", 1)
            out.append((k.strip(), "!=", [v.strip()]))
        elif "==" in term:
            k, v = term.split("==", 1)
            out.append((k.strip(), "=", [v.strip()]))
        elif "=" in term:
            k, v = term.split("=", 1)
            out.append((k.strip(), "=", [v.strip()]))
        elif term.startswith("!"):
            out.append((term[1:].strip(), "!", []))
        else:
            out.append((term, "exists", []))
    return out


def match_node_affinity(labels: dict | None, pod_spec: dict | None) -> bool:
    """Does a node with ``labels`` satisfy the pod spec's REQUIRED node
    affinity? (requiredDuringSchedulingIgnoredDuringExecution only — the
    subset the operator emits for the libtpu fan-out carve-out.)

    nodeSelectorTerms are OR-ed; matchExpressions within a term are AND-ed,
    matching the real scheduler semantics."""
    terms = (((pod_spec or {}).get("affinity") or {})
             .get("nodeAffinity", {})
             .get("requiredDuringSchedulingIgnoredDuringExecution", {})
             .get("nodeSelectorTerms"))
    if not terms:
        return True
    labels = labels or {}

    def expr_ok(e: dict) -> bool:
        key, op = e.get("key"), e.get("operator")
        vals = e.get("values") or []
        val, have = labels.get(key), key in labels
        return {"In": val in vals, "NotIn": val not in vals,
                "Exists": have, "DoesNotExist": not have}.get(op, False)

    return any(all(expr_ok(e) for e in (t.get("matchExpressions") or []))
               for t in terms)


def match_labels(labels: dict | None, selector: str | dict | None) -> bool:
    """Does ``labels`` satisfy ``selector``?

    ``selector`` may be a kubectl-style string or a matchLabels dict.
    """
    if selector in (None, "", {}):
        return True
    labels = labels or {}
    if isinstance(selector, dict):
        return all(labels.get(k) == v for k, v in selector.items())
    for key, op, values in parse_selector(selector):
        have = key in labels
        val = labels.get(key)
        if op == "=" and val != values[0]:
            return False
        if op == "!=" and val == values[0]:
            return False
        if op == "in" and val not in values:
            return False
        if op == "notin" and val in values:
            return False
        if op == "exists" and not have:
            return False
        if op == "!" and have:
            return False
    return True
