"""Metrics ⇄ docs ⇄ dashboards pass.

``docs/metrics.md`` is the operator's observability contract and the
Grafana dashboards under ``docs/dashboards/`` are its query surface; both
drift the moment a family is added or renamed unless a machine checks
them.  This pass folds the cross-check direction of
``tests/test_torch_metrics_docs.py`` into gpucheck so the same CLI a
developer runs locally (``make -C tpu_operator_torch lint-invariants``)
validates it; the pytest file
delegates here and keeps only its exact-name pins.

Rules:

- ``metrics-doc-missing``: a registered family has no row in its
  section of docs/metrics.md.
- ``metrics-doc-stale``: a documented family is no longer registered.
- ``metrics-doc-leak``: a family documented in the wrong section
  (relay rows in the Operator table, router rows in the Relay service
  table) — each section is pinned to exactly one registry.
- ``metrics-dashboard-query``: a dashboard JSON fails to parse or
  queries a family no registry provides (suffix-aware: ``_bucket``/
  ``_sum``/``_count`` expand from histograms).
"""

from __future__ import annotations

import glob
import json
import os
import re

from ..core import Context, Finding

RULES = ("metrics-doc-missing", "metrics-doc-stale", "metrics-doc-leak",
         "metrics-dashboard-query")

DOC = "tpu_operator_torch/docs/metrics.md"
DASHBOARDS = "tpu_operator_torch/docs/dashboards"


# -- registry + doc helpers (imported by tests/test_torch_metrics_docs.py)

def _families(metrics_cls) -> set[str]:
    from tpu_operator_torch.utils.prom import Registry
    reg = Registry()
    metrics_cls(registry=reg)
    return {m.name for m in reg.families()}


def registered_operator_families() -> set[str]:
    from tpu_operator_torch.controllers.metrics import OperatorMetrics
    return _families(OperatorMetrics)


def registered_health_families() -> set[str]:
    from tpu_operator_torch.health.monitor import HealthMonitorMetrics
    return _families(HealthMonitorMetrics)


def registered_relay_families() -> set[str]:
    from tpu_operator_torch.relay import RelayMetrics
    return _families(RelayMetrics)


def registered_router_families() -> set[str]:
    from tpu_operator_torch.relay import RouterMetrics
    return _families(RouterMetrics)


def registered_federation_families() -> set[str]:
    from tpu_operator_torch.relay import FederationMetrics
    return _families(FederationMetrics)


def section(text: str, title: str) -> tuple[str, int] | None:
    """(section body, heading line) for ``## <title>`` in metrics.md."""
    m = re.search(rf"^## {re.escape(title)}\b.*?(?=^## )", text,
                  re.M | re.S)
    if not m:
        return None
    return m.group(0), text[:m.start()].count("\n") + 1


def documented(section_text: str, prefix: str) -> set[str]:
    # backticked names only; labels/suffixes inside the backticks stop at
    # the brace
    return set(re.findall(rf"`({re.escape(prefix)}[a-z0-9_]+)",
                          section_text))


# (section title, doc prefix, registry loader)
SECTIONS = (
    ("Operator", "gpu_operator_", registered_operator_families),
    ("Health monitor", "gpu_health_", registered_health_families),
    ("Relay service", "gpu_operator_relay_", registered_relay_families),
    ("Relay router", "gpu_operator_relay_router_",
     registered_router_families),
    ("Relay federation", "gpu_operator_relay_fed_",
     registered_federation_families),
)

# (section whose table must NOT contain the prefix, leaked prefix)
LEAKS = (("Operator", "gpu_operator_relay_"),
         ("Relay service", "gpu_operator_relay_router_"),
         ("Relay service", "gpu_operator_relay_fed_"),
         ("Relay router", "gpu_operator_relay_fed_"))


def run(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    if not ctx.exists(DOC):
        return [Finding("metrics-doc-missing", DOC, 1,
                        f"{DOC} is missing")]
    text = ctx.read(DOC)

    for title, prefix, loader in SECTIONS:
        sec = section(text, title)
        if sec is None:
            findings.append(Finding(
                "metrics-doc-missing", DOC, 1,
                f"{DOC} lost its '## {title}' section"))
            continue
        body, line = sec
        doc = documented(body, prefix)
        reg = loader()
        for fam in sorted(reg - doc):
            findings.append(Finding(
                "metrics-doc-missing", DOC, line,
                f"registered family {fam} has no row in '## {title}' — "
                f"add a table row"))
        for fam in sorted(doc - reg):
            findings.append(Finding(
                "metrics-doc-stale", DOC, line,
                f"'## {title}' documents {fam} but no registry provides "
                f"it — drop the row or restore the metric"))

    for title, leaked in LEAKS:
        sec = section(text, title)
        if sec is None:
            continue
        body, line = sec
        if re.findall(rf"`{re.escape(leaked)}", body):
            findings.append(Finding(
                "metrics-doc-leak", DOC, line,
                f"'## {title}' documents {leaked}* families that belong "
                f"to another section's registry"))

    findings.extend(_check_dashboards(ctx))
    return findings


def _check_dashboards(ctx: Context) -> list[Finding]:
    findings: list[Finding] = []
    dash_dir = os.path.join(ctx.root, DASHBOARDS)
    real: set[str] = set()
    for _, _, loader in SECTIONS:
        real |= loader()
    suffixed = real | {f"{m}{s}" for m in real
                       for s in ("_bucket", "_sum", "_count")}
    for path in sorted(glob.glob(os.path.join(dash_dir, "*.json"))):
        rel = os.path.relpath(path, ctx.root).replace(os.sep, "/")
        try:
            doc = json.load(open(path))
        except ValueError as e:
            findings.append(Finding("metrics-dashboard-query", rel, 1,
                                    f"dashboard JSON fails to parse: {e}"))
            continue
        exprs = [t.get("expr", "") for p in doc.get("panels", [])
                 for t in p.get("targets", [])]
        queried: set[str] = set()
        for e in exprs:
            queried |= set(re.findall(
                r"(gpu_(?:operator|health)_[a-z0-9_]+)", e))
        for fam in sorted(queried - suffixed):
            findings.append(Finding(
                "metrics-dashboard-query", rel, 1,
                f"dashboard queries {fam} but no registry provides it"))
    return findings
