"""The port's metrics docs (``tpu_operator_torch/docs/``) against its five
registries and against the reference's docs.

The reference's ``tests/test_metrics_docs.py`` runs on both copies
(``tests/torch_relay.py::run_case`` with ``tests/torch_analysis.py``'s
maps), so every exact-name pin holds on the port's docs, and every value
its assertions look at (the sections' text, the documented sets) equals
the reference's after the name map. The port's docs are the reference's
through that map and its stated decisions (``DOC_DECISIONS``), file for
file; each of the 139 registered ``gpu_`` families has a row in its own
section, and the dashboards query only registered ``gpu_`` families."""

import json
import os
import re

import pytest

import torch_analysis
from torch_names import to_port
from torch_relay import cases, run_case

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ("metrics.md", "dashboards/goodput.json", "dashboards/serving.json",
        "dashboards/README.md")


@pytest.mark.parametrize("name, fn, params", cases("test_metrics_docs"))
def test_same_as_the_reference(name, fn, params, tmp_path):
    run_case(name, fn, params, tmp_path, maps=torch_analysis.MAPS)


@pytest.mark.parametrize("doc", DOCS)
def test_doc_is_the_references_through_the_map(doc):
    ref = open(os.path.join(ROOT, "docs", doc)).read()
    port = open(os.path.join(ROOT, "tpu_operator_torch", "docs", doc)).read()
    assert port == torch_analysis.port_text(ref)


def test_every_decision_changes_a_doc():
    """A decision that no longer matches the reference's docs is stale."""
    mapped = "".join(to_port(open(os.path.join(ROOT, "docs", d)).read(),
                             torch_analysis.METRIC_NAMES) for d in DOCS)
    for pat, _ in torch_analysis.DOC_DECISIONS:
        assert re.search(pat, mapped), pat


def test_each_registered_family_has_a_row_in_its_section():
    from tpu_operator_torch.analysis.passes import metrics_docs as md
    text = open(os.path.join(ROOT, md.DOC)).read()
    total = 0
    for title, prefix, loader in md.SECTIONS:
        body, _ = md.section(text, title)
        registered = loader()
        assert registered and all(f.startswith("gpu_") for f in registered)
        assert md.documented(body, prefix) == registered, title
        total += len(registered)
    assert total == 139
    assert not re.findall(r"\btpu_(?!operator_torch/)\w+", text)


def test_dashboards_query_only_registered_gpu_families():
    from tpu_operator_torch.analysis.passes import metrics_docs as md
    real = set().union(*(loader() for _, _, loader in md.SECTIONS))
    real |= {f"{m}{s}" for m in real for s in ("_bucket", "_sum", "_count")}
    for name in ("goodput.json", "serving.json"):
        doc = json.load(open(os.path.join(ROOT, md.DASHBOARDS, name)))
        exprs = [t["expr"] for p in doc["panels"]
                 for t in p.get("targets", [])]
        queried = {f for e in exprs
                   for f in re.findall(r"\b[a-z]+_[a-z0-9_]+(?=[{\[(])", e)
                   if f.startswith(("gpu_", "tpu_"))}
        assert exprs and queried and queried <= real, queried - real
