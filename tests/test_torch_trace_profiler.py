"""The port's spans in ``torch.profiler``'s trace.

While the profiler records on the calling thread, every span site is also
an annotation of the same name (``user_annotation`` in the exported Chrome
trace), with or without a tracer's span active, so the program's spans
share the device trace's clock. Here on the CPU's profiler.
"""

import json

import pytest
import torch

import tpu_operator_torch.utils.device  # noqa: F401  (installs the hook)
from tpu_operator_torch.ops.flash_attention import flash_attention
from tpu_operator_torch.utils import trace


def _record(tmp_path, body):
    """Run ``body`` under the CPU profiler inside an ``outer``
    ``record_function``; the exported trace's annotations by name."""
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])
    with prof:
        assert trace.Tracer.recording()
        with torch.profiler.record_function("outer"):
            body()
    assert not trace.Tracer.recording()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    found = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            found.setdefault(e["name"], []).append(e)
    return found


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and \
        inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_a_span_with_no_tracer_is_an_annotation(tmp_path):
    made = []

    def body():
        with trace.span("probe.step", a=1) as sp:
            made.append(sp)
            with trace.span("probe.inner"):
                torch.ones(8).sum()
        assert trace.current() is None
    found = _record(tmp_path, body)
    (sp,) = made
    assert not isinstance(sp, trace.Span) and sp.attrs == {}
    (outer,), (step,), (inner,) = (found["outer"], found["probe.step"],
                                   found["probe.inner"])
    assert _inside(step, outer) and _inside(inner, step)


def test_a_span_with_a_tracer_is_both(tmp_path):
    tracer = trace.Tracer()

    def body():
        with tracer.start_trace("root"):
            with trace.span("child", k=2) as sp:
                sp.set(done=True)
    found = _record(tmp_path, body)
    (spans,) = tracer.traces()
    assert [(s.name, s.attrs) for s in spans] == [
        ("root", {}), ("child", {"k": 2, "done": True})]
    assert _inside(found["child"][0], found["root"][0])
    assert _inside(found["root"][0], found["outer"][0])
    assert all(s.mark is None for s in spans)


def test_the_flash_op_is_an_annotation_on_the_cpu(tmp_path):
    q = torch.randn(64, 32)
    found = _record(tmp_path,
                    lambda: flash_attention(q, q, q, causal=True))
    (call,) = found["flash_op.call"]
    assert _inside(call, found["outer"][0])
    assert "flash_op.prepare" not in found


def test_a_span_handed_to_another_thread_is_not_an_annotation(tmp_path):
    """``use()`` re-activates real spans only: an annotation made where no
    tracer's span was active never goes on the thread's stack."""
    def body():
        sp = trace.span("state:x")
        with trace.use(sp) as active:
            assert active is sp and trace.current() is None
    _record(tmp_path, body)


@pytest.mark.parametrize("hook", [None, "installed"])
def test_without_a_profiler_the_hook_is_not_asked_for_annotations(
        monkeypatch, hook):
    asked = []
    if hook is None:
        monkeypatch.setattr(trace.Tracer, "profiler", None)
    else:
        monkeypatch.setattr(trace.Tracer, "profiler", (
            lambda: False, lambda name: asked.append(name), asked.append))
    assert trace.span("x") is trace.NULL_SPAN
    assert not trace.Tracer.recording()
    tracer = trace.Tracer()
    with tracer.start_trace("root") as root:
        assert trace.Tracer.recording() and root.mark is None
    assert asked == []
