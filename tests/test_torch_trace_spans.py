"""The port's spans inside its device work (``utils/trace.py``).

The validator's workload stage is a ``validator.validate`` span with a child
a leg, whose durations are ``leg_seconds``; the probes' spans nest in their
legs (and under ``health.probe`` in a health cycle); the flash op's host
path is ``flash_op.call`` with three steps on the card. With nothing recording, a span site records nothing.
The card test skips without a CUDA card.
"""

import json
from collections import Counter

import pytest
import torch

import tpu_operator_torch.health.monitor as monitor
import tpu_operator_torch.health.probes as probes
import tpu_operator_torch.kube.fake as fake
from tpu_operator_torch.ops import flash_attention as flash_mod
from tpu_operator_torch.utils import timing, trace
from tpu_operator_torch.validator.components import WorkloadComponent

LEGS = {1: ["matmul", "hbm", "flash"],
        2: ["matmul", "hbm", "flash", "collectives", "ring_attention"]}


def _paths(spans):
    """Each span's path of names from its root, counted."""
    by_id = {s.span_id: s for s in spans}

    def path(s):
        names = []
        while s is not None:
            names.append(s.name)
            s = by_id.get(s.parent_id)
        return "/".join(reversed(names))
    return Counter(path(s) for s in spans)


@pytest.mark.parametrize("ranks", [1, 2])
def test_validation_is_a_span_tree_and_its_legs_time_leg_seconds(
        tmp_path, monkeypatch, ranks):
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    wl = WorkloadComponent(validations_dir=str(tmp_path), device="cpu",
                           require_gpu=False, ranks=ranks, collective_mb=1)
    outer = trace.Tracer()
    with outer.start_trace("node"):
        info = wl.validate()
    (spans,) = outer.traces()
    assert trace.verify_nesting(outer.chrome_events()) == []
    paths = _paths(spans)
    root = "node/validator.validate"
    assert paths[root] == 1 and spans[1].name == "validator.validate"
    legs = {s.name.removeprefix("validator."): s for s in spans
            if s.parent_id == spans[1].span_id
            and s.name != "validator.runtime_build"}
    assert list(legs) == LEGS[ranks] == list(info["leg_seconds"])
    for leg, sp in legs.items():
        assert info["leg_seconds"][leg] == round(sp.duration_s, 4)
    # the probes' spans nest in their legs, a timed or untimed run each:
    # three matmul calls a differential (hi and lo, 3 repeats), each with
    # its inputs, 2 warm-up and 3 timed chains; one HBM array, a gate and
    # one timed launch a measurement (1 repeat on the CPU)
    mm, hbm = f"{root}/validator.matmul", f"{root}/validator.hbm"
    assert paths[f"{mm}/matmul.inputs"] == 6
    assert paths[f"{mm}/matmul.warmup"] == 12
    assert paths[f"{mm}/matmul.timed"] == 18
    assert paths[f"{hbm}/hbm.alloc"] == 1
    assert paths[f"{hbm}/hbm.gate"] == paths[f"{hbm}/hbm.timed"] == 2
    flash = f"{root}/validator.flash"
    assert paths[f"{flash}/flash_op.call"] == 1
    assert paths[f"{flash}/validator.flash_reference"] == 1
    # with no span active the component's own tracer roots the legs
    info = wl.validate()
    assert list(info["leg_seconds"]) == LEGS[ranks]
    assert all(s > 0 for s in info["leg_seconds"].values())
    assert trace.current() is None and trace.Tracer.active == 0


def test_validation_nests_under_a_span_already_active(tmp_path,
                                                      monkeypatch):
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    outer = trace.Tracer()
    wl = WorkloadComponent(validations_dir=str(tmp_path), device="cpu",
                           require_gpu=False, ranks=1)
    with outer.start_trace("node.bringup"):
        wl.validate()
    (spans,) = outer.traces()
    assert _paths(spans)["node.bringup/validator.validate/validator.hbm"] \
        == 1
    assert spans[1].name == "validator.validate"
    assert spans[1].parent_id == spans[0].span_id
    assert trace.verify_nesting(outer.chrome_events()) == []


def test_health_cycle_nests_the_hbm_probe_under_health_probe(tmp_path):
    client = fake.FakeClient()
    client.add_node("n0", {})
    tracer = trace.Tracer()
    mon = monitor.HealthMonitor(
        client, "n0", [probes.HbmSweepProbe(size_mb=1, device="cpu")],
        health_file=str(tmp_path / "gpu-health"), tracer=tracer)
    assert mon.reconcile_once()["healthy"] is True
    (spans,) = tracer.traces()
    paths = _paths(spans)
    under = "health.cycle/health.probe"
    assert paths[f"{under}/hbm.alloc"] == paths[f"{under}/hbm.gate"] == 1
    assert paths[f"{under}/hbm.timed"] == 2
    served = json.loads(tracer.chrome_json())["traceEvents"]
    assert {e["name"] for e in served} >= {"hbm.alloc", "hbm.gate",
                                           "hbm.timed"}
    assert trace.verify_nesting(served) == []


@pytest.mark.parametrize("warmup,iters", [(0, 1), (2, 3)])
def test_measure_best_spans_its_runs_under_the_prefix(warmup, iters):
    tracer = trace.Tracer()
    with tracer.start_trace("probe"):
        timing.measure_best(lambda: None, iters=iters, warmup=warmup,
                            span="p")
        timing.measure_best(lambda: None, iters=2, warmup=1)
    (spans,) = tracer.traces()
    assert [s.name for s in spans[1:]] == ["p.warmup"] * warmup \
        + ["p.timed"] * iters


def test_nothing_recording_makes_no_span(monkeypatch):
    assert trace.current() is None and not trace.Tracer.recording()
    assert trace.span("anything", a=1) is trace.NULL_SPAN
    made = []
    real = trace.Span.__init__

    def counting(init):
        def count(self, *a, **kw):
            made.append(type(self).__name__)
            init(self, *a, **kw)
        return count
    monkeypatch.setattr(trace.Span, "__init__", counting(real))
    monkeypatch.setattr(trace._Annotation, "__init__",
                        counting(trace._Annotation.__init__))
    q = torch.randn(64, 32)
    before = flash_mod.flash_attention.launches
    out = flash_mod.flash_attention(q, q, q, causal=True)
    assert made == [] and out.shape == q.shape
    assert flash_mod.flash_attention.launches == before
    # and under a tracer the same call is one span, the plain route
    tracer = trace.Tracer()
    monkeypatch.setattr(trace.Span, "__init__", real)
    with tracer.start_trace("root"):
        flash_mod.flash_attention(q, q, q, causal=True)
    (spans,) = tracer.traces()
    assert [s.name for s in spans[1:]] == ["flash_op.call"]


def test_a_refused_call_closes_its_span():
    tracer = trace.Tracer()
    q = torch.randn(64, 32)
    with tracer.start_trace("root") as root:
        with pytest.raises(ValueError, match="share a"):
            flash_mod.flash_attention(q, q, q[:, :16])
        assert trace.current() is root
    (spans,) = tracer.traces()
    assert spans[1].name == "flash_op.call"
    assert spans[1].attrs["error"].startswith("ValueError")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.bfloat16, 128, "K2"), (torch.bfloat16, 100, "K2w"),
    (torch.bfloat16, 300, "K2dw"), (torch.float32, 128, "K2dt")])
def test_each_route_spans_its_host_path_on_the_card(cuda, dtype, d, kernel):
    q, k, v = (torch.randn((256, d), device=cuda).to(dtype)
               for _ in range(3))
    assert flash_mod.kernel_for(dtype, d, 256) == kernel
    counted = {"K2": flash_mod.flash_attention, "K2w": flash_mod.flash_wgmma,
               "K2dw": flash_mod.flash_wide_wgmma,
               "K2dt": flash_mod.flash_wide_tf32}[kernel]
    before = counted.launches
    tracer = trace.Tracer()
    for _ in range(2):
        with tracer.start_trace("root"):
            # k handed over strided: prepare copies it
            flash_mod.flash_attention(q, k.t().contiguous().t(), v,
                                      causal=True)
    torch.cuda.synchronize(cuda)
    assert counted.launches == before + 2
    for spans in tracer.traces():
        call = spans[1]
        assert call.name == "flash_op.call" and call.attrs == {}
        steps = [s for s in spans if s.parent_id == call.span_id]
        assert [s.name for s in steps] == ["flash_op.prepare",
                                           "flash_op.schedule",
                                           "flash_op.launch"]
        assert trace.verify_nesting(tracer.chrome_events()) == []


def test_the_count_of_active_spans_returns_to_zero():
    assert trace.Tracer.active == 0
    tracer = trace.Tracer()
    with tracer.start_trace("root") as root:
        assert trace.Tracer.active == 1
        with pytest.raises(RuntimeError):
            with trace.span("child"):
                assert trace.Tracer.active == 2
                raise RuntimeError("x")
        hop = []
        worker = __import__("threading").Thread(
            target=lambda: hop.append((trace.Tracer.recording(),
                                       _enter_use(root))))
        worker.start()
        worker.join()
        # another thread sees a span open somewhere, but none of its own
        assert hop == [(False, 2)]
    assert trace.Tracer.active == 0 and not trace.Tracer.recording()


def test_a_span_left_on_another_thread_counts_down():
    """A span entered on one thread and left on another (a completion
    callback) still takes itself off the count of active spans."""
    import threading
    tracer = trace.Tracer()
    root = tracer.start_trace("root")
    worker = threading.Thread(target=root.__enter__)
    worker.start()
    worker.join()
    assert trace.Tracer.active == 1 and trace.current() is None
    root.__exit__(None, None, None)
    assert trace.Tracer.active == 0 and not trace.Tracer.recording()
    (spans,) = tracer.traces()
    assert spans[0].end is not None


def _enter_use(span):
    with trace.use(span):
        return trace.Tracer.active


def test_the_count_of_active_spans_survives_threads_racing():
    """Many threads entering and leaving spans, with the interpreter
    switching threads as often as it can: the count of active spans,
    updated under a lock, ends at zero."""
    import sys
    import threading
    tracer = trace.Tracer(keep=1)

    def work():
        for _ in range(300):
            with tracer.start_trace("root"):
                with trace.span("a"):
                    with trace.span("b"):
                        pass
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(16)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    assert trace.Tracer.active == 0
