"""The port's copies of the reference's device-free modules (kube
``objects``, ``selectors``, ``client``, ``fake``, ``incluster`` and utils
``prom``, ``trace``, ``logs``) against the originals: each scenario runs
the same calls on both copies and compares what they return, raise and
render, exactly."""

import dataclasses
import http.server
import json
import logging
import threading

import pytest

import tpu_operator.kube.client as ref_client
import tpu_operator.kube.fake as ref_fake
import tpu_operator.kube.incluster as ref_incluster
import tpu_operator.kube.objects as ref_objects
import tpu_operator.kube.selectors as ref_selectors
import tpu_operator.utils.logs as ref_logs
import tpu_operator.utils.prom as ref_prom
import tpu_operator.utils.trace as ref_trace
import tpu_operator_torch.kube.client as port_client
import tpu_operator_torch.kube.fake as port_fake
import tpu_operator_torch.kube.incluster as port_incluster
import tpu_operator_torch.kube.objects as port_objects
import tpu_operator_torch.kube.selectors as port_selectors
import tpu_operator_torch.utils.logs as port_logs
import tpu_operator_torch.utils.prom as port_prom
import tpu_operator_torch.utils.trace as port_trace

PAIRS = {
    "objects": (ref_objects, port_objects),
    "selectors": (ref_selectors, port_selectors),
    "client": (ref_client, port_client),
    "fake": (ref_fake, port_fake),
    "incluster": (ref_incluster, port_incluster),
    "prom": (ref_prom, port_prom),
    "trace": (ref_trace, port_trace),
    "logs": (ref_logs, port_logs),
}


def _plain(x):
    """A comparable form: Obj → its raw dict, an exception → its class name
    and message."""
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if hasattr(x, "raw") and isinstance(getattr(x, "raw"), dict):
        return x.raw
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    if isinstance(x, dict):
        return {k: _plain(v) for k, v in x.items()}
    return x


def _call(fn, *args, **kw):
    try:
        return _plain(fn(*args, **kw))
    except Exception as e:       # the error is part of the behaviour
        return _plain(e)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_copies_define_the_same_public_names(name):
    ref, port = PAIRS[name]

    def public(mod):
        return sorted(n for n, v in vars(mod).items()
                      if not n.startswith("_")
                      and getattr(v, "__module__", mod.__name__)
                      == mod.__name__)
    assert public(port) == public(ref)


def _pod(resources=None):
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "p", "namespace": "ns",
                         "labels": {"app": "x"}},
            "spec": {"containers": [
                {"name": "c", "env": [{"name": "A", "value": "1"}],
                 "resources": resources or {}}],
                "initContainers": [{"name": "i"}]}}


def _objects_scenario(m):
    out = [dataclasses.astuple(m.gvr_for(kind)) for kind in sorted(
        m.REGISTRY)]
    out.append(_call(m.gvr_for, "NoSuchKind"))
    ds = m.Obj({"apiVersion": "apps/v1", "kind": "DaemonSet",
                "metadata": {"name": "d", "namespace": "ns",
                             "uid": "u-1", "resourceVersion": "7"},
                "spec": {"template": _pod()}})
    owner = m.Obj({"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "owner", "uid": "u-2"}})
    ds.set_owner(owner)
    ds.set("spec", "template", "metadata", "labels", "k", "v")
    out += [ds.kind, ds.api_version, ds.name, ds.namespace, ds.key,
            ds.labels, ds.annotations, ds.resource_version,
            ds.get("spec", "template", "metadata", "labels"),
            ds.get("spec", "missing", default="dflt"), repr(ds),
            ds.deepcopy().raw, m.pod_template(ds)]
    c = m.find_container(ds, "c")
    m.set_env(c, "A", "2")
    m.set_env(c, "B", "3")
    out += [m.get_env(c, "A"), m.get_env(c, "B"), m.get_env(c, "Z"),
            [x["name"] for x in m.containers(ds, init=True)],
            m.find_container(ds, "nope")]
    for res in ({"limits": {"tpu.dev/chip": "1"}},
                {"requests": {"google.com/tpu": "4"}},
                {"limits": {"nvidia.com/gpu": "1"}}, {}):
        out.append(m.consumes_tpu(m.Obj(_pod(res))))
    for target, patch in (({"a": 1, "b": {"c": 2}}, {"b": {"c": None,
                                                         "d": [1]}}),
                          ({"a": 1}, {"a": {"x": 1}}), ("s", {"k": 1}),
                          ({"a": 1}, None)):
        out.append(m.merge_patch(target, patch))
    return out


SELECTORS = ("a=1", "a==1,b!=2", "a", "!a", "a in (1,2)", "a notin (1, 2)",
             "a=1,b in (x,y),!c", "", "a in (1,2", "=bad")
LABELS = ({}, {"a": "1"}, {"a": "2", "b": "2"}, {"a": "1", "b": "x"},
          {"a": "1", "b": "y", "c": "z"}, None)


def _selectors_scenario(m):
    out = [_call(m.parse_selector, s) for s in SELECTORS]
    for s in (*SELECTORS, {"a": "1"}, None):
        out += [_call(m.match_labels, labels, s) for labels in LABELS]
    aff = {"affinity": {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [
                {"matchExpressions": [
                    {"key": "a", "operator": "In", "values": ["1"]},
                    {"key": "c", "operator": "DoesNotExist"}]},
                {"matchExpressions": [
                    {"key": "b", "operator": "Exists"}]}]}}},
        "nodeSelector": {"a": "1"}}
    for spec in (aff, {"nodeSelector": {"b": "2"}}, {}, None):
        out += [_call(m.match_node_affinity, labels, spec)
                for labels in LABELS]
    return out


def _client_scenario(m):
    names = ("KubeError", "NotFoundError", "AlreadyExistsError",
             "ConflictError", "TransientError", "ThrottledError",
             "ServerUnavailableError", "NetworkError")
    out = [[c.__name__ for c in getattr(m, n).__mro__] for n in names]
    e = m.ThrottledError("slow down", retry_after=2.5)
    out += [str(e), e.retry_after, m.TransientError("x").retry_after]
    return out


def _fake_ops(c, objects, client):
    """The same calls on a fake cluster of either copy: nodes, a namespaced
    object through create, update, a conflicting update, patch, status,
    list by selector, apply and delete."""
    out = [_call(c.add_node, "n1", {"a": "1"}),
           _call(c.add_node, "n2", {"a": "2"}),
           _call(c.add_node, "n1")]
    pod = objects.Obj(_pod())
    out.append(_call(c.create, pod))
    got = c.get("Pod", "p", "ns")
    stale = got.deepcopy()
    got.labels["b"] = "x"
    out.append(_call(c.update, got))
    stale.labels["b"] = "y"
    out.append(_call(c.update, stale))
    out.append(_call(c.patch, "Pod", "p", "ns",
                     {"metadata": {"labels": {"c": "1"}}}))
    got = c.get("Pod", "p", "ns")
    got.raw["status"] = {"phase": "Succeeded"}
    out.append(_call(c.update_status, got))
    out.append(_call(c.list, "Node", label_selector="a=1"))
    out.append(_call(c.list, "Pod", "ns", label_selector={"app": "x"}))
    out.append(_call(c.apply, objects.Obj({
        "apiVersion": "v1", "kind": "ConfigMap",
        "metadata": {"name": "cm", "namespace": "ns"}, "data": {"k": "v"}})))
    out.append(_call(c.get, "Pod", "missing", "ns"))
    out.append(_call(c.get, "Pod", "p"))
    out.append(_call(c.delete, "Pod", "p", "ns"))
    out.append(_call(c.delete, "Pod", "p", "ns", ignore_missing=False))
    out.append(c.get_or_none("Pod", "p", "ns"))
    out.append([list(a) for a in c.actions])
    out.append(c.server_version())
    return out


def test_fake_cluster_matches_the_reference():
    ref = _fake_ops(ref_fake.FakeClient(), ref_objects, ref_client)
    port = _fake_ops(port_fake.FakeClient(), port_objects, port_client)
    assert port == ref


def test_file_backed_fake_cluster_matches_the_reference(tmp_path):
    ref = _fake_ops(ref_fake.FileBackedFakeClient(str(tmp_path / "r.json")),
                    ref_objects, ref_client)
    port = _fake_ops(
        port_fake.FileBackedFakeClient(str(tmp_path / "p.json")),
        port_objects, port_client)
    assert port == ref
    assert json.loads((tmp_path / "p.json").read_text()) == \
        json.loads((tmp_path / "r.json").read_text())


def test_port_errors_are_the_ports_own():
    """A port component catches the port's error classes; the reference's
    are other classes, which it would not catch."""
    c = port_fake.FakeClient()
    with pytest.raises(port_client.NotFoundError):
        c.get("Node", "absent")
    assert not issubclass(port_client.KubeError, ref_client.KubeError)
    assert not issubclass(port_client.AlreadyExistsError,
                          ref_client.AlreadyExistsError)
    c.add_node("n1")
    with pytest.raises(port_client.AlreadyExistsError):
        c.add_node("n1")


def _prom_scenario(m):
    reg = m.Registry()
    g = m.Gauge("g_total_ready", "a gauge", registry=reg)
    lg = m.Gauge("lg", 'help with "quotes" \\ and\nnewline',
                 labelnames=("node", "kind"), registry=reg)
    cnt = m.Counter("requests_total", "a counter", labelnames=("code",),
                    registry=reg)
    h = m.Histogram("latency_seconds", "a histogram", labelnames=("op",),
                    buckets=(0.1, 1.0, 10.0), registry=reg)
    g.set(3.5)
    g.inc(2)
    lg.labels("n1", 'a"b').set(1e-7)
    lg.labels("n2", "x").set(float("inf"))
    cnt.labels("200").inc()
    cnt.labels("200").inc(4)
    out = [_call(cnt.labels("500").set, 1), _call(cnt.labels("500").inc, -1)]
    for v in (0.05, 0.5, 5.0, 50.0):
        h.labels("get").observe(v, exemplar={"trace_id": "t1"})
    h.labels("put").observe(0.2)
    lg.remove("n2", "x")
    out += [g.get(), lg.get("n1", 'a"b'), cnt.get("200"), h.get("get"),
            h.sum("get"), h.quantile(0.5, "get"), h.quantile_all(0.9),
            h.exemplars("get"),
            _call(lambda: type(m.Gauge("g_total_ready", "dup",
                                       registry=reg)).__name__),
            reg.render(), reg.render(openmetrics=True)]
    return out


def _trace_scenario(m):
    ticks = iter(i * 0.25 for i in range(1000))
    dropped = []
    tracer = m.Tracer(keep=2, clock=lambda: next(ticks),
                      on_drop=dropped.append)
    for n in range(3):
        with tracer.start_trace(f"reconcile-{n}", n=n) as root:
            with m.span("state", state="s") as s:
                s.set(ok=True)
                with m.span("http:request", method="GET"):
                    pass
            child = tracer.child_of(root, "late")
            child.add_link(root.trace_id, root.span_id)
    req = tracer.start_trace("request")
    tracer.end_trace(req)
    out = [m.current(), dropped, tracer.dropped_total,
           [[(sp.name, sp.trace_id, sp.span_id, sp.parent_id, sp.attrs,
              sp.links, sp.start, sp.duration_s) for sp in t]
            for t in tracer.traces()]]
    events = tracer.chrome_events()
    out += [events, m.verify_nesting(events),
            m.verify_nesting(events + [{"name": "orphan", "ts": 0, "dur": 1,
                                        "args": {"trace_id": 99,
                                                 "span_id": 1,
                                                 "parent_id": 7}}])]
    with m.span("untraced") as null:
        null.set(a=1)
        out.append(type(null).__name__)
    return out


def _logs_scenario(m):
    record = logging.makeLogRecord({
        "name": "gpu-validator", "levelname": "WARNING", "levelno": 30,
        "msg": "driver %s", "args": ("skew",), "node": "n1",
        "obj": frozenset({1})})
    line = json.loads(m.JsonFormatter().format(record))
    line.pop("ts")
    return [line]


@pytest.mark.parametrize("name,scenario", [
    ("objects", _objects_scenario), ("selectors", _selectors_scenario),
    ("client", _client_scenario), ("prom", _prom_scenario),
    ("trace", _trace_scenario), ("logs", _logs_scenario)])
def test_copy_matches_the_reference(name, scenario):
    ref, port = PAIRS[name]
    assert _plain(scenario(port)) == _plain(scenario(ref))


def test_setup_logging_matches_the_reference():
    root = logging.getLogger()
    saved = root.handlers[:], root.level
    try:
        got = []
        for m in (ref_logs, port_logs):
            for fmt, verbose in (("json", True), ("text", False)):
                m.setup_logging(verbose, fmt)
                got.append((m.__name__.split(".")[0], fmt, root.level,
                            [type(h.formatter).__name__
                             for h in root.handlers]))
        assert [g[1:] for g in got[2:]] == [g[1:] for g in got[:2]]
    finally:
        root.handlers[:] = saved[0]
        root.setLevel(saved[1])


class _Api(http.server.BaseHTTPRequestHandler):
    """A stub apiserver: one Node, 404 for anything else, and a POST that
    conflicts."""

    def _send(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/api/v1/nodes/n1":
            self._send(200, {"apiVersion": "v1", "kind": "Node",
                             "metadata": {"name": "n1"},
                             "status": {"capacity": {"nvidia.com/gpu": "8"}},
                             "auth": self.headers["Authorization"]})
        else:
            self._send(404, {"kind": "Status", "reason": "NotFound",
                             "message": f"{self.path} not found"})

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        self._send(409, {"kind": "Status", "reason": "AlreadyExists",
                         "message": "exists"})

    def log_message(self, *a):
        pass


def test_in_cluster_client_matches_the_reference(monkeypatch, tmp_path):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Api)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        outs = []
        for inc, objects in ((ref_incluster, ref_objects),
                             (port_incluster, port_objects)):
            monkeypatch.setattr(inc, "SA_DIR", str(tmp_path / "no-sa"))
            c = inc.InClusterClient(host=url, token="tok", timeout=5)
            pod = objects.Obj(_pod())
            outs.append([_call(c.get, "Node", "n1"),
                         _call(c.get, "Pod", "absent", "ns"),
                         _call(c.get_or_none, "Node", "gone"),
                         _call(c.create, pod),
                         _call(inc.InClusterClient)])
        assert outs[1] == outs[0]
        assert outs[1][0]["auth"] == "Bearer tok"
        assert outs[1][1][0] == "NotFoundError"
        assert outs[1][3][0] == "AlreadyExistsError"
        assert outs[1][4][0] == "KubeError"
        # the port's client raises the port's classes
        monkeypatch.setattr(port_incluster, "SA_DIR", str(tmp_path))
        with pytest.raises(port_client.KubeError):
            port_incluster.InClusterClient()
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=5)
