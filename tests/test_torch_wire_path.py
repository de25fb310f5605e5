"""``chip_smoke.py``'s tenth path, "operator over the wire", on the CPU.

The path's serving phase runs here as it runs on the card — the port's
apiserver and two operator processes over TLS, leader election, the watch
wake, failover after SIGKILL — with the one step that needs the card, the
rendered ``workload`` container, replaced by a stand-in that records the
container it was handed. Its helpers are held on their own: the rollouts
are written through the DaemonSets' status subresource, which the
operator's watch sees, where the apiserver's ``/_kubelet/mark-ready``
(both copies) changes the store behind the watch.
"""

import threading

import pytest

import chip_smoke
from torch_wire import PORT, on_both, raw_request, tls_files, wire  # noqa: F401


def test_the_serving_phase_on_the_cpu(monkeypatch, capsys):
    handed = []

    def workload(client, tag):
        ds = client.get("DaemonSet", "gpu-operator-validator",
                        chip_smoke.STATES_NS)
        [c] = [c for c in ds.get("spec", "template", "spec",
                                 "initContainers")
               if c["name"] == "workload-validation"]
        handed.append((tag, c["command"]))
    monkeypatch.setattr(chip_smoke, "run_rendered_workload", workload)
    chip_smoke.phase_wire_serve()
    assert handed == [("[wire]", ["gpu-validator", "--component",
                                  "workload"])]
    out = capsys.readouterr().out
    for line in ("CR create -> ready", "0 reads and 0 writes a pass",
                 "its DaemonSet gone in", "took the Lease",
                 "the apiserver's requests by verb",
                 "standby exited rc 0 on SIGINT"):
        assert line in out, out


def test_rollouts_are_written_through_the_status_subresource(tls_files):  # noqa: F811
    from tpu_operator_torch.kube import Obj
    with wire(PORT, tls_files, auto_ready=False) as (srv, client):
        srv.store.add_node("n0", {"x": "1"})
        client.create(Obj({
            "apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": "d", "namespace": chip_smoke.STATES_NS},
            "spec": {"template": {"spec": {"nodeSelector": {"x": "1"}}}}}))
        events = []
        live = threading.Event()

        def watch():
            for etype, obj in client.watch("DaemonSet", chip_smoke.STATES_NS,
                                           timeout_s=10):
                if etype == "ADDED":
                    live.set()      # the initial list: the stream is open
                if etype == "MODIFIED":
                    events.append(obj.raw["status"])
                    return
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        assert live.wait(10)
        assert chip_smoke.mark_rollouts_done(client) == 1
        assert chip_smoke.mark_rollouts_done(client) == 0
        t.join(timeout=10)
        assert events == [{"desiredNumberScheduled": 1, "numberReady": 1,
                           "numberUnavailable": 0,
                           "updatedNumberScheduled": 1}]


def test_kubelet_endpoint_changes_the_store_behind_the_watch(tls_files):  # noqa: F811
    """Both copies: ``POST /_kubelet/mark-ready`` makes a DaemonSet ready
    in the store with no resourceVersion bump and no watch event, so a
    caching operator never sees it; this is why the path writes rollouts
    through the status subresource."""
    def scenario(S, srv, client):
        srv.store.add_node("n0", {"x": "1"})
        ns = S.ns
        client.create(S.kube.Obj({
            "apiVersion": "apps/v1", "kind": "DaemonSet",
            "metadata": {"name": "d", "namespace": ns},
            "spec": {"template": {"spec": {"nodeSelector": {"x": "1"}}}}}))
        before = client.get("DaemonSet", "d", ns)
        rv = before.resource_version
        events = []
        live = threading.Event()

        def watch():
            for etype, obj in client.watch("DaemonSet", ns, timeout_s=2):
                if etype == "ADDED":
                    live.set()      # the initial list: the stream is open
                elif etype != "BOOKMARK":
                    events.append(etype)
        t = threading.Thread(target=watch, daemon=True)
        t.start()
        assert live.wait(10)
        code = raw_request(srv, tls_files, "POST", "/_kubelet/mark-ready",
                           {})[0]
        t.join(timeout=10)
        got = client.get("DaemonSet", "d", ns)
        return [before.raw["status"]["numberReady"], code,
                got.raw["status"]["numberReady"],
                got.resource_version == rv, events]
    ref, port = on_both(scenario, tls_files, auto_ready=False)
    assert port == ref == [0, 200, 1, True, []]


@pytest.mark.parametrize("where,want", [
    ({}, 6.0), ({"verb": "get"}, 3.0), ({"verb": ("get", "list")}, 5.0),
    ({"kind": lambda k: k != "Lease"}, 4.0)])
def test_prom_total_sums_the_matching_samples(where, want):
    samples = {'f{verb="get",kind="Node"} ': 1.0,
               'f{verb="get",kind="Lease"}': 2.0,
               'f{verb="list",kind="Node"}': 2.0,
               'f{verb="patch",kind="Pod"}': 1.0,
               'g{verb="get",kind="Node"}': 9.0}
    samples = {k.strip(): v for k, v in samples.items()}
    assert chip_smoke.prom_total(samples, "f", **where) == want
