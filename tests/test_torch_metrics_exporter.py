"""The port's metrics exporter against the reference's.

``parse_exposition`` and ``render`` are the reference's parser and
renderer: on the exposition cases of ``tests/test_operands.py`` and on
generated text, both packages give the same families and the same page.
``MetricsExporter`` keeps the reference's rules (relabeling with
``node``/``accelerator``, no stale agent samples after a failed scrape, an
``HTTPException`` degrades to ``up 0``, readiness gauges that drop to 0)
under ``gpu_exporter_*`` names and the port validator's component list.
Last, the whole tier: the exporter scraping the real ``gpu-metrics-agent``
over HTTP, against the reference's exporter scraping ``tpu-metrics-agent``
on its side of the same fixture node.
"""

import dataclasses
import socket
import subprocess
import threading

import pytest

import tpu_operator.operands.metrics_exporter as ref_exp
import tpu_operator_torch.operands.metrics_exporter as port_exp
from test_operands import AGENT_PAGE, _serve_text
from torch_native import (SIDES, agent_args, binary, install_cmd,  # noqa
                          port_bins, ref_bins, run, side_tree, to_port)

CASES = [
    AGENT_PAGE,
    "garbage line without value\nok 1\n"
    'broken{unclosed="x 1\n# random comment\n',
    '# TYPE m gauge\nm{node="own"} 1\n',
    'a{x="1",y="two \\"q\\" \\\\ \\n"} +Inf\nb NaN\nc 1e-3 1700000000\n',
    "# HELP only_help some help\n# TYPE t counter\nt_total 3\n",
    "",
]
LABELS = [{}, {"node": "n1"}, {"node": "n1", "accelerator": "h100"}]


def families(mod, text):
    return [dataclasses.astuple(f) for f in mod.parse_exposition(text)]


@pytest.mark.parametrize("text", CASES)
def test_parse_exposition_matches_the_reference(text):
    assert families(port_exp, text) == families(ref_exp, text)


@pytest.mark.parametrize("labels", LABELS)
@pytest.mark.parametrize("text", CASES)
def test_render_matches_the_reference(text, labels):
    out = port_exp.render(port_exp.parse_exposition(text), labels)
    assert out == ref_exp.render(ref_exp.parse_exposition(text), labels)


def test_parse_and_render_match_on_generated_text():
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=200, deadline=None, derandomize=True)
    @hypothesis.given(st.text(alphabet='ab{}=",\\ \n#1.e+', max_size=80))
    def check(s):
        assert families(port_exp, s) == families(ref_exp, s)
        assert port_exp.render(port_exp.parse_exposition(s), {"node": "n"}) \
            == ref_exp.render(ref_exp.parse_exposition(s), {"node": "n"})

    check()


def test_exporter_relabels_and_serves_meta(tmp_path):
    from tpu_operator_torch.validator.components import VALID_COMPONENTS
    page_text = to_port(AGENT_PAGE)
    srv = _serve_text([page_text])
    (tmp_path / "driver-ready").touch()
    (tmp_path / "workload-ready").touch()
    exp = port_exp.MetricsExporter(
        agent_addr="127.0.0.1:%d" % srv.server_address[1],
        node_name="node-a", accelerator="h100",
        validations_dir=str(tmp_path))
    try:
        assert exp.scrape_once()
        page = exp.render()
    finally:
        srv.shutdown()
    assert 'gpu_agent_up{node="node-a",accelerator="h100"} 1' in page
    assert "gpu_exporter_up 1" in page
    assert "gpu_exporter_scrapes_total 1" in page
    for c in VALID_COMPONENTS:
        if c != "gate":           # the barrier writes no status file
            want = 1 if c in ("driver", "workload") else 0
            assert f'gpu_exporter_validation_ready{{component="{c}"}} ' \
                f'{want}' in page
    assert 'component="gate"' not in page
    # the relabeled agent page is the reference's relabeling of it
    tail = page[page.index("# HELP gpu_agent_up"):]
    assert tail == ref_exp.render(ref_exp.parse_exposition(page_text),
                                  {"node": "node-a", "accelerator": "h100"})


def test_exporter_agent_down_serves_up_zero_no_stale():
    srv = _serve_text([to_port(AGENT_PAGE)])
    exp = port_exp.MetricsExporter(
        agent_addr="127.0.0.1:%d" % srv.server_address[1], node_name="n")
    assert exp.scrape_once()
    assert "gpu_agent_up" in exp.render()
    srv.shutdown()
    srv.server_close()
    assert not exp.scrape_once()
    page = exp.render()
    assert "gpu_exporter_up 0" in page
    assert "gpu_agent_up" not in page       # stale samples dropped
    assert "gpu_exporter_scrape_errors_total 1" in page


def test_exporter_survives_midresponse_agent_death():
    """An agent dying mid-response raises ``http.client.IncompleteRead``:
    the exporter degrades to ``up 0``, it does not crash."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)

    def half_response():
        conn, _ = srv.accept()
        conn.recv(1024)
        conn.sendall(b"HTTP/1.1 200 OK\r\nContent-Length: 100000\r\n\r\nst")
        conn.close()

    t = threading.Thread(target=half_response, daemon=True)
    t.start()
    exp = port_exp.MetricsExporter(
        agent_addr="127.0.0.1:%d" % srv.getsockname()[1])
    try:
        assert not exp.scrape_once()
        assert "gpu_exporter_up 0" in exp.render()
    finally:
        srv.close()
        t.join(timeout=10)
    assert not t.is_alive()


def test_exporter_validation_gauge_unsticks_on_file_removal(tmp_path):
    exp = port_exp.MetricsExporter(agent_addr="127.0.0.1:1",
                                   validations_dir=str(tmp_path))
    f = tmp_path / "nvlink-diag-ready"
    f.touch()
    assert 'gpu_exporter_validation_ready{component="nvlink-diag"} 1' \
        in exp.render()
    f.unlink()
    assert 'gpu_exporter_validation_ready{component="nvlink-diag"} 0' \
        in exp.render()


def test_exporter_cli_once(tmp_path, capsys):
    from tpu_operator_torch.cli.metrics_exporter import main
    srv = _serve_text([to_port(AGENT_PAGE)])
    try:
        rc = main(["--agent-addr", "127.0.0.1:%d" % srv.server_address[1],
                   "--node-name", "n1", "--accelerator-type", "",
                   "--validations-dir", str(tmp_path), "--once"])
    finally:
        srv.shutdown()
    assert rc == 0
    assert 'gpu_agent_devices_total{node="n1"} 4' in capsys.readouterr().out
    # an unreachable agent: the page still prints, the exit code says so
    assert main(["--agent-addr", "127.0.0.1:1", "--once"]) == 1
    assert "gpu_exporter_up 0" in capsys.readouterr().out


def _volatile(line):
    return line.startswith(("gpu_agent_uptime_seconds",
                            "gpu_exporter_last_scrape"))


def test_exporter_scrapes_real_agent(ref_bins, port_bins, tmp_path):
    """The tier end to end: each side's exporter scrapes its own C++ agent
    over HTTP after its node agent installed the driver library; the
    relabeled agent samples agree after the name map."""
    bins = {"r": ref_bins, "p": port_bins}
    pages = {}
    for s in SIDES:
        root = side_tree(tmp_path, s)
        run(bins[s], binary(s, "node-agent"), install_cmd(s),
            *agent_args(root, s))
        glob = root / ("accel*" if s == "r" else "nvidia[0-9]*")
        extra = ["--nvml", "absent"] if s == "p" else []
        proc = subprocess.Popen(
            [str(bins[s] / binary(s, "metrics-agent")), "--port", "0",
             "--device-glob", str(glob), "--install-dir", str(root / "host"),
             *extra], stdout=subprocess.PIPE, text=True)
        try:
            port = int(proc.stdout.readline().rsplit(":", 1)[1])
            mod = ref_exp if s == "r" else port_exp
            exp = mod.MetricsExporter(
                agent_addr=f"127.0.0.1:{port}", node_name="node-x",
                accelerator="h100",
                validations_dir=str(root / "validations"))
            assert exp.scrape_once()
            pages[s] = exp.render()
        finally:
            proc.terminate()
            proc.wait(timeout=10)
    page = pages["p"]
    assert 'gpu_agent_up{node="node-x",accelerator="h100"} 1' in page
    assert ('gpu_agent_devices_total{node="node-x",accelerator="h100"} 2'
            in page)
    assert ('gpu_agent_driver_loadable{node="node-x",accelerator="h100"} 1'
            in page)
    assert "gpu_exporter_up 1" in page
    assert 'gpu_exporter_validation_ready{component="driver"} 1' in page

    def agent_part(text):
        return [ln for ln in text[text.index("# HELP gpu_agent_up"):]
                .splitlines() if not _volatile(ln)]

    ref = to_port(pages["r"]).replace("tpu_exporter_", "gpu_exporter_")
    assert agent_part(page) == agent_part(ref)
