"""``gpu-metrics-agent`` against the reference's ``tpu-metrics-agent``, and
against the port's Python readers of the same facts.

Parity: both agents scrape their own side of the same fixture node; the
pages agree after ``torch_native.NAME_MAP`` (``tpu_agent_*`` →
``gpu_agent_*``, ``libtpu_loadable``/``_build_epoch``/``_skew`` →
``driver_loadable``/``_build_epoch``/``_skew``), less the uptime sample.
The reference's sysfs attributes
(``<sysfs>/class/accel/accelN/device/<attr>``) are the port's attribute
files (``<attr-root>/nvidiaN/<attr>``, ``utils/nvml.py::FileSource``'s
layout). The reference's PJRT families (``pjrt_api_version``,
``libtpu_info``) become ``gpu_agent_driver_info`` (``cuDriverGetVersion``
and NVML's driver version).

Against the port's Python: the driver-version parsers equal
``validator/driver_build.py`` (``VERSION_RE`` on the recorded running
version, ``extract_build`` on the staged library) on a fixed corpus and on
generated text, and the per-card attributes from the compiled fake NVML
equal ``NvmlSource``'s, keyed by minor number, with presence by NVML's
list (F7).
"""

import os
import shutil
import subprocess
import urllib.error
import urllib.request

import pytest

from torch_fake_libcuda import system_libc
from torch_fake_nvml import FAKE_NVML_ATTRIBUTES, nvml_so  # noqa: F401
from torch_native import (SIDES, agent_args, binary, install_cmd,  # noqa
                          port_bins, ref_bins, run, side_tree, to_port)
from tpu_operator_torch.validator.driver_build import (build_epoch,
                                                      extract_build)


@pytest.fixture
def trees(tmp_path):
    return {s: side_tree(tmp_path, s) for s in SIDES}


@pytest.fixture
def bins(ref_bins, port_bins):
    return {"r": ref_bins, "p": port_bins}


def glob_of(root, side):
    return root / ("accel*" if side == "r" else "nvidia[0-9]*")


def scrape(bins, side, root, *extra, env=None):
    args = ["--once", "--device-glob", glob_of(root, side),
            "--install-dir", root / "host", *extra]
    if side == "p" and "--nvml" not in extra:
        args += ["--nvml", "absent"]
    return run(bins, binary(side, "metrics-agent"), *args, env=env)


def page(text):
    """The page's lines less the uptime sample (a clock reading)."""
    return [ln for ln in text.splitlines()
            if not ln.startswith(("tpu_agent_uptime_seconds ",
                                  "gpu_agent_uptime_seconds "))]


def test_metrics_agent_once(bins, trees):
    out = {}
    for s in SIDES:
        run(bins[s], binary(s, "node-agent"), install_cmd(s),
            *agent_args(trees[s], s))
        p = scrape(bins[s], s, trees[s])
        assert p.returncode == 0
        out[s] = p.stdout
    assert "gpu_agent_devices_total 2" in out["p"]
    assert "gpu_agent_driver_loadable 1" in out["p"]
    assert 'gpu_agent_device_present{device="%s"} 1' % (
        trees["p"] / "nvidia0") in out["p"]
    assert page(out["p"]) == page(to_port(out["r"]))


def test_metrics_agent_skew_gauge_absent_without_both_builds(bins, trees):
    """A library with no version (plain libc) and no recorded runtime
    version: the skew gauge is absent, not a false-confident 0."""
    out = {}
    for s in SIDES:
        run(bins[s], binary(s, "node-agent"), install_cmd(s),
            *agent_args(trees[s], s))
        out[s] = scrape(bins[s], s, trees[s], "--validations-dir",
                        trees[s] / "validations").stdout
    assert "gpu_agent_driver_skew" not in out["p"]
    assert page(out["p"]) == page(to_port(out["r"]))


STAMPS = {  # (staged, running) → (old, new) builds of each side
    "r": ("Built on Nov 12 2025 14:16:36 (1762985796) cl/831091709",
          "Built on Jan 12 2026 16:25:22 (1768263922) cl/854318611"),
    "p": ("NVRM version: NVIDIA UNIX x86_64 Kernel Module  550.54.15  "
          "Tue Mar  5 22:23:56 UTC 2024", "580.159.03"),
}


def _stamped(root, side, stamp):
    lib = root / "host" / SIDES[side][1]
    shutil.copy(system_libc(), lib)
    with open(lib, "ab") as f:
        f.write(b"\0" + stamp.encode() + b"\0")


def test_metrics_agent_driver_skew_gauges(bins, trees):
    """The staged library's version against the running kernel module's,
    recorded by workload validation: during an upgrade they differ and the
    skew gauge reads 1; once the module runs the new version it reads 0.
    The same sequence on the reference's stamps gives the same samples
    (their values are each side's own epochs)."""
    shapes = {}
    for s in SIDES:
        old, new = STAMPS[s]
        _stamped(trees[s], s, new)
        (trees[s] / "validations" / "runtime-build").write_text(old)
        first = scrape(bins[s], s, trees[s], "--validations-dir",
                       trees[s] / "validations").stdout
        (trees[s] / "validations" / "runtime-build").write_text(new)
        second = scrape(bins[s], s, trees[s], "--validations-dir",
                        trees[s] / "validations").stdout
        shapes[s] = [[ln.rsplit(" ", 1)[0] for ln in page(to_port(x))
                      if "driver_" in ln and not ln.startswith("#")]
                     for x in (first, second)]
        if s == "p":
            assert 'gpu_agent_driver_build_epoch{source="staged"} ' \
                '580159003' in first
            assert 'gpu_agent_driver_build_epoch{source="runtime"} ' \
                '550054015' in first
            assert "gpu_agent_driver_skew 1" in first
            assert "gpu_agent_driver_skew 0" in second
    assert shapes["p"] == shapes["r"]


def test_metrics_agent_runtime_build_file_env_override(port_bins, tmp_path):
    """``GPU_RUNTIME_BUILD_FILE`` relocates the record for the validator;
    the agent follows it, or skew alerting goes dark exactly when
    configured non-default."""
    root = side_tree(tmp_path, "p")
    _stamped(root, "p", "580.159.03")
    alt = root / "elsewhere"
    alt.mkdir()
    (alt / "rb").write_text("550.54.15")
    p = scrape(port_bins, "p", root, "--validations-dir",
               root / "validations",
               env={"GPU_RUNTIME_BUILD_FILE": str(alt / "rb")})
    assert 'source="runtime"} 550054015' in p.stdout
    assert "gpu_agent_driver_skew 1" in p.stdout


# -- the version grammar: the C++ parsers against driver_build ---------------

RECORDS = [
    "550.54.15", "535.104", "580.159.03", "NVRM version: NVIDIA UNIX x86_64 "
    "Kernel Module  550.54.15  Tue Mar  5 22:23:56 UTC 2024",
    "1550.54.15", "550.54.1234", "550.1234", "550.", "55.54.15",
    "a550.54.15b", "550.54.15.7", "x 999.9 y 550.54.15", "no version",
    "", "550.54", "550.5", "550..54", "12345.678.9", "550.54.15\n",
    "version 550.054.015 end", "550.54.15x", "550.54.x", "000.0",
    "000.000.000"]


def _runtime_epoch(port_bins, root, text):
    (root / "rb").write_bytes(text.encode())
    p = scrape(port_bins, "p", root, "--runtime-build-file", root / "rb")
    for ln in p.stdout.splitlines():
        if ln.startswith('gpu_agent_driver_build_epoch{source="runtime"}'):
            return int(ln.split()[-1])
    return None


@pytest.mark.parametrize("text", RECORDS)
def test_runtime_version_parser_matches_driver_build(port_bins, tmp_path,
                                                     text):
    root = side_tree(tmp_path, "p")
    assert _runtime_epoch(port_bins, root, text) == build_epoch(text)


def test_runtime_version_parser_matches_on_generated_text(port_bins,
                                                          tmp_path):
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies
    root = side_tree(tmp_path, "p")

    @hypothesis.settings(max_examples=150, deadline=None, derandomize=True)
    @hypothesis.given(st.text(alphabet="0123456789.5 a", max_size=24))
    def check(text):
        assert _runtime_epoch(port_bins, root, text) == build_epoch(text)

    check()


STAGED = [  # (file name the link resolves to, bytes appended to libc)
    ("libcuda.so.550.54.15", b""),
    ("libcuda.so.535.104", b""),
    ("libcuda.so.1", b"\x00580.159.03\x00"),
    ("libcuda.so.1", b"\x00580.159.03x\x00"),     # not a C string of its own
    ("libcuda.so.1", b"580.159.03\x00"),          # no leading NUL
    ("libcuda.so.1", b"\x001580.159.03\x00"),
    ("libcuda.so.1", b"\x00535.104\x00\x00550.54.15\x00"),   # the first
    ("libcuda.so.5500.54.15", b"\x00535.104\x00"),  # name not a version
    ("libcuda_x.so.550.54.15", b""),
    ("lib.so.550.54.15", b"\x00535.104\x00"),       # \w+ needs a character
    ("libcuda.so.550.54.15.1", b""),
    ("libcuda.so.000.0", b""),
    ("libcuda.so.1", b"\x00000.0.0\x00"),
]


@pytest.mark.parametrize("name,tail", STAGED)
def test_staged_version_matches_extract_build(port_bins, tmp_path, name,
                                              tail):
    root = side_tree(tmp_path, "p")
    host = root / "host"
    shutil.copy(system_libc(), host / name)
    with open(host / name, "ab") as f:
        f.write(tail)
    if name != "libcuda.so.1":
        (host / "libcuda.so.1").symlink_to(name)
    p = scrape(port_bins, "p", root)
    got = None
    for ln in p.stdout.splitlines():
        if ln.startswith('gpu_agent_driver_build_epoch{source="staged"}'):
            got = int(ln.split()[-1])
    assert got == build_epoch(extract_build(str(host / "libcuda.so.1")))


# -- per-card attributes -----------------------------------------------------

def test_metrics_agent_file_attrs(bins, tmp_path):
    """Attribute files where NVML is absent; the reference's sysfs layout,
    the same values and the same exclusions (a value that is no number)."""
    roots = {s: side_tree(tmp_path, s) for s in SIDES}
    attr_dirs = {"r": tmp_path / "sysfs" / "class" / "accel" / "accel0" /
                 "device", "p": tmp_path / "attrs" / "nvidia0"}
    for d in attr_dirs.values():
        d.mkdir(parents=True)
        (d / "temp").write_text("45.5\n")
        (d / "duty_cycle_pct").write_text("87\n")
        (d / "not_numeric").write_text("hello\n")
    lines = {}
    for s, flag in (("r", ["--sysfs", tmp_path / "sysfs"]),
                    ("p", ["--attr-root", tmp_path / "attrs"])):
        out = scrape(bins[s], s, roots[s], *flag).stdout
        lines[s] = sorted(ln for ln in page(to_port(out))
                          if "device_attr" in ln)
    assert 'gpu_agent_device_attr{device="nvidia0",attr="temp"} 45.5' \
        in lines["p"]
    assert 'gpu_agent_device_attr{device="nvidia0",attr="duty_cycle_pct"}' \
        ' 87' in lines["p"]
    assert lines["p"] == lines["r"]


def test_metrics_agent_reads_nvml_by_minor_number(port_bins, tmp_path,
                                                  nvml_so):
    """The fake NVML lists two cards, minors 0 and 2. The agent publishes
    ``NvmlSource``'s attributes under the same names and minor numbers
    (the numeric ones; the name is a label of ``device_present``), and a
    node NVML does not list (``nvidia1``) reads ``device_present 0`` (F7),
    though its permission bits pass."""
    from tpu_operator_torch.utils.nvml import Library, NvmlSource
    root = side_tree(tmp_path, "p", nodes=3)
    out = scrape(port_bins, "p", root, "--nvml", nvml_so).stdout
    assert "gpu_agent_devices_total 2" in out
    name = FAKE_NVML_ATTRIBUTES[0]["name"]
    for i, present in ((0, 1), (1, 0), (2, 1)):
        label = f',name="{name}"' if present else ""
        assert (f'gpu_agent_device_present{{device="{root}/nvidia{i}"'
                f'{label}}} {present}') in out
    got = {}
    for ln in out.splitlines():
        if ln.startswith("gpu_agent_device_attr{"):
            labels, value = ln.split("} ")
            dev, attr = (kv.split("=")[1].strip('"')
                         for kv in labels.split("{")[1].split(","))
            got.setdefault(int(dev[len("nvidia"):]), {})[attr] = value
    want = {minor: {k: v for k, v in attrs.items()
                    if k not in ("name", "nvlink_down")}
            for minor, attrs in NvmlSource(Library(nvml_so)).attributes()
            .items()}
    assert got == want
    assert want[2]["ecc_uncorrected_volatile"] == "7000000000"
    assert 'gpu_agent_driver_info{name="driver_version",' \
        'value="580.159.03"} 1' in out


def test_metrics_agent_exports_driver_info(port_bins, tmp_path):
    """``cuDriverGetVersion`` of the staged library (no ``cuInit``, no
    card touched), as the reference exports its plugin's PJRT attributes;
    the install dir by env, as the DaemonSet sets it."""
    shutil.copy(port_bins / "libfake-cuda.so", tmp_path / "libcuda.so.1")
    p = run(port_bins, "gpu-metrics-agent", "--once", "--install-dir",
            tmp_path, "--device-glob", tmp_path / "none*", "--nvml", "none")
    assert p.returncode == 0, p.stderr
    assert 'gpu_agent_driver_info{name="cuda_driver_version",' \
        'value="12.8"} 1' in p.stdout
    p = run(port_bins, "gpu-metrics-agent", "--once", "--device-glob",
            tmp_path / "none*", "--nvml", "none",
            env={"DRIVER_INSTALL_DIR": str(tmp_path)})
    assert "gpu_agent_driver_loadable 1" in p.stdout


def test_metrics_agent_http_server(bins, trees):
    bodies = {}
    for s in SIDES:
        args = ["--port", "0", "--device-glob", glob_of(trees[s], s),
                "--install-dir", trees[s] / "host"]
        if s == "p":
            args += ["--nvml", "absent"]
        proc = subprocess.Popen(
            [str(bins[s] / binary(s, "metrics-agent")), *map(str, args)],
            stdout=subprocess.PIPE, text=True)
        try:
            line = proc.stdout.readline()
            port = int(line.rsplit(":", 1)[1])
            url = f"http://127.0.0.1:{port}"
            bodies[s] = urllib.request.urlopen(f"{url}/metrics",
                                               timeout=10).read().decode()
            assert urllib.request.urlopen(
                f"{url}/healthz", timeout=10).read().decode() == "ok\n"
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(f"{url}/nope", timeout=10)
        finally:
            proc.terminate()
            proc.wait(timeout=10)
        assert proc.returncode == 0   # SIGTERM ends the accept loop
    assert "gpu_agent_up 1" in bodies["p"]
    assert "gpu_agent_devices_total 2" in bodies["p"]
    assert page(bodies["p"]) == page(to_port(bodies["r"]))
    assert os.path.exists(trees["p"] / "nvidia0")


def test_an_nvml_that_fails_lists_no_card(port_bins, tmp_path):
    """NVML loads but its driver does not answer (``nvmlInit_v2`` fails):
    no node is present, as ``NvmlSource.minor_numbers`` rules."""
    from torch_fake_nvml import FAKE_NVML_C, compile_c
    from tpu_operator_torch.utils.nvml import Library, NvmlSource
    src = FAKE_NVML_C.replace("int nvmlInit_v2(void) { return 0; }",
                              "int nvmlInit_v2(void) { return 9; }")
    assert src != FAKE_NVML_C
    broken = compile_c(tmp_path, "libnvidia-ml.so.1", src)
    root = side_tree(tmp_path, "p")
    out = scrape(port_bins, "p", root, "--nvml", broken).stdout
    assert "gpu_agent_devices_total 0" in out
    assert f'gpu_agent_device_present{{device="{root}/nvidia0"}} 0' in out
    assert "gpu_agent_device_attr" not in out
    assert "driver_info" not in out
    assert NvmlSource(Library(broken)).minor_numbers() == set()
