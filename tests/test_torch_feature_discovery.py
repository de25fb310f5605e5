"""The port's GPU feature discovery against the reference's TPU feature
discovery, on the fake cluster.

Each scenario of ``tests/test_operands.py:42-80, 249, 501`` is written once
in neutral terms (device nodes, an accelerator fact from the GKE label or
the host, worker identity, a driver library that exports its entry point,
stale labels) and given to each package in its own words: ``accel<N>`` and
``nvidia<N>`` device nodes, GKE's TPU or GPU label, ``TPU_WORKER_ID`` or
``WORKER_ID``, a ``libtpu.so`` exporting ``GetPjrtApi`` or a
``libcuda.so.1`` exporting ``cuInit``. What each publishes (labels, node
writes, the NFD file, the worker-env file) must be equal after mapping the
reference's names onto the port's (``NAME_MAP``). Two facts differ by
design and are held apart: the accelerator's value (the TPU generation;
the GPU's product name) and ``tpu.dev/topology``, which has no GPU
counterpart.

Tolerance: exact equality.
"""

import json
import re

import pytest

import tpu_operator.kube.fake as ref_fake
import tpu_operator.operands.feature_discovery as ref_fd
import tpu_operator_torch.kube.fake as port_fake
import tpu_operator_torch.operands.feature_discovery as port_fd
from tpu_operator_torch.utils import nvml
from torch_fake_nvml import FakeLibrary, compile_c, device

NAME_MAP = (
    (r"tpu\.dev/chip\.present", "nvidia.com/gpu.present"),
    (r"tpu\.dev/chip\.count", "nvidia.com/gpu.count"),
    (r"tpu\.dev/type", "nvidia.com/gpu.product"),
    (r"tpu\.dev/worker-id", "nvidia.com/worker-id"),
    (r"tpu\.dev/hosts", "nvidia.com/hosts"),
    (r"tpu\.dev/pjrt", "nvidia.com/cuda.driver"),
    (r"TPU_WORKER_ID", "WORKER_ID"),
    (r"TPU_WORKER_HOSTNAMES", "WORKER_HOSTNAMES"),
    (r"tpu-feature-discovery", "gpu-feature-discovery"),
)
PRODUCT = "nvidia.com/gpu.product"


def to_port(obj):
    text = json.dumps(obj, sort_keys=True)
    for pat, repl in NAME_MAP:
        text = re.sub(pat, repl, text)
    return json.loads(text)


def test_name_map_is_the_managed_set():
    assert to_port([ref_fd.PREFIX + k for k in ref_fd.FeatureDiscovery
                    .MANAGED if k != "topology"]) == \
        [port_fd.PREFIX + k for k in port_fd.FeatureDiscovery.MANAGED]
    assert port_fd.GKE_ACCELERATOR_LABEL == "cloud.google.com/gke-accelerator"
    assert port_fd.product_label("NVIDIA H100 80GB HBM3") == \
        "NVIDIA-H100-80GB-HBM3"


@pytest.fixture(scope="session")
def driver_libs(tmp_path_factory):
    """Driver roots: one whose library exports the entry point (``libtpu.so``
    with ``GetPjrtApi``, ``usr/lib64/libcuda.so.1`` with ``cuInit``), one
    whose library does not, and one without a library."""
    base = tmp_path_factory.mktemp("driver-libs")
    roots = {}
    for kind, symbol in (("exports", "{sym}"), ("other", "other_{sym}")):
        ref = base / "ref" / kind
        port = base / "port" / kind / "usr" / "lib64"
        ref.mkdir(parents=True)
        port.mkdir(parents=True)
        compile_c(ref, "libtpu.so", "int %s(void) { return 0; }"
                  % symbol.format(sym="GetPjrtApi"))
        compile_c(port, "libcuda.so.1", "int %s(unsigned f) { return 0; }"
                  % symbol.format(sym="cuInit"))
        roots[kind] = (str(ref), str(base / "port" / kind))
    roots["none"] = (str(base / "ref" / "none"), str(base / "port" / "none"))
    return roots


# neutral scenarios: devices, accelerator fact (where from), worker
# identity, driver library, stale labels already on the node
SCENARIOS = {
    # test_operands.py:42: facts from the GKE node-pool label
    "gke": dict(devices=4, accel="label"),
    # :55: facts from the host (TPU VM env / NVML) and the worker env
    "host": dict(devices=4, accel="host", worker="2",
                 hosts="h0,h1,h2,h3", driver="exports"),
    # :68: a fact that is gone retracts its label, present stays
    "stale": dict(devices=4, accel="label", driver="other",
                  stale={"pjrt": "true", "worker-id": "7"}),
    # devices gone: count retracted, present kept
    "no devices": dict(devices=0, accel=None,
                       stale={"chip.count": "8", "chip.present": "true"}),
    # nothing at all: no labels
    "bare": dict(devices=0, accel=None, worker="", hosts=""),
}


def _inputs(side, sc, tmp_path, driver_libs):
    """One package's FeatureDiscovery arguments and node labels for a
    neutral scenario."""
    devdir = tmp_path / side / "dev"
    devdir.mkdir(parents=True)
    prefix = "accel" if side == "ref" else "nvidia"
    for i in range(sc["devices"]):
        (devdir / f"{prefix}{i}").touch()
    if side == "port":
        for ctl in ("nvidiactl", "nvidia-uvm"):
            (devdir / ctl).touch()
    labels = {}
    env = {}
    if sc["accel"] == "label":
        labels[ref_fd.GKE_ACCELERATOR_LABEL if side == "ref"
               else port_fd.GKE_ACCELERATOR_LABEL] = \
            "tpu-v5p-slice" if side == "ref" else "nvidia-h100-80gb"
    if sc["accel"] == "host" and side == "ref":
        env["TPU_ACCELERATOR_TYPE"] = "v5p-8"
    # NVML lists the fixture's cards (presence is NVML's list, F7/F9);
    # the product comes from it only where no node label names one
    cards = [device(i) for i in range(sc["devices"])]
    names = ("TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES") if side == "ref" \
        else ("WORKER_ID", "WORKER_HOSTNAMES")
    for name, key in zip(names, ("worker", "hosts")):
        if key in sc:
            env[name] = sc[key]
    for k, v in sc.get("stale", {}).items():
        labels[ref_fd.PREFIX + k] = v
    if side == "port":
        labels = to_port(labels)
    ref_root, port_root = driver_libs[sc.get("driver", "none")]
    pattern = "accel*" if side == "ref" else "nvidia[0-9]*"
    kw = dict(device_glob=str(devdir / pattern), env=env,
              nfd_feature_dir=str(tmp_path / side / "features.d"),
              worker_env_file=str(tmp_path / side / "worker-env"))
    if side == "ref":
        kw["install_dir"] = ref_root
    else:
        kw.update(driver_root=port_root,
                  nvml=nvml.NvmlSource(FakeLibrary(cards)))
    return kw, labels


def _published(side, sc, tmp_path, driver_libs):
    fake, fd_mod = (ref_fake, ref_fd) if side == "ref" else \
        (port_fake, port_fd)
    kw, labels = _inputs(side, sc, tmp_path, driver_libs)
    client = fake.FakeClient()
    client.add_node("n1", labels)
    fd = fd_mod.FeatureDiscovery(client, node_name="n1", **kw)
    out = []
    for _ in range(2):       # the second pass is converged
        desired = fd.apply_once()
        out.append({
            "desired": desired,
            "labels": dict(client.get("Node", "n1").labels),
            "updates": sum(a[0] == "update" for a in client.actions),
            "nfd": sorted((tmp_path / side / "features.d").iterdir())[0]
            .read_text(),
            "worker_env": (tmp_path / side / "worker-env").read_text()})
    return out


def _lines(text, drop=(), product=None):
    """The lines of a KEY=VALUE file, sorted (each package sorts by its own
    names)."""
    out = []
    for line in text.splitlines():
        if line.startswith(drop):
            continue
        if product and line.startswith(PRODUCT + "="):
            line = f"{PRODUCT}={product}"
        out.append(line + "\n")
    return "".join(sorted(out))


def _comparable(published):
    """Drop what differs by design: the GKE label itself, the topology
    fact and the worker-env lines the reference stages for libtpu; the
    product's value becomes a placeholder."""
    out = []
    for p in published:
        q = dict(p)
        for key in ("desired", "labels"):
            q[key] = {k: "<product>" if k == PRODUCT else v
                      for k, v in p[key].items()
                      if not k.startswith("cloud.google.com/")
                      and k != "tpu.dev/topology"}
        q["nfd"] = _lines(p["nfd"], ("tpu.dev/topology=",), "<product>")
        q["worker_env"] = _lines(p["worker_env"], (
            "TPU_ACCELERATOR_TYPE=", "TPU_TOPOLOGY=", "MEGASCALE_"))
        out.append(q)
    return out


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_feature_discovery_publishes_what_the_reference_does(
        tmp_path, driver_libs, name):
    sc = SCENARIOS[name]
    ref = _published("ref", sc, tmp_path, driver_libs)
    port = _published("port", sc, tmp_path, driver_libs)
    assert _comparable(port) == _comparable(to_port(ref))
    # the converged pass writes nothing (test_operands.py:80)
    assert port[1]["updates"] == port[0]["updates"]


def test_scenarios_reach_the_gpu_labels(tmp_path, driver_libs):
    def desired(name):
        return _published("port", SCENARIOS[name], tmp_path / name,
                          driver_libs)[0]
    gke = desired("gke")
    assert gke["desired"] == {"nvidia.com/gpu.present": "true",
                              "nvidia.com/gpu.product": "nvidia-h100-80gb",
                              "nvidia.com/gpu.count": "4"}
    host = desired("host")
    assert host["desired"] == {
        "nvidia.com/gpu.present": "true",
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
        "nvidia.com/gpu.count": "4", "nvidia.com/worker-id": "2",
        "nvidia.com/hosts": "4", "nvidia.com/cuda.driver": "true"}
    assert host["worker_env"] == ("# written by gpu-feature-discovery\n"
                                  "WORKER_HOSTNAMES=h0,h1,h2,h3\n"
                                  "WORKER_ID=2\n")
    assert "nvidia.com/gpu.count=4\n" in host["nfd"]
    stale = desired("stale")["labels"]
    assert "nvidia.com/cuda.driver" not in stale
    assert "nvidia.com/worker-id" not in stale
    gone = desired("no devices")["labels"]
    assert gone == {"nvidia.com/gpu.present": "true"}
    assert desired("bare")["desired"] == {}


def test_gke_label_wins_over_nvml(tmp_path):
    client = port_fake.FakeClient()
    client.add_node("n1", {port_fd.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"})
    fd = port_fd.FeatureDiscovery(
        client, node_name="n1", device_glob=str(tmp_path / "nvidia*"),
        driver_root=str(tmp_path), env={},
        nvml=nvml.NvmlSource(FakeLibrary([device(0, "NVIDIA A100")])))
    assert fd.discover(client.get("Node", "n1").labels)[PRODUCT] == \
        "nvidia-h100-80gb"
    assert fd.discover({})[PRODUCT] == "NVIDIA-A100"


def test_nvml_failure_leaves_the_product_unknown(tmp_path):
    lib = FakeLibrary([device(0)])

    def fail():
        raise nvml.NvmlError("nvmlInit_v2", 9, "Driver Not Loaded")
    lib.init = fail
    fd = port_fd.FeatureDiscovery(
        port_fake.FakeClient(), node_name="n1",
        device_glob=str(tmp_path / "nvidia*"), driver_root=str(tmp_path),
        env={}, nvml=nvml.NvmlSource(lib))
    assert fd.discover({}) == {}


def test_cli_once(tmp_path, capsys, monkeypatch):
    from tpu_operator_torch.cli import feature_discovery as cli
    state = tmp_path / "state.json"
    port_fake.FileBackedFakeClient(str(state)).add_node(
        "n1", {port_fd.GKE_ACCELERATOR_LABEL: "nvidia-h100-80gb"})
    (tmp_path / "nvidia0").touch()
    monkeypatch.setenv("GPU_DEVICE_GLOB", str(tmp_path / "nvidia[0-9]*"))
    monkeypatch.setenv("NVIDIA_DRIVER_ROOT", str(tmp_path))

    def no_nvml(path=nvml.SONAME):
        raise OSError(f"{path}: cannot open shared object file")
    monkeypatch.setattr(nvml, "Library", no_nvml)
    assert cli.main(["--client", f"fake:{state}", "--node-name", "n1",
                     "--once"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"nvidia.com/gpu.present": "true",
                    "nvidia.com/gpu.product": "nvidia-h100-80gb",
                    "nvidia.com/gpu.count": "1"}
    node = port_fake.FileBackedFakeClient(str(state)).get("Node", "n1")
    assert node.labels["nvidia.com/gpu.count"] == "1"


def test_count_is_of_the_cards_present(tmp_path):
    """F9: a node the container cannot open (NVML does not list it) is no
    card of this node. The reference counts every node its glob matches."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in (0, 1):
        (dev / f"nvidia{i}").touch()
        (dev / f"accel{i}").touch()
    port = port_fake.FakeClient()
    port.add_node("n1", {})
    got = port_fd.FeatureDiscovery(
        port, node_name="n1", device_glob=str(dev / "nvidia[0-9]*"),
        env={}, nvml=nvml.NvmlSource(FakeLibrary([device(1)]))).discover({})
    assert got["nvidia.com/gpu.count"] == "1"
    ref = ref_fake.FakeClient()
    ref.add_node("n1", {})
    want = ref_fd.FeatureDiscovery(ref, node_name="n1",
                                   device_glob=str(dev / "accel*"),
                                   env={}).discover({})
    assert want["tpu.dev/chip.count"] == "2"
