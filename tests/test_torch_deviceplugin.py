"""The port's GPU device plugin against the reference's TPU plugin: real
gRPC over unix sockets, a fake kubelet, and fixture device trees.

Each scenario of ``tests/test_deviceplugin.py:71-185`` runs on both
plugins with the same requests; what they answer is compared exactly after
mapping the reference's names onto the port's (``NAME_MAP``). The fixture
``/dev`` holds ``accel0..3`` for the reference and ``nvidia0..3``,
``nvidiactl`` and ``nvidia-uvm`` for the port. Then the chain the health
file carries: the port's monitor flags GPU 1, and the port's plugin
advertises ``nvidia1`` Unhealthy.

Reference tests without a port counterpart: ``test_deviceplugin.py:192``
(``test_bounds_stable_after_chip_vanishes``), ``:215``
(``test_host_chips_inferred_lazily_after_empty_start``) and ``:237``
(``test_host_chips_frozen_at_start_not_first_allocate``) test the ICI
bounds and the host-chip freeze, which no CUDA runtime reads and the port
leaves out; ``:264-300`` (slice-aware advertising) wait for the MIG
manager.
"""

import json
import os
import re
import threading
from concurrent import futures

import grpc
import pytest

import tpu_operator.deviceplugin.discovery as ref_discovery
import tpu_operator.deviceplugin.plugin as ref_plugin
import tpu_operator.deviceplugin.wire as ref_wire
import tpu_operator_torch.deviceplugin.discovery as port_discovery
import tpu_operator_torch.deviceplugin.plugin as port_plugin
import tpu_operator_torch.deviceplugin.wire as port_wire
from tpu_operator.deviceplugin import deviceplugin_pb2 as ref_pb
from tpu_operator_torch.deviceplugin import deviceplugin_pb2 as port_pb
from torch_fake_nvml import FakeLibrary, device, nvml_so  # noqa: F401

NAME_MAP = (
    (r"\baccel(\d+)", r"nvidia\1"),
    (r"tpu\.dev/chip", "nvidia.com/gpu"),
    (r"tpu-dev-chip\.sock", "nvidia-com-gpu.sock"),
    (r"TPU_VISIBLE_CHIPS", "NVIDIA_VISIBLE_DEVICES"),
    (r"/r/", "/p/"),
)


def to_port(obj):
    text = json.dumps(obj, sort_keys=True)
    for pat, repl in NAME_MAP:
        text = re.sub(pat, repl, text)
    return json.loads(text)


SIDES = {
    "r": (ref_discovery.ChipDiscovery, ref_plugin.TpuDevicePlugin, ref_wire,
          ref_pb, "accel"),
    "p": (port_discovery.GpuDiscovery, port_plugin.GpuDevicePlugin,
          port_wire, port_pb, "nvidia"),
}
LIBCUDA = "/usr/lib/x86_64-linux-gnu/libcuda.so.1"


def test_descriptor_is_the_references_and_the_names_are_the_gpus():
    """The copy's serialized descriptor is byte-identical, so both load
    into protobuf's one pool and share their classes."""
    assert port_pb.DESCRIPTOR.serialized_pb == ref_pb.DESCRIPTOR.serialized_pb
    assert port_pb.AllocateResponse is ref_pb.AllocateResponse
    assert port_plugin.RESOURCE_NAME == port_plugin.CDI_KIND == \
        "nvidia.com/gpu"
    assert port_plugin.CONTROL_NODES == ("nvidiactl", "nvidia-uvm",
                                         "nvidia-uvm-tools")
    assert to_port("TPU_VISIBLE_CHIPS") == port_plugin.VISIBLE_DEVICES_ENV


def _devroot(tmp_path, side):
    d = tmp_path / side / "dev"
    d.mkdir(parents=True)
    prefix = SIDES[side][4]
    for i in range(4):
        (d / f"{prefix}{i}").write_text("")
    if side == "p":
        for name in ("nvidiactl", "nvidia-uvm", "nvidia-modeset"):
            (d / name).write_text("")
    return str(d)


def _plugin(tmp_path, side, **kw):
    discovery_cls, plugin_cls = SIDES[side][:2]
    plugin_dir = tmp_path / side / "plugins"
    plugin_dir.mkdir(parents=True, exist_ok=True)
    health_file = kw.pop("health_file", None)
    if side == "r":
        kw.setdefault("libtpu_host_path", "/home/kubernetes/bin/libtpu.so")
        kw.setdefault("accelerator_type", "v5p-8")
    else:
        kw.setdefault("driver_lib_host_path", LIBCUDA)
    return plugin_cls(plugin_dir=str(plugin_dir),
                      discovery=discovery_cls(_devroot(tmp_path, side),
                                              health_file=health_file),
                      poll_seconds=0.1, **kw)


@pytest.fixture
def plugins(tmp_path):
    pls = {side: _plugin(tmp_path, side) for side in SIDES}
    for pl in pls.values():
        pl.start()
    yield pls
    for pl in pls.values():
        pl.stop()


class FakeKubelet:
    def __init__(self, plugin_dir, wire, pb):
        self.requests = []
        self.event = threading.Event()
        self.pb = pb
        self.server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        self.server.add_generic_rpc_handlers(
            (wire.registration_handler(self._register),))
        self.socket = os.path.join(plugin_dir, wire.KUBELET_SOCKET)
        self.server.add_insecure_port(f"unix://{self.socket}")
        self.server.start()

    def _register(self, request, context):
        self.requests.append(request)
        self.event.set()
        return self.pb.Empty()

    def stop(self):
        self.server.stop(0).wait()


def _each(plugins, fn):
    """``fn(side, plugin, stub)`` on both plugins; the reference's answer
    mapped onto the port's names, and the port's."""
    out = {}
    for side, pl in plugins.items():
        stub = SIDES[side][2].DevicePluginStub(pl.socket_path)
        try:
            out[side] = fn(side, pl, stub)
        finally:
            stub.close()
    return to_port(out["r"]), out["p"]


def test_register_with_kubelet(plugins):
    def register(side, pl, stub):
        kubelet = FakeKubelet(pl.plugin_dir, *SIDES[side][2:4])
        try:
            pl.register()
            assert kubelet.event.wait(5)
            req = kubelet.requests[0]
            return [req.version, req.resource_name, req.endpoint,
                    req.options.get_preferred_allocation_available,
                    req.options.pre_start_required,
                    req.endpoint == os.path.basename(pl.socket_path)]
        finally:
            kubelet.stop()
    ref, port = _each(plugins, register)
    assert port == ref
    assert port[:3] == ["v1beta1", "nvidia.com/gpu", "nvidia-com-gpu.sock"]


def _listing(response):
    return [[d.id, d.health] for d in response.devices]


def test_list_and_watch_initial_inventory(plugins):
    def first(side, pl, stub):
        stream = stub.list_and_watch(timeout=5)
        got = _listing(next(iter(stream)))
        stream.cancel()
        return got
    ref, port = _each(plugins, first)
    assert port == ref == [[f"nvidia{i}", "Healthy"] for i in range(4)]


def test_list_and_watch_health_transition(plugins):
    def transition(side, pl, stub):
        stream = stub.list_and_watch(timeout=5)
        it = iter(stream)
        next(it)
        os.unlink(os.path.join(pl.discovery.dev_root,
                               f"{SIDES[side][4]}3"))
        pl.notify_changed()
        got = _listing(next(it))
        stream.cancel()
        return got
    ref, port = _each(plugins, transition)
    assert port == ref == [[f"nvidia{i}", "Healthy"] for i in range(3)]


def _allocation(car):
    return {"devices": [[d.container_path, d.host_path, d.permissions]
                        for d in car.devices],
            "envs": dict(car.envs),
            "mounts": [[m.container_path, m.host_path, m.read_only]
                       for m in car.mounts],
            "cdi": [c.name for c in car.cdi_devices]}


@pytest.mark.parametrize("ids", [["0", "1"], ["1", "2"], ["3", "0", "2"]])
def test_allocate_device_strategy(plugins, ids):
    def allocate(side, pl, stub):
        prefix = SIDES[side][4]
        resp = stub.allocate([[f"{prefix}{i}" for i in ids]])
        return _allocation(resp.container_responses[0])
    ref, port = _each(plugins, allocate)
    cards = len(ids)
    # the cards' nodes and the visible list as the reference gives them
    assert port["devices"][:cards] == ref["devices"]
    env = port_plugin.VISIBLE_DEVICES_ENV
    assert port["envs"] == {env: ref["envs"][env]} \
        == {env: ",".join(sorted(ids))}
    # then what a CUDA container needs and a TPU one does not: the
    # control nodes that exist, and the driver library, read-only
    root = plugins["p"].discovery.dev_root
    assert port["devices"][cards:] == [
        [os.path.join(root, n)] * 2 + ["rw"]
        for n in ("nvidiactl", "nvidia-uvm")]
    assert port["mounts"] == [[LIBCUDA, LIBCUDA, True]] and not port["cdi"]
    assert ref["mounts"][0][2] is True


def test_allocate_cdi_strategy(tmp_path):
    pls = {side: _plugin(tmp_path, side, strategy="cdi") for side in SIDES}
    for pl in pls.values():
        pl.start()
    try:
        ref, port = _each(pls, lambda side, pl, stub: _allocation(
            stub.allocate([[f"{SIDES[side][4]}2", f"{SIDES[side][4]}0"]])
            .container_responses[0]))
    finally:
        for pl in pls.values():
            pl.stop()
    # the reference names a device by its id, the NVIDIA toolkit's CDI
    # spec by its index
    assert ref["cdi"] == ["nvidia.com/gpu=nvidia2", "nvidia.com/gpu=nvidia0"]
    assert port["cdi"] == ["nvidia.com/gpu=2", "nvidia.com/gpu=0"]
    assert port["envs"] == {"NVIDIA_VISIBLE_DEVICES": "0,2"}
    assert not port["devices"] and not port["mounts"]
    assert not ref["devices"] and not ref["mounts"]


def test_allocate_unknown_or_unhealthy_device_rejected(tmp_path):
    hf = tmp_path / "health"
    hf.write_text("1\n")
    pls = {side: _plugin(tmp_path, side, health_file=str(hf))
           for side in SIDES}
    for pl in pls.values():
        pl.start()

    def reject(side, pl, stub):
        codes = []
        for did in ("9", "1"):
            with pytest.raises(grpc.RpcError) as ei:
                stub.allocate([[f"{SIDES[side][4]}{did}"]])
            codes.append([ei.value.code().name, ei.value.details()])
        return codes
    try:
        ref, port = _each(pls, reject)
    finally:
        for pl in pls.values():
            pl.stop()
    assert port == ref
    assert port[0] == ["INVALID_ARGUMENT",
                       "unknown or unhealthy device 'nvidia9'"]


@pytest.mark.parametrize("avail,must,size", [
    ([0, 2, 3], [], 2), ([0, 1, 2, 3], [], 3), ([3, 1, 0], [1], 2),
    ([2, 0], [], 3), ([0, 1, 3], [3], 1)])
def test_preferred_allocation_contiguous(plugins, avail, must, size):
    def prefer(side, pl, stub):
        p = SIDES[side][4]
        resp = stub.get_preferred_allocation(
            [f"{p}{i}" for i in avail], [f"{p}{i}" for i in must], size)
        return list(resp.container_responses[0].device_ids)
    ref, port = _each(plugins, prefer)
    assert port == ref


def test_options_and_prestart(plugins):
    def options(side, pl, stub):
        o = stub.get_options()
        return [o.pre_start_required, o.get_preferred_allocation_available]
    ref, port = _each(plugins, options)
    assert port == ref == [False, True]
    assert isinstance(plugins["p"].PreStartContainer(None, None),
                      port_pb.PreStartContainerResponse)


def test_health_file_marks_unhealthy(tmp_path):
    hf = tmp_path / "unhealthy"
    hf.write_text("2\n")
    out = {}
    for side, (discovery_cls, *_rest) in SIDES.items():
        devs = discovery_cls(_devroot(tmp_path, side),
                             health_file=str(hf)).scan()
        out[side] = [[d.id, d.path, d.index, d.health] for d in devs]
    assert out["p"] == to_port(out["r"])
    assert [d[3] for d in out["p"]] == ["Healthy", "Healthy", "Unhealthy",
                                        "Healthy"]


def test_strategy_checked():
    with pytest.raises(ValueError, match="device|cdi"):
        port_plugin.GpuDevicePlugin(strategy="mig")


def test_cli_help_smoke():
    from tpu_operator_torch.cli import device_plugin
    with pytest.raises(SystemExit) as ei:
        device_plugin.main(["--help"])
    assert ei.value.code == 0


def test_cli_builds_the_plugin_it_is_asked_for(tmp_path, monkeypatch):
    from tpu_operator_torch.cli import device_plugin
    built = {}

    def run_forever(self):
        built["plugin"] = self
    monkeypatch.setattr(port_plugin.GpuDevicePlugin, "run_forever",
                        run_forever)
    monkeypatch.setenv("GPU_HEALTH_FILE", str(tmp_path / "h"))
    assert device_plugin.main([
        "--dev-root", str(tmp_path), "--strategy", "cdi",
        "--driver-lib-path", LIBCUDA, "--plugin-dir", str(tmp_path)]) == 0
    pl = built["plugin"]
    assert (pl.resource_name, pl.strategy, pl.driver_lib_host_path,
            pl.discovery.dev_root, pl.discovery.health_file,
            pl.discovery.device_glob) == (
        "nvidia.com/gpu", "cdi", LIBCUDA, str(tmp_path),
        str(tmp_path / "h"), "nvidia[0-9]*")


def test_monitor_flags_a_gpu_and_the_plugin_advertises_it_unhealthy(
        tmp_path):
    """The chain the health file carries: a probe fails GPU 1 past the
    debounce window, the monitor writes the file, and ListAndWatch re-sends
    the inventory with ``nvidia1`` Unhealthy."""
    from tpu_operator_torch.health.monitor import HealthMonitor
    from tpu_operator_torch.health.probes import ProbeResult
    from tpu_operator_torch.kube.fake import FakeClient

    class Probe:
        name = "fake"
        results = []

        def run(self):
            return self.results

    now = [1_700_000_000.0]
    hf = tmp_path / "run" / "gpu-health"
    client = FakeClient()
    client.add_node("n0", {})
    probe = Probe()
    mon = HealthMonitor(client, "n0", [probe], health_file=str(hf),
                        unhealthy_after_s=60, healthy_after_s=120,
                        clock=lambda: now[0])
    pl = _plugin(tmp_path, "p", health_file=str(hf))
    pl.start()
    stub = port_wire.DevicePluginStub(pl.socket_path)
    try:
        it = iter(stub.list_and_watch(timeout=5))
        assert [h for _, h in _listing(next(it))] == ["Healthy"] * 4
        probe.results = [ProbeResult("fake", False, "ecc", 1)]
        mon.reconcile_once()
        now[0] += 61
        rep = mon.reconcile_once()
        assert rep["unhealthy_gpus"] == [1] and hf.read_text() == "1\n"
        pl.notify_changed()
        assert _listing(next(it)) == [
            ["nvidia0", "Healthy"], ["nvidia1", "Unhealthy"],
            ["nvidia2", "Healthy"], ["nvidia3", "Healthy"]]
        with pytest.raises(grpc.RpcError):
            stub.allocate([["nvidia1"]])
        probe.results = [ProbeResult("fake", True, "", 1)]
        mon.reconcile_once()
        now[0] += 121
        mon.reconcile_once()
        pl.notify_changed()
        assert [h for _, h in _listing(next(it))] == ["Healthy"] * 4
    finally:
        stub.close()
        pl.stop()


def test_health_and_discovery_import_without_grpc():
    """A fresh interpreter that imports the health monitor, the device scan
    and feature discovery loads neither gRPC nor protobuf: the card's
    machine has neither."""
    import subprocess
    import sys
    code = (
        "import sys\n"
        "import tpu_operator_torch.health, "
        "tpu_operator_torch.deviceplugin.discovery, "
        "tpu_operator_torch.operands.feature_discovery, "
        "tpu_operator_torch.cli.health_monitor\n"
        "from tpu_operator_torch.deviceplugin import GpuDiscovery\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'grpc' "
        "or m.startswith('google.protobuf')))\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         env=dict(os.environ, PYTHONPATH=root),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


class _NoNvml:
    """A source for a node without ``libnvidia-ml.so.1``."""

    def minor_numbers(self):
        return None


@pytest.mark.parametrize("side_nodes", [1, 4])
def test_presence_without_nvml_is_the_references(tmp_path, side_nodes):
    """Without NVML the port keeps the reference's rule (readable and
    writable) exactly."""
    out = {}
    for side, (discovery_cls, *_rest) in SIDES.items():
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in range(side_nodes):
            (d / f"{SIDES[side][4]}{i}").write_text("")
        kw = {"nvml": _NoNvml()} if side == "p" else {}
        devs = discovery_cls(str(d), **kw).scan()
        out[side] = [[x.id, x.path, x.index, x.health] for x in devs]
    assert out["p"] == to_port(out["r"])
    assert all(x[3] == "Healthy" for x in out["p"])


def test_reference_calls_healthy_a_card_nvml_does_not_list(tmp_path,
                                                           nvml_so):
    """F7, the deliberate divergence. A fixture ``/dev`` with two nodes,
    both readable and writable; the fake NVML lists one of them (minors 0
    and 2 of a host whose container sees ``nvidia0`` and ``nvidia1``). The
    reference's ``ChipDiscovery`` reads permission bits and calls both
    Healthy; the port calls ``nvidia1`` Unhealthy, and the presence probe
    and the device plugin's listing, which scan through it, follow."""
    from tpu_operator_torch.health.probes import DevicePresenceProbe
    from tpu_operator_torch.utils.nvml import Library, NvmlSource
    roots = {}
    for side in SIDES:
        d = tmp_path / side / "dev"
        d.mkdir(parents=True)
        for i in range(2):
            (d / f"{SIDES[side][4]}{i}").write_text("")
        roots[side] = str(d)
    ref = ref_discovery.ChipDiscovery(roots["r"]).scan()
    assert [c.health for c in ref] == ["Healthy", "Healthy"]
    nvml = NvmlSource(Library(nvml_so))
    discovery = port_discovery.GpuDiscovery(roots["p"], nvml=nvml)
    port = discovery.scan()
    assert [(d.id, d.health) for d in port] == [
        ("nvidia0", "Healthy"), ("nvidia1", "Unhealthy")]
    results = DevicePresenceProbe(discovery).run()
    assert [(r.gpu_index, r.healthy) for r in results] == [(0, True),
                                                           (1, False)]
    plugin = port_plugin.GpuDevicePlugin(
        plugin_dir=str(tmp_path / "plugins"), discovery=discovery)
    assert [(d.id, d.health) for d in plugin._device_list()] == [
        ("nvidia0", "Healthy"), ("nvidia1", "Unhealthy")]


def test_an_nvml_that_fails_lists_no_card(tmp_path):
    """NVML loads but its driver does not answer: no node is present, as
    no CUDA program could use one."""
    from tpu_operator_torch.utils.nvml import NvmlError, NvmlSource

    class Broken(FakeLibrary):
        def init(self):
            raise NvmlError("nvmlInit_v2", 9)    # DRIVER_NOT_LOADED

    d = tmp_path / "dev"
    d.mkdir()
    (d / "nvidia0").write_text("")
    assert NvmlSource(Broken([device(0)])).minor_numbers() == set()
    assert NvmlSource(FakeLibrary([device(0)])).minor_numbers() == {0}
    devs = port_discovery.GpuDiscovery(
        str(d), nvml=NvmlSource(Broken([device(0)]))).scan()
    assert [x.health for x in devs] == ["Unhealthy"]
