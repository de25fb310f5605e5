"""The port's health monitor against the reference's, on the same inputs.

``health/hysteresis.py`` and ``health/monitor.py`` use no device: each
scenario runs the same observations through both copies and compares what
they publish exactly, after mapping the reference's TPU names onto the
port's GPU names (``NAME_MAP``). The probes run on fixture trees in each
package's layout built from one seeded description, and the port's NVML
source over a fake ``Library``. The HBM sweep runs K1's plain version on
the CPU; the reference's sweep raises ``TypeError`` there (F6: it compares
its ``HbmReport`` with a float), the port's gives one result.

Tolerance: exact equality throughout (no arithmetic differs).
"""

import json
import re

import numpy as np
import pytest
import torch

import tpu_operator.api.v1alpha1 as ref_api
import tpu_operator.deviceplugin.discovery as ref_discovery
import tpu_operator.health.hysteresis as ref_hysteresis
import tpu_operator.health.monitor as ref_monitor
import tpu_operator.health.probes as ref_probes
import tpu_operator.kube.fake as ref_fake
import tpu_operator_torch.api.v1alpha1 as port_api
import tpu_operator_torch.deviceplugin.discovery as port_discovery
import tpu_operator_torch.health.hysteresis as port_hysteresis
import tpu_operator_torch.health.monitor as port_monitor
import tpu_operator_torch.health.probes as port_probes
import tpu_operator_torch.kube.fake as port_fake
from tpu_operator_torch.ops import hbm as port_hbm
from tpu_operator_torch.utils import nvml
from torch_fake_nvml import (FAKE_NVML_ATTRIBUTES, GPU_IS_LOST,  # noqa: F401
                             INVALID_ARGUMENT, NOT_SUPPORTED, FakeLibrary,
                             device, nvml_so)

# the reference's published names → the port's, applied in order to the
# JSON text of what the reference published
NAME_MAP = (
    (r"tpu\.dev/TPUHealthy", "nvidia.com/GPUHealthy"),
    (r"tpu\.dev/chip\.(\d+)\.health", r"nvidia.com/gpu.\1.health"),
    (r"\bchip (\d+):", r"GPU \1:"),
    (r"chip no longer observed", "GPU no longer observed"),
    (r"unhealthy_chips", "unhealthy_gpus"),
    (r"tpu_health_chips_unhealthy", "gpu_health_gpus_unhealthy"),
    (r"Chips currently", "GPUs currently"),
    (r"tpu_health_", "gpu_health_"),
    (r"no TPU device nodes", "no GPU device nodes"),
    (r"(\d+)/(\d+) chips visible", r"\1/\2 GPUs visible"),
    (r"\baccel(\d+)", r"nvidia\1"),
    (r"ici_link_up", "nvlink_up"),
    (r"ici-link", "nvlink"),
    (r"/ref/", "/port/"),
)


def to_port(obj):
    text = json.dumps(obj, sort_keys=True)
    for pat, repl in NAME_MAP:
        text = re.sub(pat, repl, text)
    return json.loads(text)


def test_name_map_covers_the_module_constants():
    assert to_port(ref_monitor.NODE_CONDITION_TYPE) == \
        port_monitor.NODE_CONDITION_TYPE
    assert to_port(ref_monitor.CHIP_ANNOTATION_FMT.format(3)) == \
        port_monitor.GPU_ANNOTATION_FMT.format(3)
    ref_names = [f.name for f in ref_monitor.HealthMonitorMetrics()
                 .registry.families()]
    port_names = [f.name for f in port_monitor.HealthMonitorMetrics()
                  .registry.families()]
    assert to_port(ref_names) == port_names
    assert port_api.HealthMonitorSpec().health_file == \
        port_api.DEFAULT_HEALTH_FILE == "/run/nvidia/gpu-health"
    assert port_discovery.GpuDiscovery.DEFAULT_GLOB == "nvidia[0-9]*"


class Clock:
    def __init__(self, t=1_700_000_000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


# == hysteresis ==============================================================

def _schedule(seed):
    rng = np.random.default_rng(seed)
    down, up = rng.uniform(5, 90), rng.uniform(5, 180)
    steps = [(float(dt), bool(raw), int(key)) for dt, raw, key in zip(
        rng.uniform(0.5, 30, 300), rng.random(300) < 0.5,
        rng.integers(0, 3, 300))]
    return float(down), float(up), steps


def _debounce(mod, down, up, steps):
    clk = Clock()
    d = mod.Debouncer(down, up, clock=clk)
    out = []
    for dt, raw, key in steps:
        clk.advance(dt)
        out.append(d.observe(key, raw))
    return out, sorted(d.keys()), [d.published(k) for k in range(4)]


@pytest.mark.parametrize("first_seed", range(0, 100, 10))
def test_debouncer_copies_agree_on_random_schedules(first_seed):
    """Ten seeded schedules a case, 300 observations over three keys each:
    both copies publish the same state at every step, and the port's never
    flips faster than its window."""
    for seed in range(first_seed, first_seed + 10):
        down, up, steps = _schedule(seed)
        ref = _debounce(ref_hysteresis, down, up, steps)
        port = _debounce(port_hysteresis, down, up, steps)
        assert port == ref, f"seed {seed}"
        published = {}
        history = {}
        t = 0.0
        for (dt, raw, key), new in zip(steps, port[0]):
            t += dt
            history.setdefault(key, []).append((t, raw))
            if new != published.get(key, True):
                start = t
                for ts, r in reversed(history[key]):
                    if r != new:
                        break
                    start = ts
                assert t - start >= (up if new else down), f"seed {seed}"
            published[key] = new


def test_debouncer_forget_and_windows_agree():
    for mod in (ref_hysteresis, port_hysteresis):
        d = mod.Debouncer(-5, "7", clock=Clock())
        assert (d.down_after_s, d.up_after_s) == (0.0, 7.0)
        d.observe(1, False)
        assert d.published(1) is False and d.keys() == [1]
        d.forget(1)
        assert d.keys() == [] and d.published(1) is True


# == health monitor ==========================================================

class FakeProbe:
    name = "fake"

    def __init__(self):
        self.results = []

    def run(self):
        return self.results


class Boom:
    name = "boom"

    def run(self):
        raise RuntimeError("probe exploded")


class Nameless:
    def __init__(self, result_cls):
        self.result_cls = result_cls

    def run(self):
        return [self.result_cls("anon", True, "", 0)]

    def __str__(self):      # the monitor's fallback for a missing name
        return "nameless"


PACKAGES = {
    "ref": (ref_fake, ref_monitor, ref_probes, "chip-health"),
    "port": (port_fake, port_monitor, port_probes, "gpu-health"),
}


def _drive(side, tmp_path, steps, extra_probes=()):
    """Run ``steps`` — (probe results as (probe, healthy, detail, index)
    tuples, seconds to advance after the pass) — through one package's
    monitor; return what it published after every pass."""
    fake, monitor, probes, file_name = PACKAGES[side]
    clk = Clock()
    client = fake.FakeClient()
    client.add_node("n0", {})
    probe = FakeProbe()
    health_file = tmp_path / side / file_name
    mon = monitor.HealthMonitor(
        client, "n0", [probe] + [p(probes.ProbeResult) if p is Nameless
                                 else p() for p in extra_probes],
        health_file=str(health_file), unhealthy_after_s=60,
        healthy_after_s=120, clock=clk, monotonic=clk)
    published = []
    for results, dt in steps:
        probe.results = [probes.ProbeResult(*r) for r in results]
        rep = mon.reconcile_once()
        node = client.get("Node", "n0")
        published.append({
            "report": rep,
            "conditions": node.get("status", "conditions", default=[]),
            "annotations": dict(node.annotations),
            "file": health_file.read_text() if health_file.exists()
            else None,
            "writes": [a[0] for a in client.actions],
            "metrics": mon.metrics.registry.render()})
        clk.advance(dt)
    return published


def _bad(i, detail="link down"):
    return ("fake", False, detail, i)


def _ok(i):
    return ("fake", True, "", i)


SCENARIOS = {
    # test_health.py:188: condition, annotations, file; recovery
    "publishes": [([_bad(2)], 61), ([_bad(2)], 0), ([_ok(2)], 121),
                  ([_ok(2)], 0)],
    # :238: 40 s bad / 80 s good cycles never flip the condition
    "flapping": ([([_bad(0, "flap")], 10)] * 4
                 + [([_ok(0)], 10)] * 8) * 20,
    # :259: converged passes write nothing
    "converged": [([_ok(0)], 30)] * 6,
    # :270: node-scoped failure
    "node-scoped": [([("fake", False, "no devices found", None)], 61),
                    ([("fake", False, "no devices found", None)], 0)],
    # :281: a GPU no probe reports goes unhealthy after the window
    "vanished": [([_ok(0), _ok(1)], 0), ([_ok(0)], 61), ([_ok(0)], 0)],
    # :299: a vanish shorter than the window is swallowed
    "vanish-short": [([_ok(0), _ok(1)], 0), ([_ok(0)], 60),
                     ([_ok(0), _ok(1)], 0)],
    # several GPUs and the node failing and recovering at once
    "mixed": [([_bad(0), _bad(3, "ecc"), ("fake", False, "x", None)], 30),
              ([_bad(0), _bad(3, "ecc"), ("fake", False, "x", None)], 31),
              ([_bad(0), _ok(3), ("fake", True, "", None)], 130),
              ([_ok(0), _ok(3), ("fake", True, "", None)], 121),
              ([_ok(0), _ok(3), ("fake", True, "", None)], 0)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_monitor_publishes_what_the_reference_does(tmp_path, name):
    ref = _drive("ref", tmp_path, SCENARIOS[name])
    port = _drive("port", tmp_path, SCENARIOS[name])
    assert port == to_port(ref)


def test_monitor_scenarios_reach_their_verdicts(tmp_path):
    """The port's published states in the scenarios, read as the reference
    tests read them."""
    cond = port_monitor.NODE_CONDITION_TYPE

    def ours(state):
        return [c for c in state["conditions"] if c["type"] == cond][0]

    pub = _drive("port", tmp_path / "a", SCENARIOS["publishes"])
    assert ours(pub[0])["status"] == "True"
    assert pub[1]["report"]["unhealthy_gpus"] == [2]
    assert ours(pub[1])["status"] == "False" and "GPU 2" in \
        ours(pub[1])["message"]
    assert pub[1]["annotations"]["nvidia.com/gpu.2.health"] == \
        "fake: link down"
    assert pub[1]["file"] == "2\n" and pub[3]["file"] == ""
    assert pub[3]["report"]["healthy"] is True
    assert "nvidia.com/gpu.2.health" not in pub[3]["annotations"]
    assert "gpu_health_condition_flips_total 2" in pub[3]["metrics"]
    flap = _drive("port", tmp_path / "b", SCENARIOS["flapping"])
    assert ours(flap[-1])["status"] == "True"
    conv = _drive("port", tmp_path / "c", SCENARIOS["converged"])
    assert len(conv[-1]["writes"]) == len(conv[0]["writes"])
    gone = _drive("port", tmp_path / "d", SCENARIOS["vanished"])
    assert gone[-1]["report"]["unhealthy_gpus"] == [1]
    assert "no longer observed" in gone[-1]["report"]["message"]


@pytest.mark.parametrize("seed", range(4))
def test_monitor_agrees_on_random_observations(tmp_path, seed):
    rng = np.random.default_rng(seed)
    steps = []
    for _ in range(60):
        results = []
        for i in range(4):
            if rng.random() < 0.15:
                continue            # this pass, no probe reports GPU i
            bad = rng.random() < 0.3
            results.append(("fake", not bad, "bad" if bad else "", i))
        if rng.random() < 0.2:
            results.append(("fake", False, "node", None))
        steps.append((results, float(rng.uniform(5, 70))))
    assert _drive("port", tmp_path, steps) == \
        to_port(_drive("ref", tmp_path, steps))


@pytest.mark.parametrize("extra", ["crash", "nameless"])
def test_probe_crash_and_nameless_probe_agree(tmp_path, extra):
    """test_health.py:220, :328: a crashing probe is a skip, not a fail; a
    probe without a name does not break the sweep."""
    extra_probes = (Boom,) if extra == "crash" else (Nameless,)
    steps = [([_ok(0)], 120)] * 3
    ref = _drive("ref", tmp_path, steps, extra_probes)
    port = _drive("port", tmp_path, steps, extra_probes)
    assert port == to_port(ref)
    assert port[-1]["report"]["healthy"] is True


# == probes ==================================================================

def _tree(tmp_path, side, spec):
    """Write one package's fixture tree from ``spec`` ({index: {attr:
    value}}): ``<root>/accel<N>/<attr>`` for the reference,
    ``<root>/nvidia<N>/<attr>`` for the port, plus entries neither may
    count as a device."""
    root = tmp_path / side
    prefix = "accel" if side == "ref" else "nvidia"
    for idx, attrs in spec.items():
        d = root / f"{prefix}{idx}"
        d.mkdir(parents=True)
        for attr, value in attrs.items():
            (d / attr).write_text(value)
    for junk in (f"{prefix}ctl", f"{prefix}-uvm", "other0"):
        (root / junk).mkdir(parents=True, exist_ok=True)
        (root / junk / "nvlink_up").write_text("0")
        (root / junk / "ici_link_up").write_text("0")
    (root / f"{prefix}9").parent.mkdir(parents=True, exist_ok=True)
    (root / f"{prefix}9").write_text("a file, not a directory")
    return str(root)


def _rows(results):
    return [[r.probe, r.healthy, r.detail,
             getattr(r, "chip_index", getattr(r, "gpu_index", None))]
            for r in results]


COUNTERS = nvml.COUNTERS


def _attr_spec(seed):
    """Seeded attribute values: link states in every spelling the reference
    reads, counters around their thresholds, some unreadable, some absent."""
    rng = np.random.default_rng(seed)
    spec = {}
    for idx in range(6):
        attrs = {}
        if rng.random() < 0.8:
            attrs["link"] = str(rng.choice(
                ["1", "0", "down", "false", "true", " 1\n", "up"]))
        for c in COUNTERS:
            r = rng.random()
            if r < 0.7:
                attrs[c] = f"{int(rng.integers(0, 12))}\n"
            elif r < 0.8:
                attrs[c] = "n/a"
        spec[idx] = attrs
    return spec


def _named(spec, link_attr):
    return {i: {(link_attr if k == "link" else k): v for k, v in a.items()}
            for i, a in spec.items()}


@pytest.mark.parametrize("seed", range(3))
def test_link_probe_on_files_agrees(tmp_path, seed):
    spec = _attr_spec(seed)
    ref_root = _tree(tmp_path, "ref", _named(spec, "ici_link_up"))
    port_root = _tree(tmp_path, "port", _named(spec, "nvlink_up"))
    ref = ref_probes.IciLinkProbe(sysfs_root=ref_root).run()
    port = port_probes.NvLinkProbe(nvml.FileSource(port_root)).run()
    assert _rows(port) == to_port(_rows(ref))
    assert any(not r.healthy for r in port) and any(r.healthy for r in port)


@pytest.mark.parametrize("seed", range(3))
def test_counter_probe_on_files_agrees(tmp_path, seed):
    spec = _attr_spec(seed)
    thresholds = {"ecc_uncorrected_volatile": 0, "remapped_rows_pending": 5,
                  "ecc_corrected_volatile": 7.5}
    ref_root = _tree(tmp_path, "ref", spec)
    port_root = _tree(tmp_path, "port", spec)
    ref = ref_probes.CounterThresholdProbe(thresholds,
                                           sysfs_root=ref_root).run()
    port = port_probes.CounterThresholdProbe(
        thresholds, source=nvml.FileSource(port_root)).run()
    assert _rows(port) == to_port(_rows(ref))
    assert any(not r.healthy for r in port)
    # no thresholds, no root: nothing to judge
    assert port_probes.CounterThresholdProbe(
        {}, source=nvml.FileSource(port_root)).run() == []
    assert port_probes.CounterThresholdProbe(
        thresholds, source=nvml.FileSource(str(tmp_path / "no"))).run() == []


def test_link_probe_missing_attribute_is_skip(tmp_path):
    """test_health.py:388."""
    (tmp_path / "ref" / "accel0").mkdir(parents=True)
    (tmp_path / "port" / "nvidia0").mkdir(parents=True)
    assert ref_probes.IciLinkProbe(
        sysfs_root=str(tmp_path / "ref")).run() == []
    assert port_probes.NvLinkProbe(
        nvml.FileSource(str(tmp_path / "port"))).run() == []


def _dev(tmp_path, side, indices, extra=()):
    root = tmp_path / side / "dev"
    root.mkdir(parents=True, exist_ok=True)
    prefix = "accel" if side == "ref" else "nvidia"
    for i in indices:
        (root / f"{prefix}{i}").write_text("")
    for name in extra:
        (root / name).write_text("")
    return root


CONTROL = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools", "nvidia-modeset")


@pytest.mark.parametrize("expected", [None, 4, 2])
def test_presence_probe_agrees(tmp_path, expected):
    """test_health.py:336-378: present GPUs, an armed census, a GPU that
    vanishes, none at all; the port's control nodes are no GPUs."""
    ref_root = _dev(tmp_path, "ref", [0, 1])
    port_root = _dev(tmp_path, "port", [0, 1], CONTROL)
    ref = ref_probes.DevicePresenceProbe(
        ref_discovery.ChipDiscovery(str(ref_root)), expected_chips=expected)
    port = port_probes.DevicePresenceProbe(
        port_discovery.GpuDiscovery(str(port_root)), expected_gpus=expected)
    assert _rows(port.run()) == to_port(_rows(ref.run()))
    assert port.expected_gpus == ref.expected_chips
    (ref_root / "accel1").unlink()
    (port_root / "nvidia1").unlink()
    rows = _rows(port.run())
    assert rows == to_port(_rows(ref.run()))
    assert any(r[3] is None and not r[1] for r in rows)
    for f in ref_root.iterdir():
        f.unlink()
    for f in port_root.glob("nvidia[0-9]*"):
        f.unlink()
    rows = _rows(port.run())
    assert rows == to_port(_rows(ref.run()))
    assert rows == [["device-presence", False, "no GPU device nodes", None]]


def test_presence_probe_reads_the_health_file(tmp_path):
    port_root = _dev(tmp_path, "port", range(4), CONTROL)
    ref_root = _dev(tmp_path, "ref", range(4))
    hf = tmp_path / "health"
    hf.write_text("2\nnot a number\n")
    ref = ref_probes.DevicePresenceProbe(ref_discovery.ChipDiscovery(
        str(ref_root), health_file=str(hf)))
    port = port_probes.DevicePresenceProbe(port_discovery.GpuDiscovery(
        str(port_root), health_file=str(hf)))
    rows = _rows(port.run())
    assert rows == to_port(_rows(ref.run()))
    assert [r[3] for r in rows if not r[1]] == [2]


def test_gpu_device_glob_env_is_taken_relative_to_dev_root(tmp_path,
                                                           monkeypatch):
    root = _dev(tmp_path, "port", [0, 1], CONTROL)
    (root / "nvidia-caps").mkdir()
    monkeypatch.setenv("GPU_DEVICE_GLOB", "/dev/nvidia1")
    assert [d.id for d in port_discovery.GpuDiscovery(str(root)).scan()] \
        == ["nvidia1"]
    monkeypatch.delenv("GPU_DEVICE_GLOB")
    assert [d.id for d in port_discovery.GpuDiscovery(str(root)).scan()] \
        == ["nvidia0", "nvidia1"]


def test_probes_from_spec_agrees(tmp_path):
    """test_health.py:396."""
    def names(mod, api, **kw):
        spec = api.HealthMonitorSpec(
            counter_thresholds={"ecc_uncorrected_volatile": 0},
            hbm_sweep={"enable": True, "sizeMb": 4, "minGbps": 9})
        plain = api.HealthMonitorSpec()
        return ([p.name for p in mod.probes_from_spec(spec, **kw)],
                [p.name for p in mod.probes_from_spec(plain, **kw)])

    root = str(tmp_path)
    ref = names(ref_probes, ref_api, dev_root=root, sysfs_root=root)
    port = names(port_probes, port_api, dev_root=root, sysfs_root=root)
    assert list(port) == to_port(ref)
    probes = port_probes.probes_from_spec(
        port_api.HealthMonitorSpec(
            counter_thresholds={"x": 1},
            hbm_sweep={"enable": True, "sizeMb": 4, "minGbps": 9}),
        dev_root=root, expected_gpus=4)
    by = {p.name: p for p in probes}
    assert by["device-presence"].expected_gpus == 4
    assert isinstance(by["nvlink"].source, nvml.NvmlSource)
    assert by["nvlink"].source is by["counter-threshold"].source
    assert (by["hbm-sweep"].size_mb, by["hbm-sweep"].min_gbps,
            by["hbm-sweep"].device) == (4, 9.0, "cuda")
    on_files = port_probes.probes_from_spec(
        port_api.HealthMonitorSpec(), sysfs_root=root)
    assert isinstance(on_files[1].source, nvml.FileSource)


def test_health_monitor_spec_round_trip_agrees():
    d = {"intervalSeconds": 10, "unhealthyAfterSeconds": 5,
         "counterThresholds": {"ecc_corrected_volatile": 100},
         "hbmSweep": {"enable": True, "sizeMb": 256}, "unknownKey": [1]}
    ref = ref_api.HealthMonitorSpec.from_dict(d)
    port = port_api.HealthMonitorSpec.from_dict(d)
    assert port.to_dict() == ref.to_dict() | {
        "healthFile": "/run/nvidia/gpu-health"}
    assert port.hbm_sweep_enabled() and port.is_enabled()


# == NVML =====================================================================

def _nvml_cards():
    """Four cards whose NVML order differs from their minor numbers: all
    links up; link 5 down; no NVLink at all (every link NOT_SUPPORTED or
    INVALID_ARGUMENT); ECC off and no row remapping."""
    return [
        device(0, links={k: True for k in range(18)}, ecc=(3, 0),
               remapped=(0, 0, 0, 0)),
        device(3, links={k: k != 5 for k in range(12)}, ecc=(9, 1),
               remapped=(4, 1, 1, 0)),
        device(1, links={k: INVALID_ARGUMENT for k in range(18)},
               ecc=(0, 0), remapped=(0, 0, 0, 1)),
        device(2, links={0: True, 1: NOT_SUPPORTED}, ecc=NOT_SUPPORTED,
               remapped=NOT_SUPPORTED),
    ]


def test_nvml_source_turns_calls_into_attributes():
    lib = FakeLibrary(_nvml_cards())
    attrs = nvml.NvmlSource(lib).attributes()
    assert list(attrs) == [0, 3, 1, 2] and not lib.open
    assert attrs[0]["nvlink_up"] == "1" and "nvlink_down" not in attrs[0]
    assert attrs[3]["nvlink_up"] == "0" and attrs[3]["nvlink_down"] == "5"
    assert "nvlink_up" not in attrs[1] and "nvlink_up" in attrs[2]
    assert (attrs[3]["ecc_corrected_volatile"],
            attrs[3]["ecc_uncorrected_volatile"],
            attrs[3]["remapped_rows_pending"],
            attrs[3]["remapped_rows_failure"]) == ("9", "1", "1", "0")
    assert not set(nvml.COUNTERS) & set(attrs[2])
    assert attrs[1]["index"] == "2" and attrs[1]["name"].startswith("NVIDIA")


def _files_for(cards, root):
    """The reference's attribute files holding the facts of ``cards``."""
    for c in cards:
        d = root / f"accel{c['minor']}"
        d.mkdir(parents=True)
        links = [v for v in c["links"].values() if isinstance(v, bool)]
        if links:
            (d / "ici_link_up").write_text("1" if all(links) else "0")
        if not isinstance(c["ecc"], int):
            (d / "ecc_corrected_volatile").write_text(str(c["ecc"][0]))
            (d / "ecc_uncorrected_volatile").write_text(str(c["ecc"][1]))
        if not isinstance(c["remapped"], int):
            (d / "remapped_rows_pending").write_text(str(c["remapped"][2]))
            (d / "remapped_rows_failure").write_text(str(c["remapped"][3]))
    return str(root)


def test_probes_on_nvml_agree_with_the_reference_on_files(tmp_path):
    """The same facts through NVML (port) and attribute files (reference):
    the same verdicts on the same GPUs; a card without NVLink is skipped."""
    cards = _nvml_cards()
    root = _files_for(cards, tmp_path / "ref")
    source = nvml.NvmlSource(FakeLibrary(cards))
    thresholds = {"ecc_uncorrected_volatile": 0, "remapped_rows_pending": 0,
                  "remapped_rows_failure": 0}
    ref_link = ref_probes.IciLinkProbe(sysfs_root=root).run()
    port_link = port_probes.NvLinkProbe(source).run()

    def verdicts(rows):
        return sorted((r[0], r[1], r[3]) for r in rows)
    assert verdicts(_rows(port_link)) == verdicts(to_port(_rows(ref_link)))
    assert [r.gpu_index for r in port_link] == [0, 3, 2]
    bad = [r for r in port_link if not r.healthy]
    assert [r.detail for r in bad] == [
        "nvml:nvidia3/nvlink_up reports link down (links 5)"]
    ref_counter = ref_probes.CounterThresholdProbe(
        thresholds, sysfs_root=root).run()
    port_counter = port_probes.CounterThresholdProbe(
        thresholds, source=source).run()
    assert sorted(_rows(port_counter), key=str) == \
        sorted(to_port(_rows(ref_counter)), key=str)
    assert sorted((r.gpu_index, r.detail) for r in port_counter
                  if not r.healthy) == [
        (1, "remapped_rows_failure=1 > 0"),
        (3, "ecc_uncorrected_volatile=1 > 0"),
        (3, "remapped_rows_pending=1 > 0")]


def test_nvml_errors_other_than_absence_raise():
    lost = device(0, links={0: GPU_IS_LOST})
    with pytest.raises(nvml.NvmlError, match="returned 15"):
        nvml.NvmlSource(FakeLibrary([lost])).attributes()
    lib = FakeLibrary([device(0, ecc=GPU_IS_LOST)])
    with pytest.raises(nvml.NvmlError):
        port_probes.CounterThresholdProbe(
            {"ecc_corrected_volatile": 0}, source=nvml.NvmlSource(lib)).run()
    assert not lib.open        # the session is shut down all the same


def test_missing_nvml_library_means_the_probes_skip(monkeypatch):
    def refuse(path=nvml.SONAME):
        raise OSError(f"{path}: cannot open shared object file")
    monkeypatch.setattr(nvml, "Library", refuse)
    source = nvml.NvmlSource()
    assert source.attributes() == {} and source.driver_version() is None
    assert port_probes.NvLinkProbe(source).run() == []
    assert port_probes.CounterThresholdProbe(
        {"ecc_corrected_volatile": 0}, source=source).run() == []


def test_library_prototypes_over_a_compiled_stand_in(nvml_so):
    """``Library``'s ctypes calls against a C library with NVML's
    functions: handles, buffers, 64-bit counters, absent links, errors."""
    lib = nvml.Library(nvml_so)
    source = nvml.NvmlSource(lib)
    assert source.attributes() == FAKE_NVML_ATTRIBUTES
    assert source.driver_version() == "580.159.03"
    lib.init()
    try:
        with pytest.raises(nvml.NvmlError, match="Invalid Argument"):
            lib.handle(2)
        with pytest.raises(nvml.NvmlError, match="returned 3"):
            lib.nvlink_state(lib.handle(0), 4)
    finally:
        lib.shutdown()
    rows = _rows(port_probes.NvLinkProbe(source).run())
    assert rows == [["nvlink", True, "", 0],
                    ["nvlink", False, "nvml:nvidia2/nvlink_up reports link "
                     "down (links 2)", 2]]


# == the HBM sweep (K1's plain version on the CPU) ===========================

def test_reference_hbm_sweep_raises_where_the_port_judges(tmp_path):
    """F6: the reference compares its ``HbmReport`` with the floor and
    raises ``TypeError``; the port compares ``read_gbps`` and gives one
    result."""
    with pytest.raises(TypeError, match="HbmReport"):
        ref_probes.HbmSweepProbe(size_mb=1).run()
    results = port_probes.HbmSweepProbe(size_mb=1, device="cpu").run()
    assert len(results) == 1 and results[0].healthy
    assert results[0].gpu_index is None and "GB/s" in results[0].detail


def test_hbm_sweep_misses_its_floor():
    results = port_probes.HbmSweepProbe(size_mb=1, min_gbps=1e12,
                                        device="cpu").run()
    assert len(results) == 1 and not results[0].healthy
    assert "< floor 1e+12" in results[0].detail


def test_hbm_sweep_fails_on_a_bad_checksum(monkeypatch):
    plain = port_hbm.read_sum
    monkeypatch.setattr(port_hbm, "read_sum",
                        lambda x, sweeps=1: plain(x, sweeps) * 1.5)
    results = port_probes.HbmSweepProbe(size_mb=1, device="cpu").run()
    assert len(results) == 1 and not results[0].healthy
    assert results[0].detail.startswith("sweep failed: hbm probe checksum")


def test_hbm_sweep_skips_only_without_a_card_or_memory(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert port_probes.HbmSweepProbe().run() == []

    def oom(**kw):
        raise torch.cuda.OutOfMemoryError("CUDA out of memory")
    monkeypatch.setattr(port_hbm, "hbm_read_gbps", oom)
    assert port_probes.HbmSweepProbe(device="cpu").run() == []

    def no_build(**kw):
        raise RuntimeError("nvcc refused hbm_read.cu")
    monkeypatch.setattr(port_hbm, "hbm_read_gbps", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        port_probes.HbmSweepProbe(device="cpu").run()


def test_monitor_judges_the_node_by_the_hbm_sweep(tmp_path):
    clk = Clock()
    client = port_fake.FakeClient()
    client.add_node("n0", {})
    mon = port_monitor.HealthMonitor(
        client, "n0", [port_probes.HbmSweepProbe(size_mb=1, min_gbps=1e12,
                                                 device="cpu")],
        health_file=str(tmp_path / "gpu-health"), unhealthy_after_s=0,
        clock=clk)
    rep = mon.reconcile_once()
    assert rep["healthy"] is False and rep["unhealthy_gpus"] == []
    assert rep["message"].startswith("hbm-sweep: ")
    assert mon.metrics.probe_failures_total.get("hbm-sweep") == 1


# == the CLI =================================================================

def test_cli_once_agrees(tmp_path, capsys):
    """``--once`` on fixture trees, through each package's CLI and fake
    cluster file: the same JSON line modulo the names."""
    import tpu_operator.cli.health_monitor as ref_cli
    import tpu_operator_torch.cli.health_monitor as port_cli
    spec = {0: {"ecc_uncorrected_volatile": "0"},
            1: {"ecc_uncorrected_volatile": "3"}}
    out = {}
    for side, cli, fake in (("ref", ref_cli, ref_fake),
                            ("port", port_cli, port_fake)):
        state = tmp_path / side / "state.json"
        fake.FileBackedFakeClient(str(state)).add_node("n0", {})
        dev = _dev(tmp_path, side, [0, 1])
        attrs = _tree(tmp_path / side, "ref" if side == "ref" else "port",
                      spec)
        rc = cli.main([
            "--client", f"fake:{state}", "--node-name", "n0", "--once",
            "--dev-root", str(dev), "--sysfs-root", attrs,
            "--health-file", str(tmp_path / side / "health"),
            "--counter-thresholds", '{"ecc_uncorrected_volatile": 0}',
            "--unhealthy-after", "0", "--expected-chips", "3"])
        line = capsys.readouterr().out.strip().splitlines()[-1]
        node = fake.FileBackedFakeClient(str(state)).get("Node", "n0")
        out[side] = {"rc": rc, "line": json.loads(line),
                     "annotations": dict(node.annotations),
                     "file": (tmp_path / side / "health").read_text()}
    assert out["port"] == to_port(out["ref"])
    assert out["port"]["rc"] == 1 and out["port"]["file"] == "1\n"
    assert out["port"]["line"]["unhealthy_gpus"] == [1]


def test_cli_rejects_bad_json(monkeypatch):
    from tpu_operator_torch.cli.health_monitor import main
    monkeypatch.delenv("NODE_NAME", raising=False)
    for flag in ("--counter-thresholds", "--hbm-sweep-config"):
        with pytest.raises(SystemExit) as ei:
            main(["--node-name", "n0", flag, "[1"])
        assert ei.value.code == 2
    with pytest.raises(SystemExit):
        main(["--once"])
