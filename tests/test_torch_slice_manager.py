"""The NVLink slice manager (``operands/slice_manager.py``), the slice-aware
device plugin view and ``cli/slice_manager.py`` against the reference.

The reference's scenarios (``tests/test_operands.py:106-240``, the state
machine, the drain, the backoff; ``tests/test_deviceplugin.py:264-300``,
grouping, fallbacks, Allocate) run on both copies, and the port's outcome
must equal the reference's after the name map: ``accel<N>`` → ``nvidia<N>``,
``tpu.dev/`` → ``nvidia.com/``, ``per-chip`` → ``per-gpu``. The port's
cards sit on a fake NVML in which every pair is NVLink-linked (an
NVSwitch board), where the reference's sit on its 2-D ICI grid; the splits
both make on 4 and 8 devices are the same.

The reference's rectangle cases whose answer depends on the ICI grid
(``test_partition_devices``'s ``"1x4"`` tile, the 3-way and ``"4x2"``
refusals, ``test_rectangle_partitions_all_host_sizes``) are replaced one
for one by NVLink cases: 8 cards all-to-all, 4 bridged pairs, 1 card, 2
cards without a link, NVML absent, and the ``"WxH"`` form refused.
"""

import json
import os

import pytest

import tpu_operator.deviceplugin.discovery as ref_disc
import tpu_operator.operands.slice_manager as ref_sm
import tpu_operator_torch.deviceplugin.discovery as port_disc
import tpu_operator_torch.operands.slice_manager as port_sm
from tpu_operator.kube import FakeClient as RefFakeClient
from tpu_operator.kube import Obj as RefObj
from tpu_operator_torch.kube import FakeClient as PortFakeClient
from tpu_operator_torch.kube import Obj as PortObj
from tpu_operator_torch.utils.nvml import Library, NvmlSource
import torch_names as names
from torch_fake_nvml import (FAKE_NVML_PEERS, FakeLibrary, device, fake_uuid,
                             nvlink_cards, nvml_so)  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the slice manager's own names, before ``torch_names.POLICY_NAME_MAP``
SLICE_MAP = ((r"\baccel(\d+)", r"nvidia\1"), (r"/r/", "/p/"))


def to_port(obj):
    return names.to_port(obj, SLICE_MAP)


def all_to_all(n):
    return NvmlSource(FakeLibrary(nvlink_cards(
        list(range(n)), [(a, b) for a in range(n) for b in range(a + 1, n)])))


# -- partitioning: the reference's cases on both copies ---------------------

DEVS_R = [f"/dev/accel{i}" for i in range(8)]
DEVS_P = [f"/dev/nvidia{i}" for i in range(8)]
FULL_8 = {i: set(range(8)) - {i} for i in range(8)}


@pytest.mark.parametrize("spec", [
    {"partitions": 1}, {"partitions": 2}, {"partitions": 4},
    {"partitions": 8}, {"partitions": "per-chip"}])
def test_partition_devices_matches_the_reference(spec):
    """test_operands.py:96-101: on 8 devices the reference's splits into
    1, 2, 4 and per-chip (its 2x4 grid: halves 2x2, quarters 2x1 rows) are
    contiguous blocks; so are the port's on an NVSwitch board."""
    want = to_port(ref_sm.partition_devices(DEVS_R, spec))
    assert port_sm.partition_devices(DEVS_P, to_port(spec), FULL_8) == want


@pytest.mark.parametrize("spec", [
    {"partitions": 0}, {"partitions": 9}, {"partitions": "halfs"}])
def test_partition_devices_invalid_on_both(spec):
    """test_operands.py:104-114, the cases that depend on no grid."""
    with pytest.raises(ref_sm.SliceConfigError):
        ref_sm.partition_devices(DEVS_R, spec)
    with pytest.raises(port_sm.SliceConfigError):
        port_sm.partition_devices(DEVS_P, spec, FULL_8)


# -- partitioning: the NVLink cases that replace the rectangle cases -------

ALL_8 = [(a, b) for a in range(8) for b in range(a + 1, 8)]
PAIRS_8 = [(0, 1), (2, 3), (4, 5), (6, 7)]


class NoNvml(NvmlSource):
    def library(self):
        return None


def fake_peers(n, pairs):
    """NVML's peer map of ``n`` cards linked on ``pairs``, read through
    ``NvmlSource`` from the fake library; ``pairs`` None: NVML absent."""
    if pairs is None:
        return NoNvml().nvlink_peers()
    return NvmlSource(FakeLibrary(nvlink_cards(list(range(n)), pairs))) \
        .nvlink_peers()


def _pairs(*pairs):
    peers = {}
    for a, b in pairs:
        peers.setdefault(a, set()).add(b)
        peers.setdefault(b, set()).add(a)
    return peers


@pytest.mark.parametrize("n,pairs,k,want", [
    # replaces "1x4" columns: 8 cards all-to-all, contiguous blocks
    (8, ALL_8, 2, [[0, 1, 2, 3], [4, 5, 6, 7]]),
    (8, ALL_8, 8, [[i] for i in range(8)]),
    # replaces the 3-way refusal's viable split: 4 bridged pairs
    (8, PAIRS_8, 4, [[0, 1], [2, 3], [4, 5], [6, 7]]),
    # pairs bridged across the index order: lexicographically first
    (4, [(0, 2), (1, 3)], 2, [[0, 2], [1, 3]]),
    # one card: a single group
    (1, [], 1, [[0]]),
])
def test_nvlink_partitions(n, pairs, k, want):
    peers = fake_peers(n, pairs)
    devs = DEVS_P[:n]
    got = port_sm.partition_devices(devs, {"partitions": k}, peers)
    assert got == [[devs[i] for i in g] for g in want]
    # every group is a clique of NVLink peers covering each card once
    minors = [[int(p[len("/dev/nvidia"):]) for p in g] for g in got]
    assert sorted(m for g in minors for m in g) == list(range(n))
    for g in minors:
        assert all(b in peers[a] for a in g for b in g if a != b)


@pytest.mark.parametrize("n,pairs,spec,needle", [
    # replaces the 3-way refusal: 4 bridged pairs cannot form halves
    (8, PAIRS_8, {"partitions": 2}, "viable partition counts: [1, 4, 8]"),
    (8, ALL_8, {"partitions": 3}, "equal partitions"),
    # one card asked for pairs
    (1, [], {"gpusPerPartition": 2}, "groups of 2"),
    # two cards without a link
    (2, [], {"gpusPerPartition": 2}, "viable partition counts: [1, 2]"),
    # NVML absent: no group of more than one card is guessed
    (4, None, {"partitions": 2}, "NVLink topology unknown"),
    (4, None, {"partitions": 4}, "NVLink topology unknown"),
    # replaces "4x2": a WxH tile has no GPU meaning
    (8, ALL_8, {"partitions": "4x2"}, "no GPU meaning"),
    (8, ALL_8, {"partitions": "1x4"}, "no GPU meaning"),
])
def test_nvlink_partitions_refused(n, pairs, spec, needle):
    with pytest.raises(port_sm.SliceConfigError) as e:
        port_sm.partition_devices(DEVS_P[:n], spec, fake_peers(n, pairs))
    assert needle in str(e.value)


def test_one_group_and_per_gpu_need_no_topology():
    assert port_sm.partition_devices(DEVS_P[:4], {"partitions": 1},
                                     None) == [DEVS_P[:4]]
    assert port_sm.partition_devices(DEVS_P[:4], {"partitions": "per-gpu"},
                                     None) == [[d] for d in DEVS_P[:4]]


def test_gpus_per_partition_is_the_count_of_cards_in_a_group():
    assert port_sm.partition_devices(
        DEVS_P, {"gpusPerPartition": 2},
        _pairs((0, 1), (2, 3), (4, 5), (6, 7))) == \
        [DEVS_P[i:i + 2] for i in range(0, 8, 2)]


def test_load_profiles_from_asset_configmap():
    """test_operands.py:139-148 on the port's asset: the GPU's profiles."""
    import yaml
    asset = os.path.join(ROOT, "tpu_operator_torch", "assets",
                         "state-slice-manager", "0400_configmap.yaml")
    cm = yaml.safe_load(open(asset))
    profiles = yaml.safe_load(cm["data"]["config.yaml"])["profiles"]
    assert set(profiles) == {"full", "per-gpu", "nvlink-pairs"}
    pairs = _pairs((0, 1), (2, 3), (4, 5), (6, 7))
    assert port_sm.partition_devices(DEVS_P, profiles["full"], pairs) == \
        [DEVS_P]
    assert port_sm.partition_devices(DEVS_P, profiles["per-gpu"], None) == \
        [[d] for d in DEVS_P]
    assert port_sm.partition_devices(DEVS_P, profiles["nvlink-pairs"],
                                     pairs) == \
        [DEVS_P[i:i + 2] for i in range(0, 8, 2)]
    with pytest.raises(port_sm.SliceConfigError):
        port_sm.partition_devices(DEVS_P[:1], profiles["nvlink-pairs"],
                                  {0: set()})


def test_nvlink_peers_from_nvml():
    lib = FakeLibrary(nvlink_cards([0, 1, 2, 3], [(0, 1), (2, 3)]))
    assert NvmlSource(lib).nvlink_peers() == {0: {1}, 1: {0}, 2: {3},
                                              3: {2}}
    # a failing pair query is "no link"
    cards = [device(0, p2p={1: 3}), device(1, p2p={0: 3})]
    assert NvmlSource(FakeLibrary(cards)).nvlink_peers() == {0: set(),
                                                            1: set()}


def test_nvlink_peers_over_the_compiled_stand_in(nvml_so):  # noqa: F811
    """``Library.p2p_nvlink``'s prototype against a C library exporting
    ``nvmlDeviceGetP2PStatus``: NVLink caps index 2, status OK."""
    assert NvmlSource(Library(nvml_so)).nvlink_peers() == FAKE_NVML_PEERS


def test_nvlink_peers_without_nvml():
    assert NoNvml().nvlink_peers() is None


# -- the state machine: the reference's scenarios on both copies -----------

PROFILES = """
version: v1alpha1
profiles:
  full: {partitions: 1}
  halves: {partitions: 2}
  chips: {partitions: per-chip}
"""


def mk_sm(tmp_path, side, n_devices=4, nvml=None):
    """test_operands.py:151-170 for one side ("r" or "p")."""
    root = tmp_path / side
    root.mkdir()
    c = (RefFakeClient if side == "r" else PortFakeClient)()
    c.add_node("n1", {})
    cfg = root / "config.yaml"
    cfg.write_text(PROFILES if side == "r"
                   else PROFILES.replace("per-chip", "per-gpu"))
    prefix = "accel" if side == "r" else "nvidia"
    for i in range(n_devices):
        (root / f"{prefix}{i}").touch()
    kw = dict(node_name="n1", config_file=str(cfg),
              state_dir=str(root / "state"),
              partitions_file=str(root / "partitions.json"))
    if side == "r":
        sm = ref_sm.SliceManager(c, device_glob=str(root / "accel*"), **kw)
    else:
        sm = port_sm.SliceManager(
            c, device_glob=str(root / "nvidia[0-9]*"),
            nvml=nvml or all_to_all(n_devices), **kw)
    return c, sm


def _run_both(tmp_path, scenario):
    out = {}
    for side in ("r", "p"):
        c, sm = mk_sm(tmp_path, side)
        out[side] = scenario(c, sm, side)
    assert out["p"] == to_port(out["r"])
    return out["p"]


def _plan(sm):
    plan = json.load(open(sm.partitions_file))
    plan.pop("ts")
    return plan


def test_fsm_applies_default_profile(tmp_path):
    def scenario(c, sm, side):
        return [sm.reconcile_once(), c.get("Node", "n1").labels, _plan(sm)]
    state, labels, plan = _run_both(tmp_path, scenario)
    assert state == "success" and labels["nvidia.com/slice.state"] == \
        "success"
    assert plan["profile"] == "full" and len(plan["partitions"][0]) == 4
    assert plan["resource"] == "nvidia.com/gpu"


def test_fsm_reconfigures_on_label_change(tmp_path):
    def scenario(c, sm, side):
        sm.reconcile_once()
        node = c.get("Node", "n1")
        node.labels[sm_mod(side).CONFIG_LABEL] = "chips"
        c.update(node)
        return [sm.reconcile_once(), _plan(sm), sm.applied_profile()]
    state, plan, applied = _run_both(tmp_path, scenario)
    assert state == "success" and applied == "chips"
    assert len(plan["partitions"]) == 4


def test_fsm_halves_match(tmp_path):
    def scenario(c, sm, side):
        node = c.get("Node", "n1")
        node.labels[sm_mod(side).CONFIG_LABEL] = "halves"
        c.update(node)
        return [sm.reconcile_once(), _plan(sm)]
    _, plan = _run_both(tmp_path, scenario)
    assert [len(g) for g in plan["partitions"]] == [2, 2]


def sm_mod(side):
    return ref_sm if side == "r" else port_sm


def test_fsm_noop_when_applied(tmp_path):
    def scenario(c, sm, side):
        sm.reconcile_once()
        c.actions.clear()
        sm.reconcile_once()
        return [list(a) for a in c.actions]
    actions = _run_both(tmp_path, scenario)
    assert [a for a in actions if a[0] == "delete"] == []


def test_fsm_unknown_profile_fails_and_backs_off(tmp_path):
    """test_operands.py:217-225 and the backoff of
    test_apiserver.py:885-905: a bad profile fails, the next pass
    short-circuits on the recorded failure, a corrected label clears it."""
    def scenario(c, sm, side):
        mod = sm_mod(side)
        node = c.get("Node", "n1")
        node.labels[mod.CONFIG_LABEL] = "nonsense"
        c.update(node)
        out = [sm.reconcile_once(), c.get("Node", "n1").labels,
               sm.applied_profile()]
        c.actions.clear()
        out += [sm.reconcile_once(),
                [a[0] for a in c.actions if a[0] != "get"]]
        node = c.get("Node", "n1")
        node.labels[mod.CONFIG_LABEL] = "full"
        c.update(node)
        out.append(sm.reconcile_once())
        return out
    got = _run_both(tmp_path, scenario)
    assert got[0] == "failed" and got[2] is None
    assert got[3] == "failed" and got[5] == "success"


def test_fsm_drains_gpu_pods_only(tmp_path):
    """test_operands.py:228-248 through the names: the accelerator's own
    resource and the names the drain also counts."""
    pods = {"r": ("tpu.dev/chip", "google.com/tpu"),
            "p": ("nvidia.com/gpu", "nvidia.com/gpu.shared")}

    def scenario(c, sm, side):
        Obj = RefObj if side == "r" else PortObj
        own, other = pods[side]
        for name, node, res in (("train", "n1", {own: "4"}),
                                ("web", "n1", {}),
                                ("shared", "n1", {other: "1"}),
                                ("other-node", "n2", {other: "8"})):
            c.create(Obj({"apiVersion": "v1", "kind": "Pod",
                          "metadata": {"name": name,
                                       "namespace": "default"},
                          "spec": {"nodeName": node, "containers": [
                              {"name": "t",
                               "resources": {"limits": res}}]}}))
        sm.reconcile_once()
        return sorted(p.name for p in c.list("Pod"))
    assert _run_both(tmp_path, scenario) == ["other-node", "web"]


def test_invalidate_unhealthy_partitions_on_both(tmp_path):
    def scenario(c, sm, side):
        node = c.get("Node", "n1")
        node.labels[sm_mod(side).CONFIG_LABEL] = "halves"
        c.update(node)
        sm.reconcile_once()
        health = tmp_path / side / "health"
        sm.health_file = str(health)
        health.write_text("3\n")
        first = sm.invalidate_unhealthy_partitions()
        health.write_text("")
        return [first, sm.invalidate_unhealthy_partitions()]
    assert _run_both(tmp_path, scenario) == [[1], []]


# -- the port's own cases: the F7 presence rule and the card path ----------

def test_a_node_nvml_does_not_list_never_enters_a_plan(tmp_path):
    """F7: a fixture /dev holding an unlisted nvidia0 beside the container's
    own cards; NVML lists minors 1 and 2 only."""
    c, sm = mk_sm(tmp_path, "p", n_devices=3, nvml=NvmlSource(FakeLibrary(
        nvlink_cards([1, 2], [(1, 2)]))))
    assert sm.devices() == [str(tmp_path / "p" / f"nvidia{i}")
                            for i in (1, 2)]
    assert sm.reconcile_once() == "success"
    plan = _plan(sm)
    assert plan["partitions"] == [[str(tmp_path / "p" / f"nvidia{i}")
                                   for i in (1, 2)]]
    assert not any("nvidia0" in p for g in plan["partitions"] for p in g)


def test_f7_over_the_compiled_stand_in(tmp_path, nvml_so):  # noqa: F811
    """The compiled NVML lists minors 0 and 2 (linked); a fixture nvidia1
    stays out of every plan."""
    c, sm = mk_sm(tmp_path, "p", n_devices=3,
                  nvml=NvmlSource(Library(nvml_so)))
    node = c.get("Node", "n1")
    node.labels[port_sm.CONFIG_LABEL] = "halves"
    c.update(node)
    assert sm.reconcile_once() == "success"
    assert _plan(sm)["partitions"] == [
        [str(tmp_path / "p" / "nvidia0")], [str(tmp_path / "p" / "nvidia2")]]


def test_pairs_on_one_card_fail_with_backoff(tmp_path):
    c, sm = mk_sm(tmp_path, "p", n_devices=1)
    sm.config_file = str(tmp_path / "pairs.yaml")
    (tmp_path / "pairs.yaml").write_text(
        "profiles:\n  full: {partitions: 1}\n"
        "  nvlink-pairs: {gpusPerPartition: 2}\n")
    node = c.get("Node", "n1")
    node.labels[port_sm.CONFIG_LABEL] = "nvlink-pairs"
    c.update(node)
    assert sm.reconcile_once() == "failed"
    assert not os.path.exists(sm.partitions_file)


def test_nvml_absent_refuses_groups(tmp_path):
    c, sm = mk_sm(tmp_path, "p", n_devices=4, nvml=NoNvml())
    node = c.get("Node", "n1")
    node.labels[port_sm.CONFIG_LABEL] = "halves"
    c.update(node)
    assert sm.reconcile_once() == "failed"
    node = c.get("Node", "n1")
    node.labels[port_sm.CONFIG_LABEL] = "full"
    c.update(node)
    assert sm.reconcile_once() == "success"
    assert len(_plan(sm)["partitions"][0]) == 4


def test_cli_once_on_both(tmp_path, monkeypatch, capsys):
    """``--once`` prints the state and exits 0 on success, 1 otherwise, on
    the file-backed fake cluster, as the reference's CLI does."""
    from tpu_operator.cli.slice_manager import main as ref_main
    from tpu_operator.kube.fake import FileBackedFakeClient as RefFile
    from tpu_operator_torch.cli.slice_manager import main as port_main
    from tpu_operator_torch.kube.fake import FileBackedFakeClient as PortFile
    outs = {}
    for side, main, File in (("r", ref_main, RefFile),
                             ("p", port_main, PortFile)):
        root = tmp_path / side
        root.mkdir()
        (root / "config.yaml").write_text(PROFILES)
        prefix = "accel" if side == "r" else "nvidia"
        for i in range(2):
            (root / f"{prefix}{i}").touch()
        File(str(root / "c.json")).add_node("n1", {})
        env = {"SLICE_CONFIG_FILE": str(root / "config.yaml"),
               "SLICE_STATE_DIR": str(root / "state"),
               "SLICE_PARTITIONS_FILE": str(root / "plan.json")}
        if side == "r":
            env["TPU_DEVICE_GLOB"] = str(root / "accel*")
        else:
            env["GPU_DEVICE_GLOB"] = str(root / "nvidia[0-9]*")
            # no NVML here: the access rule decides presence
            monkeypatch.setattr(NvmlSource, "library", lambda self: None)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        rc = main(["--once", "--client", f"fake:{root / 'c.json'}",
                   "--node-name", "n1"])
        plan = json.load(open(root / "plan.json"))
        plan.pop("ts")
        outs[side] = [rc, capsys.readouterr().out, plan]
    assert outs["p"] == to_port(outs["r"])
    assert outs["p"][0] == 0


# -- slice-aware advertising: test_deviceplugin.py:264-320 on both ---------

def _write_plan(tmp_path, partitions):
    plan = tmp_path / "slice-partitions.json"
    plan.write_text(json.dumps({"profile": "x", "partitions": partitions}))
    return str(plan)


def _inner(side, root):
    if side == "r":
        return ref_disc.ChipDiscovery(str(root), "accel*")
    return port_disc.GpuDiscovery(str(root), "nvidia[0-9]*",
                                  nvml=all_to_all(4))


def _aware(side):
    return (ref_disc if side == "r" else port_disc).SliceAwareDiscovery


def _nodes(tmp_path, side, n):
    root = tmp_path / side
    root.mkdir(exist_ok=True)
    prefix = "accel" if side == "r" else "nvidia"
    for i in range(n):
        (root / f"{prefix}{i}").touch()
    return root, [str(root / f"{prefix}{i}") for i in range(n)]


def _units(units):
    return [[u.id, u.health, list(u.member_paths), list(u.member_indices)]
            for u in units]


def test_slice_aware_groups_partitions_on_both(tmp_path):
    out = {}
    for side in ("r", "p"):
        root, paths = _nodes(tmp_path, side, 4)
        sd = _aware(side)(_inner(side, root),
                          _write_plan(root, [paths[:2], paths[2:]]))
        out[side] = _units(sd.scan())
    assert out["p"] == to_port(out["r"])
    assert [u[0] for u in out["p"]] == ["slice-0", "slice-1"]
    assert out["p"][0][3] == [0, 1]


def test_slice_aware_fallbacks_on_both(tmp_path):
    out = {}
    for side in ("r", "p"):
        root, paths = _nodes(tmp_path, side, 2)
        prefix = "accel" if side == "r" else "nvidia"
        inner = _inner(side, root)
        got = []
        # no plan file → per-card
        got.append(_units(_aware(side)(
            inner, str(root / "missing.json")).scan()))
        # stale plan naming a vanished device → per-card
        got.append(_units(_aware(side)(inner, _write_plan(
            root, [[paths[0], str(root / f"{prefix}9")]])).scan()))
        # per-card profile → plain ids
        got.append(_units(_aware(side)(inner, _write_plan(
            root, [[paths[0]], [paths[1]]])).scan()))
        # an invalidated group advertises Unhealthy
        plan = root / "invalid.json"
        plan.write_text(json.dumps({"partitions": [paths], "invalid": [0]}))
        got.append(_units(_aware(side)(inner, str(plan)).scan()))
        out[side] = got
    assert out["p"] == to_port(out["r"])
    assert [u[0] for u in out["p"][0]] == ["nvidia0", "nvidia1"]
    assert out["p"][3][0][1] == "Unhealthy"


def test_allocate_expands_slice_members(tmp_path, monkeypatch):
    """test_deviceplugin.py:300-320: Allocate of a group unit mounts every
    member's node and names every member in NVIDIA_VISIBLE_DEVICES (the
    reference's TPU bounds variable has no counterpart)."""
    pytest.importorskip("grpc")
    from tpu_operator.deviceplugin import deviceplugin_pb2 as ref_pb
    from tpu_operator.deviceplugin.plugin import TpuDevicePlugin
    from tpu_operator_torch.deviceplugin import deviceplugin_pb2 as port_pb
    from tpu_operator_torch.deviceplugin.plugin import GpuDevicePlugin
    monkeypatch.setattr("os.access", lambda p, m: True)
    out = {}
    for side in ("r", "p"):
        root, paths = _nodes(tmp_path, side, 4)
        sd = _aware(side)(_inner(side, root),
                          _write_plan(root, [paths[:2], paths[2:]]))
        pb = ref_pb if side == "r" else port_pb
        plugin = (TpuDevicePlugin if side == "r" else GpuDevicePlugin)(
            plugin_dir=str(root), discovery=sd)
        resp = plugin.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(device_ids=["slice-1"])]), None)
        [car] = resp.container_responses
        out[side] = [[d.host_path for d in car.devices],
                     car.envs.get("TPU_VISIBLE_CHIPS")
                     or car.envs.get("NVIDIA_VISIBLE_DEVICES")]
    # the members' nodes as the reference mounts them; the visible list
    # names them by NVML UUID, where the reference gives its chip numbers
    # (F10)
    ref = to_port(out["r"])
    assert out["p"][0] == ref[0] == [str(tmp_path / "p" / f"nvidia{i}")
                                     for i in (2, 3)]
    assert ref[1] == "2,3"
    assert out["p"][1] == f"{fake_uuid(2)},{fake_uuid(3)}"


def test_allocate_expands_members_under_cdi(tmp_path):
    pytest.importorskip("grpc")
    from tpu_operator_torch.deviceplugin import deviceplugin_pb2 as pb
    from tpu_operator_torch.deviceplugin.plugin import GpuDevicePlugin
    root, paths = _nodes(tmp_path, "p", 4)
    sd = port_disc.SliceAwareDiscovery(
        _inner("p", root), _write_plan(root, [paths[:2], paths[2:]]))
    plugin = GpuDevicePlugin(plugin_dir=str(root), discovery=sd,
                             strategy="cdi")
    resp = plugin.Allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(device_ids=["slice-0"])]), None)
    [car] = resp.container_responses
    assert [d.name for d in car.cdi_devices] == [
        f"nvidia.com/gpu={fake_uuid(0)}", f"nvidia.com/gpu={fake_uuid(1)}"]
    assert car.envs["NVIDIA_VISIBLE_DEVICES"] == \
        f"{fake_uuid(0)},{fake_uuid(1)}"
