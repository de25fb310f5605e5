"""``gpu-node-agent`` against the reference's ``tpu-node-agent``.

The parity tests run both agents on their own side of the same fixture
node and compare exit codes, output, status files (less their time stamp),
CDI specs and containerd drop-ins after ``torch_native.NAME_MAP``:
``libtpu-install`` → ``driver-install`` writing ``driver-ready``,
``runtime-configure`` writing ``container-toolkit-ready``, ``tpu.json`` →
``nvidia.json`` of kind ``nvidia.com/gpu``, the drop-in
``nvidia-container-runtime.toml`` with ``nvidia`` runtimes. By design the
port's ``--source`` is the image's library directory (the reference's is
one file), and the reference's ``TPU_CHIPS_PER_HOST_BOUNDS`` on the CDI
spec's ``all`` device has no counterpart (no CUDA runtime reads ICI
bounds), so it is taken off the reference's spec before the comparison.
Then the port alone: the validator's driver, container-toolkit and gate
components accept what the agent writes, versioned libraries stage as
links, the multi-node env chain, and the presence rule on a fake NVML.
"""

import json
import os
import shutil
import subprocess
import time

import pytest

from torch_fake_nvml import FAKE_NVML_UUIDS, nvml_so  # noqa: F401
from torch_native import (NO_AMBIENT, SIDES, agent_args,  # noqa: F401
                          binary, install_cmd, port_bins, ref_bins, run,
                          side_tree, to_port)

PROBE_ENV = {"r": ("LIBTPU_INSTALL_DIR", "TPU_DEVICE_GLOB"),
             "p": ("DRIVER_INSTALL_DIR", "GPU_DEVICE_GLOB")}


def agent(bins, side, cmd, root, *extra, env=None):
    return run(bins, binary(side, "node-agent"), cmd,
               *agent_args(root, side), *extra, env=env)


def status(root, component):
    path = root / "validations" / f"{component}-ready"
    if not path.exists():
        return None
    st = json.loads(path.read_text())
    st.pop("ts")
    return st


@pytest.fixture
def trees(tmp_path):
    return {s: side_tree(tmp_path, s) for s in SIDES}


@pytest.fixture
def bins(ref_bins, port_bins):
    return {"r": ref_bins, "p": port_bins}


def on_both(bins, trees, cmd, *extra, env=None):
    """``cmd`` on each side: the reference's (rc, stdout, stderr) under the
    port's names, and the port's."""
    out = {}
    for s in SIDES:
        c = install_cmd(s) if cmd == "install" else cmd
        p = agent(bins[s], s, c, trees[s], *extra, env=env)
        out[s] = (p.returncode, p.stdout, p.stderr)
    return tuple(to_port(x) if isinstance(x, str) else x
                 for x in out["r"]), out["p"]


def spec_without_bounds(spec):
    for d in spec["devices"]:
        d["containerEdits"].pop("env", None)
    return spec


# -- driver-install (libtpu-install) -----------------------------------------

def test_driver_install_stages_and_writes_status(bins, trees):
    ref, port = on_both(bins, trees, "install")
    assert port[0] == 0, port[2]
    assert ref == port
    assert (trees["p"] / "host" / "libcuda.so.1").exists()
    st = status(trees["p"], "driver")
    assert st["ok"] and st["component"] == "driver"
    assert st == to_port(status(trees["r"], "libtpu"))


def test_driver_install_fails_without_devices(bins, trees):
    glob = {"r": "nothing*", "p": "nothing[0-9]*"}
    for s in SIDES:
        args = agent_args(trees[s], s)
        args[args.index("--device-glob") + 1] = str(trees[s] / glob[s])
        p = run(bins[s], binary(s, "node-agent"), install_cmd(s), *args)
        assert p.returncode == 1
        assert status(trees[s], "driver" if s == "p" else "libtpu") is None


def test_failed_install_retracts_stale_status(bins, trees):
    for s, (_, lib) in SIDES.items():
        comp = "driver" if s == "p" else "libtpu"
        agent(bins[s], s, install_cmd(s), trees[s])
        assert status(trees[s], comp) is not None
        # now the payload is corrupt and nothing valid is pre-installed
        (trees[s] / "img" / lib).write_text("corrupt")
        (trees[s] / "host" / lib).unlink()
        p = agent(bins[s], s, install_cmd(s), trees[s])
        assert p.returncode == 1
        assert status(trees[s], comp) is None


def test_driver_install_idempotent_same_payload(bins, trees):
    for s, (_, lib) in SIDES.items():
        agent(bins[s], s, install_cmd(s), trees[s])
        dest = trees[s] / "host" / lib
        before = dest.stat().st_mtime_ns
        # identical payload: the second run must not rewrite
        p = agent(bins[s], s, install_cmd(s), trees[s])
        assert p.returncode == 0, p.stderr
        assert dest.stat().st_mtime_ns == before


def test_driver_install_refuses_swap_while_device_in_use(bins, trees):
    for s, (prefix, lib) in SIDES.items():
        agent(bins[s], s, install_cmd(s), trees[s])
        dest = trees[s] / "host" / lib
        old = dest.read_bytes()
        with open(trees[s] / "img" / lib, "ab") as f:   # a new version
            f.write(b"\0new-version")
        fd = os.open(str(trees[s] / f"{prefix}0"), os.O_RDONLY)  # a job
        try:
            p = agent(bins[s], s, install_cmd(s), trees[s])
            assert p.returncode == 3, (s, p.returncode, p.stderr)
            assert "in use" in p.stderr
            assert dest.read_bytes() == old      # not swapped
            assert not (trees[s] / "host" / f"{lib}.tmp").exists()
        finally:
            os.close(fd)
        # device released → the swap proceeds
        p = agent(bins[s], s, install_cmd(s), trees[s])
        assert p.returncode == 0, p.stderr
        assert dest.read_bytes() != old


def test_driver_install_accepted_by_the_validator(port_bins, tmp_path):
    """The status file and the staged library are what the port's
    validator reads: the driver component finds ``libcuda.so.1`` under the
    driver root and loads it, and the gate passes on ``driver-ready``."""
    from tpu_operator_torch.validator.components import (DriverComponent,
                                                         GateComponent)
    root = side_tree(tmp_path, "p", payload=str(port_bins /
                                                "libfake-cuda.so"))
    args = agent_args(root, "p")
    args[args.index("--install-dir") + 1] = str(root / "usr" / "lib64")
    p = run(port_bins, "gpu-node-agent", "driver-install", *args)
    assert p.returncode == 0, p.stderr
    st = status(root, "driver")
    assert st["info"]["detail"].endswith("libcuda.so.1 (cuInit)")
    gate = GateComponent(gates=["driver"],
                         validations_dir=str(root / "validations"))
    assert gate.run() == {"gates": ["driver"]}
    info = DriverComponent(driver_root=str(root),
                           device_glob=str(root / "nvidia[0-9]*"),
                           validations_dir=str(root / "validations")).run()
    assert info["library"] == str(root / "usr" / "lib64" / "libcuda.so.1")
    assert len(info["devices"]) == 2


def test_driver_install_stages_versioned_links(port_bins, tmp_path):
    """An image carries ``libcuda.so.1`` as a link to the versioned file;
    both stage as they are, so the validator and the metrics agent read the
    version from the resolved name."""
    from tpu_operator_torch.validator.driver_build import (build_epoch,
                                                          extract_build)
    root = side_tree(tmp_path, "p")
    img = root / "img"
    (img / "libcuda.so.1").unlink()
    shutil.copy(port_bins / "libfake-cuda.so", img / "libcuda.so.580.159.03")
    (img / "libcuda.so.1").symlink_to("libcuda.so.580.159.03")
    (img / "libnvidia-ml.so.580.159.03").write_bytes(b"\0")
    (img / "README").write_text("not a library")
    p = run(port_bins, "gpu-node-agent", "driver-install",
            *agent_args(root, "p"))
    assert p.returncode == 0, p.stderr
    host = root / "host"
    assert sorted(os.listdir(host)) == [
        "libcuda.so.1", "libcuda.so.580.159.03",
        "libnvidia-ml.so.580.159.03"]
    assert os.readlink(host / "libcuda.so.1") == "libcuda.so.580.159.03"
    assert extract_build(str(host / "libcuda.so.1")) == "580.159.03"
    m = run(port_bins, "gpu-metrics-agent", "--once", "--install-dir", host,
            "--device-glob", root / "nvidia[0-9]*", "--nvml", "none",
            "--validations-dir", root / "validations")
    want = build_epoch("580.159.03")
    assert f'gpu_agent_driver_build_epoch{{source="staged"}} {want}' \
        in m.stdout


def test_driver_install_without_libcuda_in_the_image(port_bins, tmp_path):
    root = side_tree(tmp_path, "p")
    (root / "img" / "libcuda.so.1").unlink()
    p = run(port_bins, "gpu-node-agent", "driver-install",
            *agent_args(root, "p"))
    assert p.returncode == 1 and "no libcuda.so.1" in p.stderr
    # a host install already in place counts as installed
    shutil.copy(port_bins / "libfake-cuda.so", root / "host" / "libcuda.so.1")
    p = run(port_bins, "gpu-node-agent", "driver-install",
            *agent_args(root, "p"))
    assert p.returncode == 0, p.stderr


# -- runtime-configure, cdi-generate, probe ----------------------------------

def test_runtime_configure_cdi_and_drop_in(bins, trees):
    from tpu_operator_torch.validator.components import \
        ContainerToolkitComponent
    on_both(bins, trees, "install")
    ref, port = on_both(bins, trees, "runtime-configure", env=NO_AMBIENT)
    assert port[0] == 0, port[2]
    assert ref == port
    spec = json.loads((trees["p"] / "cdi" / "nvidia.json").read_text())
    assert spec["kind"] == "nvidia.com/gpu"
    assert [d["name"] for d in spec["devices"]] == ["0", "1", "all"]
    assert spec["containerEdits"]["mounts"][0]["containerPath"] == \
        "/usr/lib/x86_64-linux-gnu/libcuda.so.1"
    ref_spec = json.loads((trees["r"] / "cdi" / "tpu.json").read_text())
    assert spec == to_port(spec_without_bounds(ref_spec))
    drop_in = trees["p"] / "containerd" / "conf.d" / \
        "nvidia-container-runtime.toml"
    toml = drop_in.read_text()
    assert "enable_cdi = true" in toml and "runtimes.nvidia]" in toml
    assert toml == to_port((trees["r"] / "containerd" / "conf.d" /
                            "tpu-runtime.toml").read_text())
    st = status(trees["p"], "container-toolkit")
    assert st == to_port(status(trees["r"], "runtime-hook"))
    comp = ContainerToolkitComponent(
        cdi_spec_dir=str(trees["p"] / "cdi"),
        containerd_config=str(trees["p"] / "containerd" / "config.toml"),
        validations_dir=str(trees["p"] / "validations"))
    info = comp.run()
    assert info["cdi_specs"] and info["containerd_drop_in"] == str(drop_in)


def test_cdi_generate_to_stdout(bins, trees):
    ref, port = on_both(bins, trees, "cdi-generate", env=NO_AMBIENT)
    assert port[0] == ref[0] == 0
    assert json.loads(port[1])["cdiVersion"] == "0.6.0"
    assert json.loads(port[1]) == spec_without_bounds(json.loads(ref[1]))


@pytest.mark.parametrize("how", ["env", "flag-beats-env"])
def test_node_agent_probe_env_and_flags(bins, trees, how):
    out = {}
    for s, (inst, glob) in PROBE_ENV.items():
        pattern = str(trees[s] / ("accel*" if s == "r" else "nvidia[0-9]*"))
        if how == "env":
            args, env = [], {inst: str(trees[s] / "host"), glob: pattern}
        else:
            args = ["--install-dir", trees[s] / "host",
                    "--device-glob", pattern]
            env = {glob: "/nonexistent/x*"}
        p = run(bins[s], binary(s, "node-agent"), "probe", *args, env=env)
        assert p.returncode == 0
        out[s] = p.stdout
    assert json.loads(out["p"])["devices"] == 2
    assert out["p"] == to_port(out["r"])


def test_cdi_spec_names_cards_by_minor_number(port_bins, tmp_path):
    """The spec's devices are named by the card's minor number (the name
    the device plugin's CDI strategy asks for, ``nvidia.com/gpu=<N>``); the
    driver's control nodes go to every GPU container, in the global edits;
    no device carries env."""
    root = side_tree(tmp_path, "p", nodes=0)
    for name in ("nvidia0", "nvidia3", "nvidiactl", "nvidia-uvm",
                 "nvidia-modeset"):
        (root / name).touch()
    p = run(port_bins, "gpu-node-agent", "cdi-generate",
            *agent_args(root, "p"), env=NO_AMBIENT)
    spec = json.loads(p.stdout)
    assert [d["name"] for d in spec["devices"]] == ["0", "3", "all"]
    assert all("env" not in d["containerEdits"] for d in spec["devices"])
    assert spec["containerEdits"]["deviceNodes"] == [
        {"path": str(root / "nvidiactl")}, {"path": str(root / "nvidia-uvm")}]
    assert spec["containerEdits"]["env"] == [
        "GPU_RUNTIME_MANAGED=gpu-operator"]


def test_cdi_spec_multinode_env_chain(port_bins, tmp_path):
    """Multi-node on → the feature-discovery worker-env file's identity and
    torch.distributed's rendezvous address reach every GPU container (the
    reference's multislice chain with the variables the port's fabric
    component reads: ``MASTER_ADDR`` is the first worker, ``MASTER_PORT``
    torch's default 29500)."""
    root = side_tree(tmp_path, "p")
    wf = root / "worker-env"
    wf.write_text("# written by gpu-feature-discovery\n"
                  "WORKER_ID=1\nWORKER_HOSTNAMES=h0,h1\n")

    def env_of(**env):
        p = run(port_bins, "gpu-node-agent", "cdi-generate",
                *agent_args(root, "p"), "--worker-env-file", wf,
                env={**NO_AMBIENT, **env})
        return json.loads(p.stdout)["containerEdits"]["env"]

    assert env_of(MULTINODE_ENABLED="true") == [
        "GPU_RUNTIME_MANAGED=gpu-operator", "MULTINODE_ENABLED=true",
        "WORKER_ID=1", "WORKER_HOSTNAMES=h0,h1", "MASTER_ADDR=h0",
        "MASTER_PORT=29500"]
    # the agent's own env wins over the staged file (operator overrides)
    env = env_of(MULTINODE_ENABLED="true", WORKER_ID="7",
                 MASTER_ADDR="coord", MASTER_PORT="1234")
    assert "WORKER_ID=7" in env and "MASTER_ADDR=coord" in env
    assert "MASTER_PORT=1234" in env and "MASTER_ADDR=h0" not in env
    # an empty value in the env erases a staged fact
    assert "WORKER_ID=1" not in env_of(MULTINODE_ENABLED="true", WORKER_ID="")
    # multi-node off → no worker identity
    assert env_of() == ["GPU_RUNTIME_MANAGED=gpu-operator"]


def test_runtime_configure_refreshes_on_worker_env_change(port_bins,
                                                          tmp_path):
    """The spec tracks its inputs: feature discovery writes the worker-env
    file on its own loop, possibly after this agent started."""
    root = side_tree(tmp_path, "p")
    wf = root / "worker-env"
    env = {**os.environ, "MULTINODE_ENABLED": "true"}
    for k in NO_AMBIENT:
        if k != "MULTINODE_ENABLED":
            env.pop(k, None)
    args = [a for a in agent_args(root, "p") if a != "--oneshot"]
    proc = subprocess.Popen(
        [str(port_bins / "gpu-node-agent"), "runtime-configure", *args,
         "--worker-env-file", str(wf), "--refresh-seconds", "1"],
        env=env, stdout=subprocess.PIPE, text=True)
    try:
        spec_path = root / "cdi" / "nvidia.json"
        for _ in range(100):
            if spec_path.exists():
                break
            time.sleep(0.1)
        env0 = json.loads(spec_path.read_text())["containerEdits"]["env"]
        assert not any(e.startswith("WORKER_ID") for e in env0)
        wf.write_text("WORKER_ID=1\nWORKER_HOSTNAMES=h0,h1\n")
        deadline = time.time() + 15
        while time.time() < deadline:
            env1 = json.loads(spec_path.read_text())["containerEdits"]["env"]
            if "WORKER_ID=1" in env1:
                break
            time.sleep(0.25)
        assert "WORKER_ID=1" in env1 and "MASTER_ADDR=h0" in env1
    finally:
        proc.terminate()
        proc.wait(timeout=10)
    # SIGTERM retracts the status file (preStop parity)
    assert status(root, "container-toolkit") is None


# -- presence: NVML's list, where NVML loads (F7) ----------------------------

def test_cdi_spec_and_install_follow_nvml(port_bins, tmp_path, nvml_so):
    """The fake NVML lists minors 0 and 2: ``nvidia1``, a node of a card
    this container may not use, stays out of the spec and the count, though
    its permission bits pass. An NVML that lists none of the nodes fails
    the install."""
    root = side_tree(tmp_path, "p", nodes=3)
    p = run(port_bins, "gpu-node-agent", "cdi-generate",
            *agent_args(root, "p"), "--nvml", nvml_so, env=NO_AMBIENT)
    spec = json.loads(p.stdout)
    uuid = FAKE_NVML_UUIDS
    assert [d["name"] for d in spec["devices"]] == [
        "0", uuid[0], "2", uuid[2], "all"]
    p = run(port_bins, "gpu-node-agent", "probe", "--install-dir",
            root / "host", "--device-glob", root / "nvidia[0-9]*",
            "--nvml", nvml_so)
    assert json.loads(p.stdout)["devices"] == 2
    for name in ("nvidia0", "nvidia2"):
        (root / name).unlink()
    p = run(port_bins, "gpu-node-agent", "driver-install",
            *agent_args(root, "p"), "--nvml", nvml_so)
    assert p.returncode == 1 and "no GPU devices" in p.stderr


@pytest.mark.parametrize("required,ok", [("580.159.03", True),
                                         ("575.51.03", False),
                                         ("latest", False)])
def test_driver_install_holds_the_required_version(port_bins, tmp_path,
                                                   required, ok):
    """``DRIVER_REQUIRED_VERSION`` (the operator's per-product pin from
    ``driver.versionMap``) must equal the staged library's version, read
    as the metrics agent reads it; otherwise the install fails and the
    ``driver`` status is not written."""
    root = side_tree(tmp_path, "p")
    img = root / "img"
    (img / "libcuda.so.1").unlink()
    shutil.copy(port_bins / "libfake-cuda.so", img / "libcuda.so.580.159.03")
    (img / "libcuda.so.1").symlink_to("libcuda.so.580.159.03")
    p = run(port_bins, "gpu-node-agent", "driver-install",
            *agent_args(root, "p"), env={"DRIVER_REQUIRED_VERSION": required})
    assert (p.returncode == 0) is ok, p.stderr
    assert os.path.exists(root / "validations" / "driver-ready") is ok
    if not ok:
        assert "DRIVER_REQUIRED_VERSION" in p.stderr


def test_cdi_spec_names_each_card_by_nvml_uuid_too(port_bins, tmp_path,
                                                 nvml_so):
    """F10: where NVML loads, each card's device appears twice, by minor
    number and by NVML UUID (the name the device plugin's CDI strategy
    asks for then), both holding that card's node; NVML's index 1 is
    minor 2. Without NVML, only minor numbers (the test above)."""
    root = side_tree(tmp_path, "p", nodes=3)
    p = run(port_bins, "gpu-node-agent", "cdi-generate",
            *agent_args(root, "p"), "--nvml", nvml_so, env=NO_AMBIENT)
    assert p.returncode == 0, p.stderr
    nodes = {d["name"]: d["containerEdits"]["deviceNodes"]
             for d in json.loads(p.stdout)["devices"]}
    for minor, uuid in FAKE_NVML_UUIDS.items():
        assert nodes[uuid] == nodes[str(minor)] == [
            {"path": str(root / f"nvidia{minor}")}]
    assert nodes["all"] == [{"path": str(root / f"nvidia{m}")}
                            for m in (0, 2)]
