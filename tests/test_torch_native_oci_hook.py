"""``gpu-oci-hook`` against the reference's ``tpu-oci-hook``.

The parity tests edit one OCI bundle on each side of the same fixture
node and compare the edited ``config.json`` (and the hooks.d config)
after ``torch_native.NAME_MAP``: ``TPU_VISIBLE_CHIPS`` →
``NVIDIA_VISIBLE_DEVICES``, the annotation ``tpu.dev/inject`` →
``nvidia.com/inject``, the ``libtpu.so`` mount → ``libcuda.so.1`` at the
path the device plugin mounts it. By design, the reference's
``TPU_CHIPS_PER_HOST_BOUNDS`` has no counterpart (no CUDA runtime reads ICI
bounds; it is taken off the reference's env before the comparison), and
the port's hooks.d entry carries ``NVIDIA_DRIVER_ROOT`` beside the install
dir. Then the port alone: real character devices with their major and
minor, the driver's control nodes, ``void``/``none``, the multi-node env,
and presence by a fake NVML's list.
"""

import json
import os
import subprocess

import pytest

from torch_fake_nvml import nvml_so  # noqa: F401 (a fixture)
from torch_native import (NO_AMBIENT, SIDES, binary, port_bins,  # noqa: F401
                          ref_bins, run, side_tree, to_port)

ENV_KEY = {"r": "TPU_VISIBLE_CHIPS", "p": "NVIDIA_VISIBLE_DEVICES"}
ANNOTATION = {"r": "tpu.dev/inject", "p": "nvidia.com/inject"}


def bundle_of(root, side, env=None, name="bundle"):
    bundle = root / name
    bundle.mkdir(exist_ok=True)
    config = {
        "ociVersion": "1.0.2",
        "process": {"args": ["python"], "cwd": "/",
                    "env": env if env is not None else
                    ["PATH=/usr/bin", f"{ENV_KEY[side]}=all"]},
        "mounts": [{"destination": "/proc", "type": "proc",
                    "source": "proc"}],
        "linux": {"resources": {}},
    }
    (bundle / "config.json").write_text(json.dumps(config))
    return bundle


def hook_args(root, side, non_char=True):
    # fixture device nodes are regular files, not char devices
    glob = root / ("accel*" if side == "r" else "nvidia[0-9]*")
    args = ["--device-glob", glob, "--install-dir", root / "img"]
    if side == "p":
        args += ["--nvml", "absent"]
    return args + (["--allow-non-char"] if non_char else [])


def hook(bins, side, *args, env=None, input=None):
    return run(bins, binary(side, "oci-hook"), *args,
               env={**NO_AMBIENT, **(env or {})}, input=input)


def no_bounds(config):
    env = config.get("process", {}).get("env", [])
    config["process"]["env"] = [e for e in env if not e.startswith(
        "TPU_CHIPS_PER_HOST_BOUNDS=")]
    return config


@pytest.fixture
def trees(tmp_path):
    return {s: side_tree(tmp_path, s) for s in SIDES}


@pytest.fixture
def bins(ref_bins, port_bins):
    return {"r": ref_bins, "p": port_bins}


def inject_both(bins, trees, env_of=None, annotate=None, non_char=True,
                times=1):
    """Inject into a bundle on each side; returns (rc, config) of each,
    the reference's under the port's names and without its bounds."""
    out = {}
    for s in SIDES:
        bundle = bundle_of(trees[s], s,
                           env=env_of(s) if env_of is not None else None)
        if annotate is not None:
            c = json.loads((bundle / "config.json").read_text())
            c["annotations"] = {ANNOTATION[s]: annotate}
            (bundle / "config.json").write_text(json.dumps(c))
        for _ in range(times):
            p = hook(bins[s], s, "inject", "--bundle", bundle,
                     *hook_args(trees[s], s, non_char))
        out[s] = (p.returncode, json.loads((bundle / "config.json")
                                           .read_text()), p.stderr)
    rc, config, err = out["r"]
    return (rc, no_bounds(to_port(config)), to_port(err)), out["p"]


def test_oci_hook_injects_devices_mount_env(bins, trees):
    ref, port = inject_both(bins, trees)
    rc, c, err = port
    assert rc == 0, err
    assert [d["path"] for d in c["linux"]["devices"]] == \
        [str(trees["p"] / "nvidia0"), str(trees["p"] / "nvidia1")]
    allows = c["linux"]["resources"]["devices"]
    assert all(a["allow"] and a["access"] == "rwm" for a in allows)
    mount = [m for m in c["mounts"] if m["destination"] ==
             "/usr/lib/x86_64-linux-gnu/libcuda.so.1"]
    assert mount and mount[0]["options"] == ["ro", "rbind", "nosuid",
                                             "nodev"]
    assert mount[0]["source"] == str(trees["p"] / "img" / "libcuda.so.1")
    assert "GPU_RUNTIME_MANAGED=gpu-operator" in c["process"]["env"]
    assert ref[:2] == port[:2]


def test_oci_hook_selective_devices(bins, trees):
    ref, port = inject_both(bins, trees,
                            env_of=lambda s: [f"{ENV_KEY[s]}=1"])
    assert [d["path"] for d in port[1]["linux"]["devices"]] == \
        [str(trees["p"] / "nvidia1")]
    assert ref[:2] == port[:2]


def test_oci_hook_noop_without_activation(bins, trees):
    for s in SIDES:
        bundle = bundle_of(trees[s], s, env=["PATH=/usr/bin"])
        before = (bundle / "config.json").read_text()
        p = hook(bins[s], s, "inject", "--bundle", bundle,
                 *hook_args(trees[s], s))
        assert p.returncode == 0
        assert (bundle / "config.json").read_text() == before


@pytest.mark.parametrize("value", ["void", "none"])
def test_oci_hook_noop_on_void_and_none(port_bins, tmp_path, value):
    """The NVIDIA toolkit's values for "no GPU": a no-op, never a failed
    container start."""
    root = side_tree(tmp_path, "p")
    bundle = bundle_of(root, "p", env=[f"NVIDIA_VISIBLE_DEVICES={value}"])
    before = (bundle / "config.json").read_text()
    p = hook(port_bins, "p", "inject", "--bundle", bundle,
             *hook_args(root, "p"))
    assert p.returncode == 0
    assert (bundle / "config.json").read_text() == before


def test_oci_hook_annotation_activation(bins, trees):
    ref, port = inject_both(bins, trees, env_of=lambda s: ["PATH=/usr/bin"],
                            annotate="true")
    assert port[0] == 0, port[2]
    assert len(port[1]["linux"]["devices"]) == 2
    assert "NVIDIA_VISIBLE_DEVICES=all" in port[1]["process"]["env"]
    assert ref[:2] == port[:2]


def test_oci_hook_idempotent(bins, trees):
    ref, port = inject_both(bins, trees, times=2)
    c = port[1]
    assert port[0] == 0
    assert len(c["linux"]["devices"]) == 2
    assert len([m for m in c["mounts"] if m["destination"].endswith(
        "libcuda.so.1")]) == 1
    assert len([e for e in c["process"]["env"]
                if e.startswith("GPU_RUNTIME_MANAGED=")]) == 1
    assert ref[:2] == port[:2]


def test_oci_hook_create_runtime_stdin(bins, trees):
    configs = {}
    for s in SIDES:
        bundle = bundle_of(trees[s], s)
        state = json.dumps({"ociVersion": "1.0.2", "id": "c1", "pid": 42,
                            "bundle": str(bundle)})
        p = hook(bins[s], s, "create-runtime", *hook_args(trees[s], s),
                 input=state)
        assert p.returncode == 0, p.stderr
        configs[s] = json.loads((bundle / "config.json").read_text())
    assert len(configs["p"]["linux"]["devices"]) == 2
    assert configs["p"] == no_bounds(to_port(configs["r"]))


@pytest.mark.parametrize("state", ["{not json", '{"id": "c1"}'])
def test_oci_hook_create_runtime_bad_state(bins, trees, state):
    for s in SIDES:
        p = hook(bins[s], s, "create-runtime", *hook_args(trees[s], s),
                 input=state)
        assert p.returncode == 1


def test_oci_hook_bad_config_fails(bins, trees):
    for s in SIDES:
        bundle = trees[s] / "bundle2"
        bundle.mkdir()
        (bundle / "config.json").write_text("{not json")
        p = hook(bins[s], s, "inject", "--bundle", bundle, "--devices",
                 "all", *hook_args(trees[s], s))
        assert p.returncode == 1
        assert "bad config.json" in p.stderr


def test_oci_hook_skips_non_char_by_default(bins, trees):
    ref, port = inject_both(bins, trees, non_char=False)
    assert port[0] == 1
    assert "no injectable GPU devices" in port[2]
    assert ref == port


def test_oci_hook_config_for_hooks_d(bins):
    cfgs = {s: json.loads(hook(bins[s], s, "hook-config", "--hook-path",
                               f"/host/bin/{binary(s, 'oci-hook')}").stdout)
            for s in SIDES}
    cfg = cfgs["p"]
    assert cfg["hook"]["path"] == "/host/bin/gpu-oci-hook"
    assert cfg["stages"] == ["createRuntime"]
    assert cfg["when"]["annotations"] == {"nvidia.com/inject": "true"}
    assert "NVIDIA_DRIVER_ROOT=/" in cfg["hook"]["env"]
    ref = to_port(cfgs["r"])
    # the install dir: the reference's default location, the port's "look
    # under the driver root", which it names beside it
    ref["hook"]["env"][0] = "DRIVER_INSTALL_DIR="
    ref["hook"]["env"].append("NVIDIA_DRIVER_ROOT=/")
    assert cfg == ref


@pytest.mark.parametrize("host_dest", [None, "/usr/local/bin"])
def test_oci_hook_install(bins, tmp_path, host_dest):
    for s in SIDES:
        name = binary(s, "oci-hook")
        dest = tmp_path / s / "mnt" / "host-bin"
        hooksd = tmp_path / s / "hooks.d"
        extra = ["--host-dest", host_dest] if host_dest else []
        p = hook(bins[s], s, "install", "--dest", dest, "--hooks-d", hooksd,
                 *extra)
        assert p.returncode == 0, p.stderr
        assert os.access(dest / name, os.X_OK)
        cfg = json.loads((hooksd / f"99-{name}.json").read_text())
        # the hooks.d config is read by the HOST runtime: the host's path
        assert cfg["hook"]["path"] == f"{host_dest or dest}/{name}"
        # the installed copy is a working binary
        q = subprocess.run([str(dest / name), "hook-config"],
                           capture_output=True, text=True, timeout=60)
        assert q.returncode == 0 and json.loads(q.stdout)["stages"]


def test_oci_hook_install_needs_dest(port_bins):
    assert hook(port_bins, "p", "install").returncode == 2
    assert hook(port_bins, "p", "inject").returncode == 2
    assert hook(port_bins, "p", "bogus").returncode == 2
    assert hook(port_bins, "p").returncode == 2


def test_hook_config_bakes_operator_env(port_bins, tmp_path):
    """The runtime execs the installed hook with ITS environment, so the
    hooks.d entry carries the operator's config (the multi-node toggle,
    the rendezvous port, the paths)."""
    dest, hooks = tmp_path / "bin", tmp_path / "hooks.d"
    p = hook(port_bins, "p", "install", "--dest", dest, "--host-dest",
             "/usr/local/bin", "--hooks-d", hooks,
             "--install-dir", tmp_path / "host",
             "--worker-env-file", tmp_path / "worker-env",
             env={"MULTINODE_ENABLED": "true", "MASTER_PORT": "29501"})
    assert p.returncode == 0, p.stderr
    env = json.loads((hooks / "99-gpu-oci-hook.json").read_text())["hook"][
        "env"]
    assert "MULTINODE_ENABLED=true" in env and "MASTER_PORT=29501" in env
    assert f"WORKER_ENV_FILE={tmp_path / 'worker-env'}" in env
    assert f"DRIVER_INSTALL_DIR={tmp_path / 'host'}" in env
    # multi-node off → no stale toggle in the entry
    hook(port_bins, "p", "install", "--dest", dest, "--hooks-d", hooks)
    env = json.loads((hooks / "99-gpu-oci-hook.json").read_text())["hook"][
        "env"]
    assert not any(e.startswith(("MULTINODE", "MASTER")) for e in env)


def test_oci_hook_injects_multinode_env(port_bins, tmp_path):
    """The hook injects the same workload env as the CDI path."""
    root = side_tree(tmp_path, "p")
    (root / "worker-env").write_text("WORKER_ID=0\nWORKER_HOSTNAMES=h0,h1\n")
    bundle = bundle_of(root, "p")
    p = hook(port_bins, "p", "inject", "--bundle", bundle,
             *hook_args(root, "p"), "--worker-env-file", root / "worker-env",
             env={"MULTINODE_ENABLED": "true"})
    assert p.returncode == 0, p.stderr
    env = json.loads((bundle / "config.json").read_text())["process"]["env"]
    cdi = run(port_bins, "gpu-node-agent", "cdi-generate", "--device-glob",
              root / "nvidia[0-9]*", "--install-dir", root / "img",
              "--nvml", "absent", "--worker-env-file", root / "worker-env",
              env={**NO_AMBIENT, "MULTINODE_ENABLED": "true"})
    want = json.loads(cdi.stdout)["containerEdits"]["env"]
    assert "WORKER_ID=0" in want and "MASTER_ADDR=h0" in want
    assert env == ["PATH=/usr/bin", "NVIDIA_VISIBLE_DEVICES=all", *want]


@pytest.mark.parametrize("value,want", [("0,1", [0, 1]), ("1,0", [1, 0]),
                                        ("3", []), ("0,3", [0])])
def test_oci_hook_subset_activation(port_bins, tmp_path, value, want):
    """A subset names cards by number; the reference's per-allocation
    ``TPU_CHIPS_PER_HOST_BOUNDS`` has no counterpart, so nothing but the
    cards, the mount and the env are injected. A selection of no present
    card fails."""
    root = side_tree(tmp_path, "p", nodes=3)
    bundle = bundle_of(root, "p", env=[f"NVIDIA_VISIBLE_DEVICES={value}"])
    p = hook(port_bins, "p", "inject", "--bundle", bundle,
             *hook_args(root, "p"))
    c = json.loads((bundle / "config.json").read_text())
    if not want:
        assert p.returncode == 1 and "no GPU devices match" in p.stderr
        return
    assert p.returncode == 0, p.stderr
    assert [d["path"] for d in c["linux"]["devices"]] == \
        [str(root / f"nvidia{i}") for i in want]
    assert not any(e.startswith("TPU_") for e in c["process"]["env"])


def test_oci_hook_injects_real_char_devices_and_control_nodes(port_bins,
                                                              tmp_path):
    """Without ``--allow-non-char``: a character device is injected with
    the major and minor ``stat`` gives it (here ``/dev/null`` behind the
    card's name), and the driver's control nodes beside the glob go in
    too."""
    d = tmp_path / "dev"
    d.mkdir()
    for name in ("nvidia4", "nvidiactl", "nvidia-uvm"):
        (d / name).symlink_to("/dev/null")
    bundle = bundle_of(tmp_path, "p")
    p = hook(port_bins, "p", "inject", "--bundle", bundle, "--device-glob",
             d / "nvidia[0-9]*", "--nvml", "absent", "--install-dir",
             tmp_path / "none")
    assert p.returncode == 0, p.stderr
    c = json.loads((bundle / "config.json").read_text())
    st = os.stat("/dev/null")
    want = [(str(d / n), os.major(st.st_rdev), os.minor(st.st_rdev))
            for n in ("nvidia4", "nvidiactl", "nvidia-uvm")]
    assert [(x["path"], x["major"], x["minor"])
            for x in c["linux"]["devices"]] == want
    assert [(a["major"], a["minor"]) for a in
            c["linux"]["resources"]["devices"]] == [w[1:] for w in want]
    assert "mounts" not in c or not any(
        m["destination"].endswith("libcuda.so.1") for m in c["mounts"])


def test_oci_hook_injects_only_cards_nvml_lists(port_bins, tmp_path,
                                                nvml_so):
    """F7: ``nvidia1`` passes its permission bits but NVML (the fake lists
    minors 0 and 2) does not list it, so "all" leaves it out and naming it
    fails."""
    root = side_tree(tmp_path, "p", nodes=3)
    args = ["--device-glob", root / "nvidia[0-9]*", "--install-dir",
            root / "img", "--nvml", nvml_so, "--allow-non-char"]
    bundle = bundle_of(root, "p")
    p = hook(port_bins, "p", "inject", "--bundle", bundle, *args)
    assert p.returncode == 0, p.stderr
    c = json.loads((bundle / "config.json").read_text())
    assert [x["path"] for x in c["linux"]["devices"]] == \
        [str(root / "nvidia0"), str(root / "nvidia2")]
    bundle = bundle_of(root, "p", env=["NVIDIA_VISIBLE_DEVICES=1"],
                       name="b1")
    p = hook(port_bins, "p", "inject", "--bundle", bundle, *args)
    assert p.returncode == 1
