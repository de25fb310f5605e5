"""Shared set-up for the tests of the port's node agents (C++).

``port_bins`` builds the port's binaries through
``tpu_operator_torch.native.build`` (the path ``chip_smoke.py`` takes);
``ref_bins`` builds the reference's ``native/`` with cmake into a
directory of this test session's own (under pytest's base temporary
directory, shared by the xdist workers under a file lock), never into
``native/build/``, which ``tests/test_native.py`` owns. Each skips with a
reason where its compiler is absent.

``side_tree`` makes a fixture node for each side, ``r`` (reference) and
``p`` (port): device nodes ``accel0``/``accel1`` against
``nvidia0``/``nvidia1``, a loadable driver-library payload (a copy of the
system's libc, which ``dlopen`` loads) as ``img/libtpu.so`` against
``img/libcuda.so.1``, and the host, CDI, containerd and validations
directories. ``to_port`` maps the reference's names onto the port's
(``NAME_MAP``), so one side's output can be compared with the other's.
"""

from __future__ import annotations

import fcntl
import json
import os
import re
import shutil
import subprocess
from pathlib import Path

import pytest

from torch_fake_libcuda import system_libc

ROOT = Path(__file__).resolve().parent.parent

#: the reference's names → the port's, applied in order to the reference's
#: output (text or JSON). Paths of the fixture trees map by side (``/r/`` →
#: ``/p/``); the rest is the TPU → GPU rename of the binaries' contract.
NAME_MAP = (
    (r"/r/", "/p/"),
    (r"/run/tpu/", "/run/nvidia/"),
    (r"\baccel(\d+)", r"nvidia\1"),
    (r"accel\*", "nvidia[0-9]*"),
    (r"tpu\.dev/chip", "nvidia.com/gpu"),
    (r"tpu\.dev/inject", "nvidia.com/inject"),
    (r"tpu\.dev/\*", "nvidia.com/*"),
    (r"TPU_VISIBLE_CHIPS", "NVIDIA_VISIBLE_DEVICES"),
    (r"TPU_RUNTIME_MANAGED=tpu-operator", "GPU_RUNTIME_MANAGED=gpu-operator"),
    (r"LIBTPU_INSTALL_DIR", "DRIVER_INSTALL_DIR"),
    (r"TPU_DEVICE_GLOB", "GPU_DEVICE_GLOB"),
    (r"/lib/libtpu\.so", "/usr/lib/x86_64-linux-gnu/libcuda.so.1"),
    (r"libtpu\.so", "libcuda.so.1"),
    (r"libtpu-install", "driver-install"),
    (r"libtpu installed", "driver installed"),
    (r'"component": "libtpu"', '"component": "driver"'),
    (r'"component": "runtime-hook"', '"component": "container-toolkit"'),
    (r'"pjrt_api"', '"driver_api"'),
    (r'"libtpu"', '"libcuda"'),
    (r"tpu\.json", "nvidia.json"),
    (r"tpu-runtime\.toml", "nvidia-container-runtime.toml"),
    (r"runtimes\.tpu-cdi\]", "runtimes.nvidia-cdi]"),
    (r"runtimes\.tpu\]", "runtimes.nvidia]"),
    (r"tpu-node-agent", "gpu-node-agent"),
    (r"tpu-oci-hook", "gpu-oci-hook"),
    (r"tpu_agent_libtpu_loadable", "gpu_agent_driver_loadable"),
    (r"tpu_agent_libtpu_build_epoch", "gpu_agent_driver_build_epoch"),
    (r"tpu_agent_libtpu_skew", "gpu_agent_driver_skew"),
    (r"tpu_agent_", "gpu_agent_"),
    (r"libtpu\.so dlopens", "libcuda.so.1 dlopens"),
    (r"TPU device nodes visible", "GPU device nodes present"),
    (r"per-device sysfs attribute", "per-device attribute"),
    (r"TPU device", "GPU device"),
)


def to_port(obj):
    """``obj`` (a string, or anything JSON holds) with the reference's
    names replaced by the port's."""
    text = obj if isinstance(obj, str) else json.dumps(obj)
    for pat, repl in NAME_MAP:
        text = re.sub(pat, repl, text)
    return text if isinstance(obj, str) else json.loads(text)


def _session_dir(tmp_path_factory) -> Path:
    """A directory every worker of this test session shares."""
    base = tmp_path_factory.getbasetemp()
    return base.parent if os.environ.get("PYTEST_XDIST_WORKER") else base


@pytest.fixture(scope="session")
def port_bins() -> Path:
    from tpu_operator_torch.native import build
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("needs a C++ compiler to build the node agents")
    return build.build()


@pytest.fixture(scope="session")
def ref_bins(tmp_path_factory) -> Path:
    if shutil.which("cmake") is None or shutil.which("g++") is None:
        pytest.skip("needs cmake and g++ to build the reference's agents")
    out = _session_dir(tmp_path_factory) / "reference-native"
    with open(str(out) + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (out / "tpu-smoke").exists():
            subprocess.run(["cmake", "-S", str(ROOT / "native"), "-B",
                            str(out)], check=True, capture_output=True)
            subprocess.run(["cmake", "--build", str(out), "-j", "4"],
                           check=True, capture_output=True)
    return out


def run(bins: Path, name: str, *args, env=None, input=None):
    merged = {**os.environ, **(env or {})}
    # None = remove the variable entirely (ambient-env isolation)
    merged = {k: v for k, v in merged.items() if v is not None}
    return subprocess.run([str(bins / name), *map(str, args)],
                          capture_output=True, text=True, timeout=60,
                          env=merged, input=input)


SIDES = {"r": ("accel", "libtpu.so"), "p": ("nvidia", "libcuda.so.1")}


def side_tree(tmp_path: Path, side: str, payload: str | None = None,
              nodes: int = 2) -> Path:
    """A fake node of ``side`` under ``tmp_path/side`` (see the module
    docstring); ``payload`` replaces libc as the driver library."""
    prefix, lib = SIDES[side]
    root = tmp_path / side
    (root / "img").mkdir(parents=True)
    shutil.copy(payload or system_libc(), root / "img" / lib)
    for i in range(nodes):
        (root / f"{prefix}{i}").touch()
    for d in ("host", "cdi", "containerd", "validations"):
        (root / d).mkdir()
    return root


def agent_args(root: Path, side: str) -> list[str]:
    """The node agent's flags on a fixture tree, as the reference's tests
    pass them (``--source`` is the payload file there, its directory
    here)."""
    prefix, lib = SIDES[side]
    source = root / "img" / lib if side == "r" else root / "img"
    return ["--source", str(source),
            "--install-dir", str(root / "host"),
            "--device-glob", str(root / f"{prefix}*"
                                 if side == "r" else root / "nvidia[0-9]*"),
            "--cdi-spec-dir", str(root / "cdi"),
            "--containerd-config", str(root / "containerd/config.toml"),
            "--validations-dir", str(root / "validations"),
            "--oneshot"]


def install_cmd(side: str) -> str:
    return "libtpu-install" if side == "r" else "driver-install"


def binary(side: str, what: str) -> str:
    """A binary by its role: smoke, node-agent, metrics-agent, oci-hook."""
    return ("tpu-" if side == "r" else "gpu-") + what


#: the worker-identity variables both agents read; removed from the
#: ambient environment where a test sets its own
NO_AMBIENT = {k: None for k in (
    "TPU_WORKER_ID", "TPU_WORKER_HOSTNAMES", "TPU_ACCELERATOR_TYPE",
    "TPU_TOPOLOGY", "MEGASCALE_COORDINATOR_ADDRESS", "MEGASCALE_NUM_SLICES",
    "MEGASCALE_SLICE_ID", "MEGASCALE_PORT", "MEGASCALE_COORDINATOR_PORT",
    "MULTISLICE_ENABLED", "WORKER_ID", "WORKER_HOSTNAMES", "MASTER_ADDR",
    "MASTER_PORT", "MULTINODE_ENABLED")}
