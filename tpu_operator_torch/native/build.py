"""Build the GPU node agents (``native/*/*.cc``) with the host C++ compiler.

The port of the reference's native build (``native/CMakeLists.txt``),
without cmake: each target is one ``g++ -std=c++17 -O2 -Wall -Wextra``
command that links ``-ldl``, all started together. The agents reach the
driver's libraries (``libcuda.so.1``, ``libnvidia-ml.so.1``) by ``dlopen``
only, so no CUDA header or library is needed to build them.

The build happens at first use, never at import: the tests import every
module. The binaries land in ``tpu_operator_torch/build/`` in a directory
named by a hash of the sources and flags, so a changed source is rebuilt
and an unchanged one reused; a file lock makes concurrent first users (the
test workers) build once, and the directory appears whole or not at all.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "build"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra")

#: target → (sources relative to NATIVE_DIR, extra flags)
TARGETS = {
    "gpu-smoke": (("gpu_smoke/main.cc", "gpu_smoke/cuda_add.cc"), ()),
    "gpu-node-agent": (("gpu_node_agent/main.cc",), ()),
    "gpu-metrics-agent": (("gpu_metrics_agent/main.cc",), ()),
    "gpu-oci-hook": (("gpu_oci_hook/main.cc",), ()),
    # test-only: a libcuda.so.1 stand-in for gpu-smoke --run-add on the CPU
    "libfake-cuda.so": (("fake_cuda/fake_cuda.cc",), ("-shared", "-fPIC")),
}


class BuildError(RuntimeError):
    """No C++ compiler, or the compiler refused a source."""


def compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise BuildError("no C++ compiler (g++) on PATH: cannot build the "
                     "node agents")


def sources() -> list[Path]:
    return sorted(p for p in NATIVE_DIR.rglob("*")
                  if p.suffix in (".cc", ".h"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for target, (srcs, flags) in sorted(TARGETS.items()):
        h.update(f"{target}:{srcs}:{flags}".encode())
    for path in sources():
        h.update(str(path.relative_to(NATIVE_DIR)).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def output_dir() -> Path:
    return BUILD_DIR / f"native-{_digest()}"


def build() -> Path:
    """The directory holding every target, compiled unless it exists."""
    target = output_dir()
    if target.exists():
        return target
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / f"{target.name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if target.exists():          # another process built it meanwhile
            return target
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
            procs = {
                name: subprocess.Popen(
                    [cxx, *CXX_FLAGS, *flags,
                     *(str(NATIVE_DIR / s) for s in srcs),
                     "-o", os.path.join(work, name), "-ldl"],
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)
                for name, (srcs, flags) in TARGETS.items()}
            logs = {name: proc.communicate()[0]
                    for name, proc in procs.items()}
            failed = [f"{name}:\n{logs[name]}"
                      for name, proc in procs.items() if proc.returncode]
            if failed:
                raise BuildError("g++ failed on " + "\n".join(failed))
            os.chmod(work, 0o755)
            os.replace(work, target)
            # TemporaryDirectory's cleanup must not find the moved directory
            os.mkdir(work)
    return target
