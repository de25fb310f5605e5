"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into an object,
all sources at once in parallel (so the build time stays that of the
slowest source as kernels are added), and the objects are linked into one
shared library with a plain C interface that ``ctypes`` loads. Nothing includes
PyTorch's headers, so a build takes seconds, not minutes.

The build happens at the first launch on a CUDA tensor, never at import: the
CPU tests import every module on machines with no ``nvcc``. The library lands
in ``tpu_operator_torch/build/`` under a name keyed by a hash of the sources
and flags, so a changed source is rebuilt and an unchanged one is reused.

Every C entry point returns ``cudaGetLastError()`` after its launches, and
:func:`check` turns a non-zero code into an exception: a launch the driver
refuses (too much shared memory, a bad grid) never runs, and no later
synchronise would report it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# compiling only: ptxas reports each kernel's registers and spills, kept in
# the build log beside the library
COMPILE_FLAGS = ("-Xptxas", "-v")

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# argtypes of every C entry point; every pointer and the stream are c_void_p,
# or ctypes would pass them as 32-bit ints and cut them
_SIGNATURES = {
    "hbm_read_sum": (_P, _LL, _I, _P, _I, _P, _P),
    "flash_fwd_bf16": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I, _F,
                       _I, _P),
    "flash_fwd_wgmma": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                        _I, _I, _F, _I, _P),
    "flash_fwd_generic": (_P, _P, _P, _P, _P, _I, _P, _I, _P, _P, _I, _I, _I,
                          _I, _F, _I, _P),
    "ring_all_gather_f32": (_P, _I, _LL, _I, _LL, _LL, _P),
    "ring_reduce_scatter_f32": (_P, _I, _LL, _I, _LL, _LL, _P),
    "ring_all_reduce_f32": (_P, _I, _LL, _I, _LL, _LL, _P),
    "ring_all_reduce_bidir_f32": (_P, _I, _LL, _I, _LL, _LL, _P),
    "ring_resident_blocks": (_I, _P),
}

_lock = threading.Lock()
_library: ctypes.CDLL | None = None


class BuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + COMPILE_FLAGS).encode())
    for path in sorted(CSRC_DIR.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> Path:
    """The nvcc of the CUDA toolkit PyTorch found; its absence on a machine
    that launches CUDA kernels is an error, never a reason to fall back."""
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise BuildError("no CUDA toolkit found (CUDA_HOME is unset and nvcc "
                         "is not on PATH): cannot build the CUDA kernels")
    path = Path(CUDA_HOME) / "bin" / "nvcc"
    if not path.exists():
        raise BuildError(f"nvcc not found at {path}")
    return path


def library_path() -> Path:
    return BUILD_DIR / f"libtpu_operator_torch_{_digest()}.so"


def log_path() -> Path:
    return library_path().with_suffix(".log")


def build() -> Path:
    """Compile every source into the shared library unless it exists: one
    nvcc per source, all started together, then one link. The compilers'
    output (ptxas's report on every kernel) goes to :func:`log_path`."""
    target = library_path()
    if target.exists():
        return target
    compiler = str(nvcc())
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # a directory of its own, so concurrent first launches do not collide
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objects = [os.path.join(work, f"{src.stem}.o") for src in srcs]
        procs = [subprocess.Popen(
            [compiler, *NVCC_FLAGS, *COMPILE_FLAGS, "-c", str(src), "-o",
             obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(srcs, objects)]
        logs = [proc.communicate()[0] for proc in procs]
        failed = [f"{src.name}:\n{log}" for src, proc, log
                  in zip(srcs, procs, logs) if proc.returncode]
        if failed:
            raise BuildError("nvcc failed on " + "\n".join(failed))
        log = os.path.join(work, log_path().name)
        with open(log, "w") as f:
            f.write("".join(f"== {src.name}\n{text}"
                            for src, text in zip(srcs, logs)))
        linked = os.path.join(work, target.name)
        link = subprocess.run(
            [compiler, *NVCC_FLAGS, "-shared", "-o", linked, *objects],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise BuildError(f"nvcc failed to link:\n{link.stdout}")
        os.replace(log, log_path())
        os.replace(linked, target)
    return target


def kernel_resources() -> dict[str, tuple[int, int]]:
    """Each kernel's registers a thread and spilled bytes (stores plus
    loads), by mangled name, from ptxas's report in the build log."""
    out, name = {}, None
    for line in log_path().read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out.setdefault(name, [0, 0])[1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, [0, 0])[0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _library
    with _lock:
        if _library is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cuda_error_string.argtypes = (ctypes.c_int,)
            lib.cuda_error_string.restype = ctypes.c_char_p
            _library = lib
        return _library


def is_loaded() -> bool:
    return _library is not None


def check(err: int, what: str) -> None:
    if err:
        msg = library().cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
