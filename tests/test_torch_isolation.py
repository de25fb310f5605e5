"""The port stands alone: it imports nothing of JAX or the reference
package, importing it builds nothing, and without a CUDA card its entry
points raise instead of running on the CPU."""

import ast
import os
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(ROOT, "tpu_operator_torch")
FORBIDDEN = ("jax", "jaxlib", "optax", "tpu_operator")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PACKAGE):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module):
    return any(module == name or module.startswith(name + ".")
               for name in FORBIDDEN)


def test_scan_covers_the_package():
    rel = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert {"chip_smoke.py", "tpu_operator_torch/_native.py",
            "tpu_operator_torch/validator/components.py",
            "tpu_operator_torch/validator/driver_build.py",
            "tpu_operator_torch/validator/metrics.py",
            "tpu_operator_torch/cli/validator.py",
            "tpu_operator_torch/kube/fake.py",
            "tpu_operator_torch/kube/incluster.py",
            "tpu_operator_torch/utils/prom.py"} <= rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_matches_the_reference_but_not_the_port():
    assert _forbidden("tpu_operator") and _forbidden("tpu_operator.ops.hbm")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("tpu_operator_torch")
    assert not _forbidden("tpu_operator_torch.ops.hbm")


def test_import_builds_nothing_and_loads_no_jax():
    """Import every module of the port in a fresh interpreter where starting
    a process (nvcc) raises: the import must succeed, leave the kernel
    library unloaded, and pull in no JAX module."""
    code = textwrap.dedent("""
        import importlib, pkgutil, subprocess, sys
        def refuse(*a, **k):
            raise AssertionError("a process was started during import")
        subprocess.Popen = subprocess.run = refuse
        import tpu_operator_torch
        from tpu_operator_torch import _native
        names = [m.name for m in pkgutil.walk_packages(
            tpu_operator_torch.__path__, "tpu_operator_torch.")]
        for name in names:
            importlib.import_module(name)
        assert not _native.is_loaded()
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "optax", "tpu_operator"))
        assert not leaked, leaked
        print(len(names))
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 10


def _entry_points():
    from tpu_operator_torch.entry import dryrun_multigpu, entry
    from tpu_operator_torch.ops.burnin import init_burnin
    from tpu_operator_torch.ops.hbm import hbm_device_gbps, hbm_read_gbps
    from tpu_operator_torch.ops.matmul import matmul_tflops
    return {"entry": entry, "init_burnin": init_burnin,
            "dryrun_multigpu": lambda: dryrun_multigpu(4),
            "hbm_read_gbps": hbm_read_gbps,
            "hbm_device_gbps": hbm_device_gbps,
            "matmul_tflops": matmul_tflops}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_raise_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _entry_points()[name]()


def test_validator_fails_without_cuda(monkeypatch, tmp_path):
    from tpu_operator_torch.validator.components import (ValidationFailed,
                                                         WorkloadComponent)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(ValidationFailed, match="no CUDA device"):
        WorkloadComponent(validations_dir=str(tmp_path)).validate()


def test_cpu_wrappers_leave_the_launch_counters_at_zero():
    from tpu_operator_torch.ops import flash_attention as flash_mod
    from tpu_operator_torch.ops import hbm as hbm_mod
    x = torch.ones((64, 64))
    hbm_mod.read_sum(x, 3)
    flash_mod.flash_attention(x, x, x, causal=True)
    assert hbm_mod.read_sum.launches == 0
    assert flash_mod.flash_attention.launches == 0


def test_missing_toolkit_is_an_error(monkeypatch):
    import torch.utils.cpp_extension as cpp_extension
    from tpu_operator_torch import _native
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(_native.BuildError, match="nvcc"):
        _native.nvcc()
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", "/nonexistent-cuda")
    with pytest.raises(_native.BuildError, match="nvcc not found"):
        _native.nvcc()


def test_library_name_tracks_the_sources():
    from tpu_operator_torch import _native
    names = {p.name for p in _native.sources()}
    assert {"hbm_read.cu", "flash_fwd.cu"} <= names
    path = _native.library_path()
    assert path.parent == _native.BUILD_DIR
    assert path.name.startswith("libtpu_operator_torch_")
    assert path == _native.library_path()   # stable while sources are


def _fake_nvcc(tmp_path, fail_on=None):
    """A stand-in for nvcc that writes each ``-o`` target and exits 1 on
    a source named ``fail_on``."""
    script = tmp_path / "nvcc"
    script.write_text(
        "#!/bin/sh\n"
        + (f'case "$*" in *{fail_on}*) echo refused; exit 1;; esac\n'
           if fail_on else "")
        + 'while [ $# -gt 0 ]; do [ "$1" = -o ] && echo x > "$2"; shift; '
          "done\n")
    script.chmod(0o755)
    return script


def test_build_compiles_each_source_and_links_one_library(monkeypatch,
                                                          tmp_path):
    from tpu_operator_torch import _native
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "nvcc", lambda: _fake_nvcc(tmp_path))
    target = _native.build()
    assert target == _native.library_path() and target.exists()
    # the objects' directory is gone; only the library and its build log
    # (the compilers' output) stay
    assert sorted((tmp_path / "build").iterdir()) == sorted(
        [target, _native.log_path()])
    assert _native.build() == target      # reused, not rebuilt


def test_build_log_gives_each_kernels_registers_and_spills(monkeypatch,
                                                           tmp_path):
    """ptxas's report (``-Xptxas -v`` on each compile) lands in the build
    log; ``kernel_resources`` reads each kernel's registers and spills."""
    from tpu_operator_torch import _native
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    script = _fake_nvcc(tmp_path)
    report = (
        "ptxas info    : Compiling entry function '_Z4fooPf' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z4fooPf\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill "
        "loads\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n")
    text = script.read_text().replace(
        "#!/bin/sh\n", "#!/bin/sh\n"
        + f'case "$*" in *-Xptxas*) printf "{report}";; esac\n')
    script.write_text(text)
    monkeypatch.setattr(_native, "nvcc", lambda: script)
    _native.build()
    assert "Compiling entry function" in _native.log_path().read_text()
    assert _native.kernel_resources() == {"_Z4fooPf": (255, 12)}


def test_build_names_the_source_nvcc_refused(monkeypatch, tmp_path):
    from tpu_operator_torch import _native
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_native, "nvcc",
                        lambda: _fake_nvcc(tmp_path, "flash_fwd.cu"))
    with pytest.raises(_native.BuildError, match="flash_fwd.cu:\nrefused"):
        _native.build()
    assert not _native.library_path().exists()
    assert list((tmp_path / "build").iterdir()) == []
