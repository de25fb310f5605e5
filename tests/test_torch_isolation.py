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
            "tpu_operator_torch/utils/prom.py",
            "tpu_operator_torch/health/probes.py",
            "tpu_operator_torch/health/monitor.py",
            "tpu_operator_torch/utils/nvml.py",
            "tpu_operator_torch/deviceplugin/plugin.py",
            "tpu_operator_torch/operands/feature_discovery.py",
            "tpu_operator_torch/operands/metrics_exporter.py",
            "tpu_operator_torch/cli/metrics_exporter.py",
            "tpu_operator_torch/native/build.py",
            "tpu_operator_torch/operands/slice_manager.py",
            "tpu_operator_torch/cli/slice_manager.py",
            "tpu_operator_torch/api/v1alpha1.py",
            "tpu_operator_torch/api/crdgen.py",
            "tpu_operator_torch/api/schema.py",
            "tpu_operator_torch/controllers/resource_manager.py",
            "tpu_operator_torch/controllers/sharding.py",
            "tpu_operator_torch/controllers/object_controls.py",
            "tpu_operator_torch/controllers/state_manager.py"} <= rel


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_no_jax_and_no_reference(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert bad == [], f"{os.path.relpath(path, ROOT)} imports {bad}"


#: the reference's names that must not be left in the port's manifests
TPU_NAMES = ("tpu.dev/", "libtpu", "tpu-validator")


def _manifests():
    out = []
    for sub in ("assets", "config"):
        for dirpath, _, names in os.walk(os.path.join(PACKAGE, sub)):
            out += [os.path.join(dirpath, n) for n in names
                    if n.endswith((".yaml", ".yml"))]
    return sorted(out)


def test_manifests_carry_no_tpu_names():
    """The assets the pipeline renders, the CRD and the sample: 52 asset
    files, none naming the reference's group, library or validator."""
    files = _manifests()
    assert sum("/assets/" in f for f in files) == 52
    for path in files:
        text = open(path).read()
        left = [n for n in TPU_NAMES if n in text]
        assert left == [], f"{os.path.relpath(path, ROOT)} names {left}"


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


def _native_sources():
    native = os.path.join(PACKAGE, "native")
    return sorted(os.path.join(d, n) for d, _, names in os.walk(native)
                  for n in names if n.endswith((".cc", ".h")))


def test_native_scan_covers_the_agents():
    rel = {os.path.relpath(p, PACKAGE) for p in _native_sources()}
    assert {"native/common/util.h", "native/common/json.h",
            "native/common/nvml.h", "native/gpu_smoke/main.cc",
            "native/gpu_smoke/cuda_add.cc", "native/gpu_node_agent/main.cc",
            "native/gpu_metrics_agent/main.cc", "native/gpu_oci_hook/main.cc",
            "native/fake_cuda/fake_cuda.cc"} <= rel


@pytest.mark.parametrize("path", _native_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_native_includes_stay_in_the_port(path):
    """The agents' C++ includes system headers and the port's own files
    only: nothing under the reference's ``native/`` (its helpers, its
    vendored PJRT header) and no CUDA or NVML header."""
    native = os.path.join(PACKAGE, "native")
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("#include"):
                continue
            target = line.split(None, 1)[1]
            if target.startswith('"'):
                inc = os.path.normpath(os.path.join(os.path.dirname(path),
                                                    target.strip('"')))
                assert inc.startswith(native + os.sep) and \
                    os.path.exists(inc), f"{path}: {line}"
            else:
                assert not any(h in target for h in ("cuda", "nvml", "pjrt",
                                                     "tpu")), line


def test_exporter_imports_nothing_of_the_reference(tmp_path):
    """A fresh interpreter that imports the metrics exporter and its CLI
    and renders a page (which reads the validator's component list) holds
    no module of the reference package or of JAX."""
    (tmp_path / "driver-ready").touch()
    code = textwrap.dedent("""
        import sys
        from tpu_operator_torch.cli import metrics_exporter as cli
        from tpu_operator_torch.operands.metrics_exporter import \\
            MetricsExporter
        page = MetricsExporter("127.0.0.1:1",
                               validations_dir=sys.argv[1]).render()
        assert 'component="driver"} 1' in page, page
        leaked = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "tpu_operator"))
        assert not leaked, leaked
    """)
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
