"""The port's driver version-skew detector (``validator/driver_build.py``)
and the components that use it, on fixture trees: a root with a stamped fake
``libcuda.so.1`` (a copy of libc, which dlopen loads) and a fixture
``proc/driver/nvidia/version``. The scenarios are the reference's libtpu
build-skew tests (``tests/test_validator.py``) with the libtpu stamp read as
the driver version."""

import ctypes
import ctypes.util
import os
import shutil

import pytest

from tpu_operator.validator import libtpu_build as ref_lb
from tpu_operator_torch.validator import driver_build as lb
from tpu_operator_torch.validator.components import (DriverComponent,
                                                     ValidationFailed,
                                                     WorkloadComponent)
from tpu_operator_torch.validator.metrics import NodeMetrics

OLD, NEW = "550.54.15", "560.35.03"
NVRM = ("NVRM version: NVIDIA UNIX x86_64 Kernel Module  {}  Tue Mar  5 "
        "22:23:09 UTC 2024\nGCC version:  gcc version 12.3.0 (GCC)\n")
LIB_DIR = "usr/lib/x86_64-linux-gnu"


def _libc() -> str:
    src = ctypes.CDLL(ctypes.util.find_library("c"))._name
    return src if os.path.isabs(src) else "/lib/x86_64-linux-gnu/libc.so.6"


def _root(tmp_path, lib: str | None = None, module: str | None = None,
          named: bool = False, devices: int = 1):
    """A fixture driver root: ``libcuda.so.1`` stamped with ``lib`` (in its
    bytes, or ``named``: as a link to ``libcuda.so.<lib>``), the kernel
    module's version file for ``module``, and ``devices`` device nodes."""
    root = tmp_path / "root"
    libdir = root / LIB_DIR
    libdir.mkdir(parents=True, exist_ok=True)
    if lib is not None:
        target = libdir / (f"libcuda.so.{lib}" if named else "libcuda.so.1")
        shutil.copy(_libc(), target)
        if named:
            os.symlink(target.name, libdir / "libcuda.so.1")
        else:
            with open(target, "ab") as f:
                f.write(b"\0" + lib.encode() + b"\0")
    if module is not None:
        proc = root / "proc/driver/nvidia"
        proc.mkdir(parents=True, exist_ok=True)
        (proc / "version").write_text(NVRM.format(module))
    dev = tmp_path / "dev"
    dev.mkdir(exist_ok=True)
    for i in range(devices):
        (dev / f"nvidia{i}").touch()
    (dev / "nvidiactl").touch()
    return root


def _driver(tmp_path, root, vdir, **kw):
    return DriverComponent(driver_root=str(root),
                           device_glob=str(tmp_path / "dev/nvidia[0-9]*"),
                           validations_dir=vdir, **kw)


@pytest.fixture
def vdir(tmp_path):
    d = tmp_path / "validations"
    d.mkdir()
    return str(d)


@pytest.mark.parametrize("named", [False, True])
def test_version_read_from_the_name_or_the_bytes(tmp_path, named):
    root = _root(tmp_path, NEW, named=named)
    lib = str(root / LIB_DIR / "libcuda.so.1")
    assert lb.extract_build(lib) == NEW
    assert lb.build_epoch(lb.extract_build(lib)) == 560035003


def test_epochs_order_versions_and_parse_the_module_line():
    assert lb.build_epoch(OLD) == 550054015
    assert lb.build_epoch("535.104") == 535104000
    assert lb.build_epoch(OLD) < lb.build_epoch("550.54.16") \
        < lb.build_epoch("550.90.07") < lb.build_epoch(NEW)
    assert lb.build_epoch(NVRM.format(OLD)) == 550054015
    assert lb.build_epoch(
        "NVRM version: NVIDIA UNIX Open Kernel Module for x86_64  "
        "560.35.03  Release Build  (dvs-builder@U16)  Fri Aug 16") \
        == 560035003
    assert lb.build_epoch("libcuda.so.1") is None
    assert lb.build_epoch("no version here") is None
    assert lb.build_epoch(None) is None


def test_missing_and_unstamped_libraries_have_no_version(tmp_path):
    assert lb.extract_build(str(tmp_path / "missing")) is None
    plain = tmp_path / "libcuda.so.1"
    shutil.copy(_libc(), plain)
    assert lb.extract_build(str(plain)) is None


def test_stamp_found_across_chunk_boundary(tmp_path, monkeypatch):
    monkeypatch.setattr(lb, "_CHUNK", 64)
    p = tmp_path / "big.bin"
    p.write_bytes(b"x" * 60 + b"\0" + NEW.encode() + b"\0" + b"y" * 60)
    assert lb.extract_build(str(p)) == NEW


def test_kernel_module_line_from_an_injectable_root(tmp_path):
    root = _root(tmp_path, module=OLD)
    line = lb.kernel_module_version(str(root))
    assert line.startswith("NVRM version:") and OLD in line
    assert "GCC" not in line
    assert lb.kernel_module_version(str(tmp_path / "nowhere")) is None


def test_runtime_build_record_roundtrip_matches_the_reference(tmp_path):
    """Record, read and consume behave as the reference's on the same
    directory layout."""
    for mod, name in ((lb, "port"), (ref_lb, "ref")):
        d = tmp_path / name
        d.mkdir()
        assert mod.read_runtime_build(str(d)) is None
        assert mod.record_runtime_build(str(d), NVRM.format(OLD)) is True
        assert mod.read_runtime_build(str(d)) == NVRM.format(OLD)
        mod.consume_runtime_build(str(d))
        assert mod.read_runtime_build(str(d)) is None
        mod.consume_runtime_build(str(d))      # idempotent
        assert mod.record_runtime_build(str(tmp_path / "absent"),
                                        "x") is False
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "ref")) == []


def test_driver_skew_fails_validation_and_consumes_record(tmp_path, vdir):
    root = _root(tmp_path, NEW)
    lb.record_runtime_build(vdir, NVRM.format(OLD))
    comp = _driver(tmp_path, root, vdir)
    with pytest.raises(ValidationFailed, match="driver version skew"):
        comp.run()
    assert not os.path.exists(comp.status_path())
    assert lb.read_runtime_build(vdir) is None     # consumed
    # the retry (the --wait loop): record gone → the gate passes, and the
    # live check falls to workload validation
    assert comp.run()["skew"] is False


def test_stale_record_cannot_wedge_recovery(tmp_path, vdir):
    """Staged NEW library, module ALREADY reloaded onto NEW, record still
    OLD: the driver component fails once (consuming the stale record), then
    passes; workload validation re-records the truth; every later pass stays
    green."""
    root = _root(tmp_path, NEW, module=NEW)
    lb.record_runtime_build(vdir, NVRM.format(OLD))
    comp = _driver(tmp_path, root, vdir)
    with pytest.raises(ValidationFailed, match="version skew"):
        comp.run()
    assert comp.run()["skew"] is False
    wl = WorkloadComponent(device="cpu", driver_root=str(root),
                           validations_dir=vdir)
    wl._record_runtime_build()
    assert lb.build_epoch(lb.read_runtime_build(vdir)) == 560035003
    info = comp.run()
    assert info["skew"] is False
    assert info["runtime_build_epoch"] == info["client_build_epoch"]


def test_no_skew_when_versions_match(tmp_path, vdir):
    root = _root(tmp_path, OLD, named=True)
    lb.record_runtime_build(vdir, NVRM.format(OLD))
    info = _driver(tmp_path, root, vdir).run()
    assert info["skew"] is False and info["build"] == OLD
    assert info["client_build_epoch"] == info["runtime_build_epoch"] \
        == 550054015


def test_unknown_runtime_build_passes(tmp_path, vdir):
    info = _driver(tmp_path, _root(tmp_path, NEW), vdir).run()
    assert info["skew"] is False
    assert info["runtime_build_epoch"] is None
    assert info["client_build_epoch"] == 560035003


def test_workload_records_runtime_build_and_detects_skew(tmp_path, vdir):
    """After the probes, the workload component records the loaded module's
    version for the other consumers and fails on skew against the staged
    library; the record stays, for the metrics agent's gauge."""
    root = _root(tmp_path, NEW, module=OLD)
    wl = WorkloadComponent(device="cpu", driver_root=str(root),
                           validations_dir=vdir)
    with pytest.raises(ValidationFailed, match="driver version skew"):
        wl._record_runtime_build()
    assert lb.build_epoch(lb.read_runtime_build(vdir)) == 550054015
    _root(tmp_path, module=NEW)          # the module reloaded onto NEW
    wl._record_runtime_build()
    assert lb.build_epoch(lb.read_runtime_build(vdir)) == 560035003


def test_workload_without_a_kernel_module_records_nothing(tmp_path, vdir):
    root = _root(tmp_path, NEW)
    WorkloadComponent(device="cpu", driver_root=str(root),
                      validations_dir=vdir)._record_runtime_build()
    assert lb.read_runtime_build(vdir) is None


def test_revalidation_skew_gauge_persists_until_recovery(tmp_path, vdir,
                                                         monkeypatch):
    """The metrics agent is an OBSERVER: the skew gauge reads 1 poll after
    poll while the record survives, and 0 once workload validation
    re-records the reloaded module."""
    root = _root(tmp_path, NEW)
    monkeypatch.setenv("NVIDIA_DRIVER_ROOT", str(root))
    monkeypatch.setenv("GPU_DEVICE_GLOB", str(tmp_path / "dev/nvidia[0-9]*"))
    lb.record_runtime_build(vdir, NVRM.format(OLD))
    nm = NodeMetrics(vdir, port=0)
    for _ in range(3):
        nm.revalidate()
        assert nm.revalidation.get() == 0
        assert nm.driver_skew.get() == 1
        assert lb.read_runtime_build(vdir) is not None
    lb.record_runtime_build(vdir, NVRM.format(NEW))
    nm.revalidate()
    assert nm.revalidation.get() == 1
    assert nm.driver_skew.get() == 0
    assert nm.device_count.get() == 1
    assert "gpu_operator_node_driver_skew 0" in nm.registry.render()


def test_revalidation_failure_retracts_status_file(tmp_path, vdir,
                                                   monkeypatch):
    """A missing library fails the revalidation, retracts the driver's green
    status file, and leaves the skew gauge undeterminable (-1)."""
    monkeypatch.setenv("NVIDIA_DRIVER_ROOT", str(tmp_path / "empty"))
    open(os.path.join(vdir, "driver-ready"), "w").write("{}")
    nm = NodeMetrics(vdir, port=0)
    nm.revalidate()
    assert nm.revalidation.get() == 0
    assert nm.driver_skew.get() == -1
    assert not os.path.exists(os.path.join(vdir, "driver-ready"))
