"""``gpu-smoke`` (the port's vectorAdd probe) against the reference's
``tpu-smoke``, and ``--run-add`` through the driver API on the fake
``libcuda`` (``native/fake_cuda``).

Each parity test runs both binaries on their own side of the same fixture
node and compares what they print after ``torch_native.NAME_MAP``. The
reference's ``--add-n`` is the port's ``--n``, ``--libtpu`` is
``--libcuda``, and ``pjrt_api_version`` (the PJRT C API's) is
``cuda_driver_version`` (``cuDriverGetVersion``'s, "major.minor"). The
reference's ``--sopt``/``--iopt`` (``PJRT_Client_Create`` options) have
no counterpart: ``cuInit`` takes no options, so the port refuses them as
unknown flags.
"""

import json

import pytest

from torch_native import (SIDES, binary, port_bins, ref_bins,  # noqa: F401
                          run, side_tree, to_port)

PJRT_MAP = (("pjrt_api_version", "cuda_driver_version"),)


def smoke(bins, side, *args, env=None):
    return run(bins, binary(side, "smoke"), *args, env=env)


def lib_flag(side):
    return "--libtpu" if side == "r" else "--libcuda"


def glob_of(root, side):
    return str(root / ("accel*" if side == "r" else "nvidia[0-9]*"))


def both(ref_bins, port_bins, args_of, env=None):
    """Run the smoke binary of each side with ``args_of(side)``; returns
    the reference's (rc, stdout mapped to the port's names) and the
    port's (rc, stdout)."""
    r = smoke(ref_bins, "r", *args_of("r"), env=env)
    p = smoke(port_bins, "p", *args_of("p"), env=env)
    return (r.returncode, to_port(r.stdout)), (p.returncode, p.stdout)


# -- without --run-add: nodes and library, as the startup probe ---------------

def test_smoke_fails_without_gpu(ref_bins, port_bins, tmp_path):
    for side in SIDES:
        (tmp_path / side).mkdir()
    ref, port = both(ref_bins, port_bins, lambda s: [
        "--device-glob", glob_of(tmp_path / s, s),
        lib_flag(s), tmp_path / s / "none.so"])
    assert port[0] == 1 and json.loads(port[1])["devices"] == []
    assert ref == port


def test_smoke_green_on_fake_node(ref_bins, port_bins, tmp_path):
    roots = {s: side_tree(tmp_path, s) for s in SIDES}
    ref, port = both(ref_bins, port_bins, lambda s: [
        "--device-glob", glob_of(roots[s], s),
        lib_flag(s), roots[s] / "img" / SIDES[s][1]])
    out = json.loads(port[1])
    assert port[0] == 0 and out["ok"] and len(out["devices"]) == 2
    assert out["loadable"] and not out["driver_api"]   # libc: no cuInit
    assert ref == port


def test_smoke_quiet_mode(ref_bins, port_bins, tmp_path):
    roots = {s: side_tree(tmp_path, s) for s in SIDES}
    ref, port = both(ref_bins, port_bins, lambda s: [
        "--quiet", "--device-glob", glob_of(roots[s], s),
        lib_flag(s), roots[s] / "img" / SIDES[s][1]])
    assert port == ref == (0, "")


@pytest.mark.parametrize("flag", ["--wat", "--libtpu", "--add-n"])
def test_smoke_rejects_unknown_flag(ref_bins, port_bins, flag):
    """The reference's own names are unknown to the port."""
    assert smoke(port_bins, "p", flag, "x").returncode == 2
    assert smoke(ref_bins, "r", "--wat").returncode == 2


def test_smoke_explicit_libcuda_no_fallback(ref_bins, port_bins, tmp_path):
    """A named library that is missing fails, though the loader could find
    another: no search around a path the caller named."""
    roots = {s: side_tree(tmp_path, s) for s in SIDES}
    ref, port = both(ref_bins, port_bins, lambda s: [
        "--device-glob", glob_of(roots[s], s),
        lib_flag(s), roots[s] / "missing.so"])
    assert port[0] == 1 and json.loads(port[1])["loadable"] is False
    assert ref == port
    p = smoke(port_bins, "p", "--run-add", "--libcuda",
              roots["p"] / "missing.so")
    assert p.returncode == 1 and json.loads(p.stdout)["error"] == "dlopen"


def test_smoke_probe_reports_the_driver_api(port_bins, tmp_path):
    root = side_tree(tmp_path, "p", payload=str(port_bins /
                                                "libfake-cuda.so"))
    p = smoke(port_bins, "p", "--device-glob", glob_of(root, "p"),
              "--libcuda", root / "img" / "libcuda.so.1")
    assert p.returncode == 0 and json.loads(p.stdout)["driver_api"] is True


def test_smoke_finds_libcuda_under_the_driver_root(port_bins, tmp_path):
    root = side_tree(tmp_path, "p", payload=str(port_bins /
                                                "libfake-cuda.so"))
    lib = root / "usr" / "lib64"
    lib.mkdir(parents=True)
    (lib / "libcuda.so.1").symlink_to(root / "img" / "libcuda.so.1")
    p = smoke(port_bins, "p", "--device-glob", glob_of(root, "p"),
              env={"NVIDIA_DRIVER_ROOT": str(root)})
    out = json.loads(p.stdout)
    assert p.returncode == 0 and out["libcuda"] == str(lib / "libcuda.so.1")


# -- --run-add: the vectorAdd through the driver API ------------------------

def add(port_bins, *args, env=None):
    p = smoke(port_bins, "p", "--run-add", "--libcuda",
              port_bins / "libfake-cuda.so", *args, env=env)
    return p, json.loads(p.stdout)


def test_smoke_run_add_against_fake_libcuda(ref_bins, port_bins):
    p, out = add(port_bins)
    assert p.returncode == 0, p.stdout
    assert out["ok"] and out["devices"] == 1 and out["n"] == 1024
    assert out["cuda_driver_version"] == "12.8" and out["cc"] == "9.0"
    # the JIT took the function the PTX names
    assert "Compiling entry function 'vector_add'" in out["jit_log"]
    assert "leaked" not in p.stderr
    # the reference's line, under the port's names, has the same keys and
    # the same answers to them
    r = smoke(ref_bins, "r", "--run-add", "--libtpu",
              ref_bins / "libfake-pjrt.so")
    ref = json.loads(to_port(r.stdout))
    for a, b in PJRT_MAP:
        ref[b] = ref.pop(a)
    assert set(ref) <= set(out)
    assert {k: out[k] for k in ("ok", "n", "devices")} == \
        {k: ref[k] for k in ("ok", "n", "devices")}
    assert out["cuda_driver_version"].count(".") == \
        ref["cuda_driver_version"].count(".") == 1


@pytest.mark.parametrize("n", [1, 7, 257, 1 << 20])
def test_smoke_run_add_custom_n(ref_bins, port_bins, n):
    p, out = add(port_bins, "--n", n)
    assert p.returncode == 0 and out["ok"] and out["n"] == n, p.stdout
    r = smoke(ref_bins, "r", "--run-add", "--add-n", n, "--libtpu",
              ref_bins / "libfake-pjrt.so")
    assert json.loads(r.stdout)["n"] == out["n"]


def test_smoke_run_add_rejects_library_without_cuinit(ref_bins, port_bins,
                                                       tmp_path):
    """A loadable library that is not a CUDA driver (libc) fails cleanly,
    as the reference's does for a library without ``GetPjrtApi``."""
    roots = {s: side_tree(tmp_path, s) for s in SIDES}
    p = smoke(port_bins, "p", "--run-add", "--libcuda",
              roots["p"] / "img" / "libcuda.so.1")
    out = json.loads(p.stdout)
    assert p.returncode == 1 and not out["ok"]
    assert out["error"] == "dlsym(cuInit)"
    r = smoke(ref_bins, "r", "--run-add", "--libtpu",
              roots["r"] / "img" / "libtpu.so")
    assert r.returncode == 1 and "GetPjrtApi" in json.loads(r.stdout)["error"]


@pytest.mark.parametrize("bad", ["-1", "0", "junk", str((1 << 24) + 1)])
def test_smoke_run_add_rejects_bad_n(ref_bins, port_bins, bad):
    p = smoke(port_bins, "p", "--run-add", "--n", bad, "--libcuda",
              port_bins / "libfake-cuda.so")
    r = smoke(ref_bins, "r", "--run-add", "--add-n", bad, "--libtpu",
              ref_bins / "libfake-pjrt.so")
    assert p.returncode == r.returncode == 2, (bad, p.stderr, r.stderr)


@pytest.mark.parametrize("args", [
    ["--run-add", "--sopt", "topology=v5e:1x1x1"],
    ["--run-add", "--iopt", "rank=4"],
    ["--sopt", "a=b"],
])
def test_smoke_refuses_create_option_flags(port_bins, args):
    """``PJRT_Client_Create``'s named options have no driver-API
    counterpart: the flags are unknown to the port."""
    p = smoke(port_bins, "p", *args, "--libcuda",
              port_bins / "libfake-cuda.so")
    assert p.returncode == 2 and "unknown flag" in p.stderr


STEPS = ["cuInit", "cuDriverGetVersion", "cuDeviceGetCount", "cuDeviceGet",
         "cuDeviceGetName", "cuDeviceGetAttribute",
         "cuDevicePrimaryCtxRetain", "cuCtxSetCurrent", "cuModuleLoadDataEx",
         "cuModuleGetFunction", "cuMemAlloc_v2", "cuMemcpyHtoD_v2",
         "cuLaunchKernel", "cuCtxSynchronize", "cuMemcpyDtoH_v2"]


@pytest.mark.parametrize("step", STEPS)
def test_smoke_run_add_fails_on_each_planted_driver_error(port_bins, step):
    """Every driver-API step is checked: a planted error code fails the run
    with that step named and the driver's name for the code, and what was
    acquired before it is released."""
    p, out = add(port_bins, env={"FAKE_CUDA_FAIL": f"{step}=700"})
    assert p.returncode == 1 and out["ok"] is False
    assert out["error"] == step
    assert "CUDA_ERROR_ILLEGAL_ADDRESS" in out["detail"]
    assert "leaked" not in p.stderr


def test_smoke_run_add_passes_the_jit_error_log(port_bins):
    p, out = add(port_bins, env={"FAKE_CUDA_FAIL": "cuModuleLoadDataEx=218"})
    assert p.returncode == 1 and out["error"] == "cuModuleLoadDataEx"
    assert "CUDA_ERROR_INVALID_PTX" in out["detail"]
    assert "planted failure" in out["detail"]      # the JIT's error log


def test_smoke_run_add_checks_every_element_exactly(port_bins):
    p, out = add(port_bins, "--n", 4096, env={"FAKE_CUDA_CORRUPT": "4095"})
    assert p.returncode == 1 and out["error"] == "verify"
    assert out["detail"] == "out[4095] = 12287, want 12286"


def test_smoke_run_add_needs_a_device(port_bins):
    p, out = add(port_bins, env={"FAKE_CUDA_DEVICES": "0"})
    assert p.returncode == 1 and out["error"] == "cuDeviceGetCount"
    assert out["devices"] == 0


def test_smoke_ptx_is_written_for_a_low_target():
    """The PTX names sm_52 so that the driver JITs it forward to the card
    it finds (sm_90 on the H100); the card run proves the JIT."""
    from tpu_operator_torch.native.build import NATIVE_DIR
    src = (NATIVE_DIR / "gpu_smoke" / "cuda_add.cc").read_text()
    assert ".version 6.4" in src and ".target sm_52" in src
    assert ".address_size 64" in src and ".entry vector_add(" in src
    # the versioned symbols, never the legacy 32-bit ones
    for sym in ("cuMemAlloc", "cuMemcpyHtoD", "cuMemcpyDtoH", "cuMemFree"):
        assert f"{sym}_v2" in src
        assert f"GPUOP_BIND({sym})" not in src


def test_smoke_finds_libcuda_in_the_install_dir(port_bins, tmp_path):
    """The startup probe runs in the driver installer's container, whose
    ``DRIVER_INSTALL_DIR`` names the directory it staged into: the probe
    checks that library and falls back to no other."""
    root = side_tree(tmp_path, "p", payload=str(port_bins /
                                                "libfake-cuda.so"))
    p = smoke(port_bins, "p", "--device-glob", glob_of(root, "p"),
              env={"DRIVER_INSTALL_DIR": str(root / "img")})
    out = json.loads(p.stdout)
    assert p.returncode == 0 and out["libcuda"] == str(root / "img" /
                                                       "libcuda.so.1")
    p = smoke(port_bins, "p", "--device-glob", glob_of(root, "p"),
              env={"DRIVER_INSTALL_DIR": str(root / "host"),
                   "NVIDIA_DRIVER_ROOT": "/"})
    assert p.returncode == 1
