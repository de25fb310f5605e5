"""The port's validator workload component on an explicit CPU, and its
gates."""

import json

import pytest
import torch

from tpu_operator.validator.components import Component as JaxComponent
from tpu_operator_torch.ops import flash_attention as flash_mod
from tpu_operator_torch.ops import hbm as hbm_mod
from tpu_operator_torch.validator import components as comp
from tpu_operator_torch.validator.components import (ValidationFailed,
                                                     WorkloadComponent)

H100 = "NVIDIA H100 80GB HBM3"


def _workload(tmp_path, **kw):
    return WorkloadComponent(device="cpu", matmul_dim=256,
                             validations_dir=str(tmp_path), **kw)


def test_workload_on_cpu_writes_its_status_file(tmp_path, monkeypatch):
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    wl = _workload(tmp_path)
    info = wl.run()
    with open(wl.status_path()) as f:
        status = json.load(f)
    assert status["ok"] is True and status["component"] == "workload"
    assert status["info"] == json.loads(json.dumps(info))
    assert info["platform"] == "cpu" and info["hbm_backend"] == "torch"
    assert info["matmul_tflops"] > 0 and info["hbm_read_gbps"] > 0
    # no efficiency gate off the card
    assert info["efficiency"] is None and info["peak_matched"] is False
    flash = info["flash_attention"]
    assert flash["ok"] is True and flash["seq_len"] == 256
    assert flash["max_abs_err"] <= flash["tolerance"]
    # the CPU path ran the plain versions: no kernel launched
    assert hbm_mod.read_sum.launches == flash_mod.flash_attention.launches \
        == 0


def test_multi_rank_workload_adds_the_collectives_and_ring_attention(
        tmp_path, monkeypatch):
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    wl = _workload(tmp_path, ranks=4, collective_mb=1)
    info = wl.run()
    with open(wl.status_path()) as f:
        status = json.load(f)
    assert status["info"] == json.loads(json.dumps(info))
    # the five library collectives; the hand rings join only on the card
    assert list(info["collectives"]) == [
        "allreduce", "all_gather", "reduce_scatter", "all_to_all",
        "ppermute_ring"]
    assert all(0 < bw < float("inf") for bw in info["collectives"].values())
    ring_check = info["ring_attention"]
    assert ring_check["ok"] is True and ring_check["seq_len"] == 4 * 128
    assert ring_check["max_abs_err"] <= ring_check["tolerance"]
    assert list(info["leg_seconds"]) == ["matmul", "hbm", "flash",
                                         "collectives", "ring_attention"]
    # every rank lies on the one device: the figures are loopback, and
    # the status says so
    assert info["fabric"] == "loopback" and info["ranks_device"] == "cpu"


def test_single_rank_workload_has_no_multi_device_leg(tmp_path, monkeypatch):
    monkeypatch.delenv("REQUIRE_GPU_PLATFORM", raising=False)
    multi = _workload(tmp_path / "multi", ranks=2, collective_mb=1).validate()
    for wl in (_workload(tmp_path), _workload(tmp_path, ranks=1)):
        info = wl.validate()
        assert "collectives" not in info and "ring_attention" not in info
        assert "fabric" not in info and "ranks_device" not in info
        assert list(info["leg_seconds"]) == ["matmul", "hbm", "flash"]
        # the multi-rank status only adds keys to the single-rank one
        assert set(multi) - set(info) == {"collectives", "ring_attention",
                                          "fabric", "ranks_device"}


def test_collective_payload_comes_from_the_argument_or_the_environment(
        monkeypatch):
    monkeypatch.delenv("WORKLOAD_COLLECTIVE_MB", raising=False)
    assert WorkloadComponent().collective_mb == 64
    monkeypatch.setenv("WORKLOAD_COLLECTIVE_MB", "8")
    assert WorkloadComponent().collective_mb == 8
    assert WorkloadComponent(collective_mb=2).collective_mb == 2


def test_ring_attention_divergence_fails_validation(tmp_path, monkeypatch):
    """A ring that drops one hop's K/V block (the last rank, whose causal
    queries see every block, receives zeros, as from a link that delivered
    nothing) must not validate."""
    from tpu_operator_torch.parallel import ring_attention as ra
    real, calls = ra.ppermute, []

    def lossy(xs, mesh, axis, perm):
        calls.append(1)
        out = real(xs, mesh, axis, perm)
        if len(calls) in (3, 4):     # the second hop's K, then its V
            out[-1] = torch.zeros_like(out[-1])
        return out
    monkeypatch.setattr(ra, "ppermute", lossy)
    with pytest.raises(ValidationFailed, match="ring attention over the "
                                               "slice fabric diverged"):
        _workload(tmp_path, ranks=4, collective_mb=1).validate()
    assert len(calls) == 2 * 3


def test_status_file_schema_matches_reference(tmp_path):
    port = comp.Component(validations_dir=str(tmp_path / "port"))
    ref = JaxComponent(validations_dir=str(tmp_path / "ref"))
    for c in (port, ref):
        c.write_status({"x": 1})
    with open(port.status_path()) as f:
        port_status = json.load(f)
    with open(ref.status_path()) as f:
        ref_status = json.load(f)
    assert set(port_status) == set(ref_status)
    assert port.status_path().endswith("component-ready")


@pytest.mark.parametrize("tflops,kind,env,raises,matched", [
    (700.0, H100, None, False, True),            # healthy SXM card
    (300.0, H100, None, True, True),             # 30% of a matched peak
    (300.0, "NVIDIA H100 PCIe", None, True, True),
    (300.0, "NVIDIA A100-SXM4-80GB", None, False, False),  # audit flag only
    (300.0, "NVIDIA A100-SXM4-80GB", "312", False, True),
    (100.0, "NVIDIA A100-SXM4-80GB", "312", True, True),   # env arms it
])
def test_efficiency_gate(monkeypatch, tflops, kind, env, raises, matched):
    if env is None:
        monkeypatch.delenv("PEAK_TFLOPS", raising=False)
    else:
        monkeypatch.setenv("PEAK_TFLOPS", env)
    if raises:
        with pytest.raises(ValidationFailed, match="of peak"):
            comp._efficiency_gate(tflops, kind, 0.5)
        return
    peak, eff, got_matched = comp._efficiency_gate(tflops, kind, 0.5)
    assert got_matched == matched and eff == tflops / peak


def test_probe_error_fails_validation(tmp_path, monkeypatch):
    def corrupt(**kw):
        raise hbm_mod.ProbeError("hbm probe checksum 1 != 2: bad reads?")
    monkeypatch.setattr(hbm_mod, "hbm_device_gbps", corrupt)
    with pytest.raises(ValidationFailed, match="checksum"):
        _workload(tmp_path).validate()


def test_flash_divergence_fails_validation(tmp_path, monkeypatch):
    monkeypatch.setattr(flash_mod, "flash_attention",
                        lambda q, k, v, causal: torch.zeros_like(q))
    with pytest.raises(ValidationFailed, match="diverged"):
        _workload(tmp_path).validate()


def test_required_gpu_refuses_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("REQUIRE_GPU_PLATFORM", "true")
    wl = _workload(tmp_path)
    assert wl.require_gpu is True
    with pytest.raises(ValidationFailed, match="GPU-present"):
        wl.validate()


def test_run_retries_then_clears_status(tmp_path, monkeypatch):
    wl = _workload(tmp_path, max_tries=2, retry_interval=0)
    wl.write_status({"stale": True})
    calls = []

    def failing():
        calls.append(1)
        raise ValidationFailed("not yet")
    monkeypatch.setattr(wl, "validate", failing)
    with pytest.raises(ValidationFailed, match="workload: not yet"):
        wl.run()
    assert len(calls) == 2 and not wl.status_exists("workload")


def test_defaults_to_the_card(monkeypatch):
    monkeypatch.delenv("WORKLOAD_MATMUL_DIM", raising=False)
    wl = WorkloadComponent()
    assert wl.device == "cuda" and wl.matmul_dim == 4096
    assert wl.min_efficiency == 0.5
