"""The check that decides ``correct`` on the CPU at small sizes: sound runs
pass; the control (the reference in a lower precision in the program's
place) and each fault a cell can have, planted in the timed path, fail."""

import pytest
import torch

CELLS = ["validate.default", "attn.causal-16k"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cpu_run, cell):
    line = cpu_run(cell, control=True)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def _broken_op(session, how):
    op = session.op

    def broken(q, k, v, **kw):
        out = op(q, k, v, **kw).clone()
        if how == "altered":        # one answer altered where produced
            out[-1, 0] += 1
        elif how == "half":         # half of the rows left out
            out[out.shape[0] // 2:] = 0
        elif how == "unchanged":    # the state handed back as it came
            out = q
        return out
    session.op = broken


@pytest.mark.parametrize("how", ["altered", "half", "unchanged"])
def test_attention_faults_are_not_correct(cpu_run, how):
    line = cpu_run("attn.causal-16k",
                   fault=lambda s: _broken_op(s, how))
    assert line["correct"] is False
    assert line["checks"]["attn_err"]["value"] > \
        line["checks"]["attn_err"]["limit"]


def test_validate_altered_checksum_is_not_correct(cpu_run, monkeypatch):
    from tpu_operator_torch.ops import hbm
    plain = hbm.read_sum_plain
    # the timed launches' sums off by one; the probe checks only its first
    calls = []

    def off(x, sweeps=1):
        calls.append(1)
        return plain(x, sweeps) + (len(calls) % 2 == 0)
    monkeypatch.setattr(hbm, "read_sum_plain", off)
    line = cpu_run("validate.default")
    assert line["correct"] is False
    assert line["checks"]["hbm_checksum_err"]["value"] > 0


def test_validate_half_the_sweeps_is_not_correct(cpu_run, monkeypatch):
    from tpu_operator_torch.ops import hbm
    measure = hbm._measure
    monkeypatch.setattr(hbm, "_measure",
                        lambda x, sweeps, iters: measure(x, sweeps // 2,
                                                         iters))
    line = cpu_run("validate.default")
    assert line["correct"] is False
    assert line["checks"]["hbm_work_missing"]["value"] == 0.5


def test_validate_altered_product_is_not_correct(cpu_run, monkeypatch):
    from tpu_operator_torch.ops import matmul

    class Torch:
        def __getattr__(self, name):
            return getattr(torch, name)

        @staticmethod
        def matmul(a, b):
            y = torch.matmul(a, b)
            y.view(-1)[0] += 100 * y.abs().max()
            return y
    monkeypatch.setattr(matmul, "torch", Torch())
    line = cpu_run("validate.default")
    assert line["correct"] is False
    assert line["checks"]["matmul_chain_err"]["value"] > \
        line["checks"]["matmul_chain_err"]["limit"]


def test_validate_shallow_chains_are_not_correct(cpu_run, monkeypatch):
    from tpu_operator_torch.ops import matmul
    device_tflops = matmul.matmul_device_tflops

    def half(*args, **kw):
        kw["depth_hi"] //= 2
        kw["depth_lo"] //= 2
        return device_tflops(*args, **kw)
    monkeypatch.setattr(matmul, "matmul_device_tflops", half)
    line = cpu_run("validate.default")
    assert line["correct"] is False
    assert line["checks"]["matmul_work_missing"]["value"] > 0


def test_validate_altered_flash_output_is_not_correct(cpu_run, monkeypatch):
    from tpu_operator_torch.ops import flash_attention as flash_mod
    plain = flash_mod.attention_plain

    def off(*args, **kw):
        out = plain(*args, **kw).clone()
        out[-1, 0] += 1
        return out
    monkeypatch.setattr(flash_mod, "attention_plain", off)
    assert cpu_run("validate.default")["correct"] is False
