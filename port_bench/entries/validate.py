"""The validator's device workload: one ``WorkloadComponent.validate()`` a
unit, as a node runs it after a reboot or a driver upgrade.

``validate()`` makes its own inputs (an all-ones HBM array; the matmul
chain's and the flash check's operands from generators it seeds itself)
and keeps its outputs to itself, so the seed chooses nothing here and the
benchmark watches the three legs from outside: it wraps, for the length of
the session, the module attributes the legs call through
(``ops.hbm.read_sum``, ``ops.matmul.matmul_tflops`` and
``ops.matmul.measure_best``, ``ops.flash_attention.flash_attention``), and
records what each returns without changing what it computes. It also
wraps the three legs in its own spans (``leg.matmul``, ``leg.hbm``,
``leg.flash``), which the trace's readers use.

The reference draws the inputs again from the configuration's recipe and
judges every recorded answer of the window: each K1 checksum exactly, each
matmul chain's sum against a float32 chain, each flash output against
float32 attention; and the work done against the configuration's, so
that a probe that shrinks its work fails.
"""

from __future__ import annotations

import functools
import gc
import inspect
import math
import shutil
import sys
import tempfile

import torch

from port_bench import work
from port_bench.reference import attention as ref_attention
from port_bench.reference import hbm_sum, matmul_chain


class Session:
    def __init__(self, config, traffic, seed, devices, spans):
        from tpu_operator_torch.validator.components import (ValidationFailed,
                                                             WorkloadComponent)
        self.config = config
        self.spans = spans
        self.device = devices[0]
        self.cuda = self.device.type == "cuda"
        self._failure = ValidationFailed
        self._dir = tempfile.mkdtemp(prefix="port_bench_validations_")
        self.component = WorkloadComponent(
            validations_dir=self._dir, require_gpu=self.cuda,
            device=str(self.device), ranks=config["ranks"],
            matmul_dim=config["matmul"]["dim"],
            min_efficiency=config["min_efficiency"])
        self._patches = []
        self._shape = None
        self._reset()
        self._install()

    def _reset(self):
        self.hbm = []        # (elements, sweeps, 0-d checksum)
        self.chains = []     # ((m, k, n, depth), the chain's sum)
        self.flash = []      # the flash check's outputs
        self.validations = 0

    def _patch(self, owner, name, make):
        original = getattr(owner, name)
        setattr(owner, name, make(original))
        self._patches.append((owner, name, original))

    def _install(self):
        from tpu_operator_torch.ops import flash_attention as flash_mod
        from tpu_operator_torch.ops import hbm, matmul

        def read_sum(original):
            @functools.wraps(original)
            def wrapper(x, sweeps=1):
                out = original(x, sweeps)
                self.hbm.append((x.numel(), sweeps, out))
                return out
            return wrapper

        def matmul_tflops(original):
            sig = inspect.signature(original)

            @functools.wraps(original)
            def wrapper(*args, **kw):
                a = sig.bind(*args, **kw)
                a.apply_defaults()
                a = a.arguments
                self._shape = (a["m"], a["k"], a["n"], a["depth"])
                return original(*args, **kw)
            return wrapper

        def measure_best(original):
            @functools.wraps(original)
            def wrapper(fn, *args, **kw):
                shape = self._shape

                def recorded(*a):
                    value = fn(*a)
                    self.chains.append((shape, value))
                    return value
                return original(recorded, *args, **kw)
            return wrapper

        def flash_attention(original):
            @functools.wraps(original)
            def wrapper(q, k, v, *args, **kw):
                out = original(q, k, v, *args, **kw)
                self.flash.append(out)
                return out
            return wrapper

        def leg(name):
            def make(original):
                @functools.wraps(original)
                def wrapper(*args, **kw):
                    with self.spans.span(name):
                        return original(*args, **kw)
                return wrapper
            return make

        self._patch(hbm, "read_sum", read_sum)
        self._patch(matmul, "matmul_tflops", matmul_tflops)
        self._patch(matmul, "measure_best", measure_best)
        self._patch(flash_mod, "flash_attention", flash_attention)
        self._patch(matmul, "matmul_device_tflops", leg("leg.matmul"))
        self._patch(hbm, "hbm_device_gbps", leg("leg.hbm"))
        self._patch(self.component, "_check_flash", leg("leg.flash"))

    def close(self):
        for owner, name, original in reversed(self._patches):
            if owner is self.component:
                delattr(owner, name)
            else:
                setattr(owner, name, original)
        self._patches.clear()
        shutil.rmtree(self._dir, ignore_errors=True)

    def warm(self):
        self.step()
        self._reset()

    def step(self) -> bool:
        self.validations += 1
        try:
            with self.spans.span("validation"):
                info = self.component.validate()
        except self._failure as e:
            print(f"validation failed: {e}", file=sys.stderr)
            return False
        for leg, seconds in info["leg_seconds"].items():
            self.spans.add(f"program.leg.{leg}", seconds)
        return True

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def compare(self, control: bool = False) -> dict:
        return {**self._compare_hbm(control),
                **self._compare_matmul(control),
                **self._compare_flash(control)}

    def _compare_hbm(self, control):
        h = self.config["hbm"]
        rows = hbm_sum.rows(h["size_mb"], h["lanes"], h["chunk_rows"])
        numel = rows * h["lanes"]
        sums = (torch.stack([s for *_, s in self.hbm]).double().cpu().tolist()
                if self.hbm else [])
        errs, done = [], 0
        for (n, sweeps, _), got in zip(self.hbm, sums):
            if n != numel:
                errs.append(math.inf)
                continue
            done += sweeps
            exact = hbm_sum.exact_sum(numel, sweeps)
            if control:
                got = hbm_sum.bf16_sum(h["lanes"], rows * sweeps)
            errs.append(abs(got - exact) / exact)
        need = sum(work.hbm_launches(h)) * self.validations
        return {"hbm_checksum_err": max(errs, default=math.inf),
                "hbm_work_missing": max(0.0, 1.0 - done / need)}

    def _compare_matmul(self, control):
        mm = self.config["matmul"]
        dim = mm["dim"]
        a, b = matmul_chain.inputs(dim, mm["seed"], self.device)
        depths = {mm["depth_hi"], mm["depth_lo"]}
        ref = matmul_chain.chain(a, b, depths, mm["scale"])
        low = (matmul_chain.chain_fp8(a, b, depths, mm["scale"])
               if control else None)
        errs, done = [], 0
        for (m, k, n, depth), value in self.chains:
            if (m, k, n) != (dim, dim, dim) or depth not in ref:
                errs.append(math.inf)
                continue
            done += depth
            got = low[depth][0] if control else value
            total, norm = ref[depth]
            errs.append(abs(got - total) / norm)
        need = sum(work.matmul_chains(mm)) * self.validations
        return {"matmul_chain_err": max(errs, default=math.inf),
                "matmul_work_missing": max(0.0, 1.0 - done / need)}

    def _compare_flash(self, control):
        f = self.config["flash"]
        gen = torch.Generator(device=self.device).manual_seed(f["seed"])
        q, k, v = (torch.randn((f["t"], f["d"]), generator=gen,
                               device=self.device).to(torch.bfloat16)
                   for _ in range(3))
        ref = ref_attention.attention(q, k, v, f["causal"])
        outs = self.flash
        if control:
            outs = [ref_attention.attention_fp8(q, k, v, f["causal"])] \
                * len(outs)
        errs = [ref_attention.max_abs_err(out, ref) for out in outs]
        if len(outs) < self.validations:
            errs.append(math.inf)      # a validation with no flash check
        return {"flash_err": max(errs, default=math.inf)}
