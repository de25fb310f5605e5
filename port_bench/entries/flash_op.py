"""The public attention op, one ``flash_attention`` call a unit.

Set-up makes a pool of q, k, v sets on the device from the seed, in one
call, in the type they are served in. The window calls
``flash_attention(q, k, v, causal=...)`` on them in turn; with the
``dispatch`` loop the calls queue back to back on one stream. A uniform
sample of the window's outputs, drawn from the seed, is checked against
float32 attention of the same inputs.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from port_bench.harness import Reservoir
from port_bench.reference import attention as ref_attention


def pool(config: dict, size: int, seed: int, device) -> torch.Tensor:
    """[size, 3, (heads,) T, D] inputs of the configuration's type."""
    gen = torch.Generator(device=device).manual_seed(seed)
    heads = [config["heads"]] if config.get("heads") else []
    return torch.randn((size, 3, *heads, config["t"], config["d"]),
                       generator=gen, device=device,
                       dtype=getattr(torch, config["dtype"]))


class Session:
    def __init__(self, config, traffic, seed, devices, spans):
        from tpu_operator_torch.ops.flash_attention import flash_attention
        self.config = config
        self.spans = spans
        self.device = devices[0]
        self.cuda = self.device.type == "cuda"
        self.op = flash_attention
        self.causal = config["causal"]
        self.inputs = pool(config, traffic["pool"], seed, self.device)
        self._k, self._seed = traffic["sample"], seed
        self._reset()

    def _reset(self):
        self.calls = 0
        self.sample = Reservoir(self._k, self._seed)

    def warm(self):
        for _ in range(len(self.inputs)):
            self.step()
        self._reset()

    def step(self) -> bool:
        j = self.calls % len(self.inputs)
        q, k, v = self.inputs[j]
        if self.spans.annotate:
            with self.spans.span("flash.call"):
                out = self.op(q, k, v, causal=self.causal)
        else:
            t0 = time.perf_counter()
            out = self.op(q, k, v, causal=self.causal)
            self.spans.add("flash.call", time.perf_counter() - t0)
        self.sample.offer((j, out))
        self.calls += 1
        return True

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def free(self):
        gc.collect()
        if self.cuda:
            torch.cuda.empty_cache()

    def compare(self, control: bool = False) -> dict:
        refs, lows, errs = {}, {}, []
        for j, out in self.sample.items:
            if j not in refs:
                q, k, v = self.inputs[j]
                refs[j] = ref_attention.attention(q, k, v, self.causal)
                if control:
                    lows[j] = ref_attention.attention_fp8(q, k, v,
                                                          self.causal)
            errs.append(ref_attention.max_abs_err(
                lows[j] if control else out, refs[j]))
        return {"attn_err": max(errs, default=math.inf)}

    def close(self):
        pass
