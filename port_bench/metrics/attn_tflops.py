"""Attention work through ``flash_attention``: the FLOPs the window's calls
need (counted from the shape, 2·D·T(T+1) a causal call), over the window,
in TFLOP/s."""

from port_bench import work


def read(run):
    c = run.config
    flops = work.attention_flops(c["t"], c["d"], c["causal"],
                                 c.get("heads") or 1)
    return run.steps * flops / run.window_s / 1e12 if run.steps else None
