#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA Hopper card and
the CUDA toolkit (nvcc). The script builds the port's CUDA kernels from
``tpu_operator_torch/csrc``, holds each against its plain PyTorch version
on the card, runs the full-width burn-in forward pass (``entry()``), and
runs the node validator's CLI (``tpu_operator_torch.cli.validator``) as a
node would: the ``driver``, ``fabric`` and ``workload`` components against
the machine's own device nodes, driver library and kernel module, then the
gate on their status files; the workload's HBM and flash-attention legs
must go through the kernels. K2 (flash attention) is timed inside a CUDA
graph, so that the host's time per call is not in it, with a sweep of the
most kv tiles a unit of its work takes, and beside every SDPA backend
(flash, cuDNN, memory-efficient, math) on the 4-D form of the same inputs;
the fastest is its library time. K2g, the generic flash kernel, is held
against the plain version over f32, f16 and bf16, head dims 64, 96, 128
and 256, causal and full, and sequence lengths that 64 does not divide,
through its own wrapper and through ``flash_attention``'s routing, and
timed the same way. Then it holds the ring kernels (K3–K6) against their
plain versions and the library sums for 2, 4 and 8 virtual ranks on the
card, times them at 4 × 64 MiB (with the bytes their schedules move, a
library call that fills all n outputs, and a sweep of piece sizes) and at
4 × 64 KiB (the per-hop handshake), prints the collective bandwidth
suite's reports on 4 virtual ranks, and runs the multi-device dry run
``dryrun_multigpu(4)``, whose ring checks must go through those kernels.
Then ``WorkloadComponent(ranks=4)`` runs the validator's multi-device leg
on 4 virtual ranks, whose collective suite must launch K5 and K6 at its 64
MiB payload, and Ulysses attention runs with 8 heads over 4 virtual ranks,
causal and not, at Dh = 128 (T = 4096), where K2 must launch once per rank,
and at Dh = 256 (T = 1024), where K2g must; the result is held to K2's
per-element limit against the single-device computation.

Output: progress lines, then the ``nvidia-smi`` name and power limit, then
one JSON line with every kernel's launches on the main path, error, times
and bound, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed check raises, and the script exits non-zero without that line.
Without a CUDA card, or without the ``tpu_operator_torch`` package beside
it, it fails.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import torch


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn()`` on the card, by CUDA events around
    ``iters`` back-to-back calls after ``warmup`` untimed ones."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean milliseconds of ``fn()`` on the card alone: ``iters`` calls
    captured in one CUDA graph, replayed once untimed and once timed by
    CUDA events, so that the host's time per call (Python, argument checks,
    the launch itself) is not in it. ``fn`` runs once first, uncaptured,
    to set up what it caches."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


# float32 outside the tensor cores, H100 SXM data sheet (TFLOP/s)
F32_PEAK_TFLOPS = 67.0


def bound(flops: float, nbytes: float, kind: str,
          peak_tflops: float | None = None):
    """Least time in ms for the work on this card: the larger of the bytes
    over the data-sheet memory rate and the operations over the peak for
    their type (the bf16 tensor-core peak unless ``peak_tflops`` is
    given), and which of the two it is."""
    from tpu_operator_torch.ops.hbm import chip_peak_hbm_gbps
    from tpu_operator_torch.ops.matmul import chip_peak_tflops
    t_bytes = nbytes / (chip_peak_hbm_gbps(kind) * 1e9) * 1e3
    t_ops = flops / ((peak_tflops or chip_peak_tflops(kind)) * 1e12) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> tuple[str, str]:
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    print(f"[card] torch.cuda.get_device_name: {kind}; "
          f"count {torch.cuda.device_count()}; python {sys.version.split()[0]}"
          f"; torch {torch.__version__}; cuda {torch.version.cuda}")
    print(smi_line)
    return kind, smi_line


def phase_build() -> None:
    from tpu_operator_torch import _native
    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {len(_native.sources())} sources -> "
          f"{_native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")


def phase_hbm(dev, kind) -> dict:
    from tpu_operator_torch.ops import hbm
    from tpu_operator_torch.parallel.numerics import reduction_tolerance
    x, nbytes = hbm._alloc(256, dev)       # the main path's array: ones
    sweeps = 2048                          # hbm_device_gbps's sweeps_hi
    got = hbm.read_sum(x, sweeps).item()
    want = hbm.read_sum_plain(x, sweeps).item()
    check(got == want == x.numel() * sweeps,
          f"K1 on ones: kernel {got} plain {want} exact "
          f"{x.numel() * sweeps}")
    err = abs(got - want)
    print(f"[K1] ones, 256 MiB x {sweeps} sweeps: kernel {got:.0f} == plain "
          f"{want:.0f} (exact)")

    gen = torch.Generator(device=dev).manual_seed(0)
    xr = torch.rand(x.shape, generator=gen, device=dev)
    got_r = hbm.read_sum(xr, 3).item()
    want_r = torch.sum(xr, dtype=torch.float64).item() * 3
    # each thread adds its share of one sweep in f32, everything above it
    # is f64: the f32 level is the only inexact one
    per_thread = math.ceil(xr.numel() / (hbm.read_grid(dev) * hbm.THREADS))
    tol = reduction_tolerance(torch.float32, per_thread)
    rel = abs(got_r - want_r) / want_r
    check(rel <= tol, f"K1 on random data: rel err {rel:.3e} > {tol:.3e}")
    print(f"[K1] random f32, 3 sweeps: rel err {rel:.3e} against the f64 "
          f"torch.sum (tolerance {tol:.3e}, {per_thread} f32 terms/thread)")

    ms = cuda_ms(lambda: hbm.read_sum(x, sweeps), iters=3)
    plain_ms = cuda_ms(lambda: hbm.read_sum_plain(x, sweeps), iters=20)
    library_ms = cuda_ms(lambda: torch.sum(x), iters=20)
    bound_ms, bound_by = bound(0.0, sweeps * nbytes, kind)
    print(f"[K1] kernel {ms:.3f} ms for {sweeps} sweeps "
          f"({sweeps * nbytes / ms / 1e6:.1f} GB/s); bound {bound_ms:.3f} ms "
          f"({bound_by}); plain (one read) {plain_ms:.4f} ms; torch.sum "
          f"(one read) {library_ms:.4f} ms "
          f"({nbytes / library_ms / 1e6:.1f} GB/s)")
    rep = hbm.hbm_device_gbps(device=dev)
    peak = hbm.chip_peak_hbm_gbps(kind)
    print(f"[K1] hbm_device_gbps: {rep.read_gbps:.1f} GB/s "
          f"({rep.read_gbps / peak:.1%} of the {peak:.0f} GB/s data-sheet "
          f"peak), backend {rep.backend}")
    check(rep.backend == "cuda", f"hbm backend {rep.backend}")
    del x, xr
    # the read rate against the array's size: below the 50 MB L2 cache part
    # of each sweep is served from L2; each launch reads 64 GiB
    for size_mb in (16, 64, 256, 1024):
        r = hbm.hbm_read_gbps(size_mb=size_mb, sweeps=64 * 1024 // size_mb,
                              iters=3, device=dev)
        print(f"[K1] size sweep: {size_mb} MiB x {64 * 1024 // size_mb} "
              f"sweeps: {r.read_gbps:.1f} GB/s")
    return {"name": "hbm_read", "route": "cuda",
            "source": "tpu_operator_torch/csrc/hbm_read.cu",
            "replaces": "tpu_operator/ops/hbm.py:61",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": f"f32 (65536, 1024) x {sweeps} sweeps",
            "hbm_device_gbps": rep.read_gbps}


def limit_ratio(got, ref, limit) -> float:
    """The largest of |got − ref| / limit over the elements: above 1, the
    comparison fails."""
    return ((got.float() - ref).abs() / limit).max().item()


def k2_faults(q, k, v, ref, causal: bool) -> dict:
    """Two wrong kernels that the K2 limit must reject, written in bf16 as
    the kernel writes: attention with the last 64-key tile dropped, and
    the right output (``ref``, f32) scaled by 1 + 1/64."""
    from tpu_operator_torch.ops.flash_attention import BLOCK
    from tpu_operator_torch.parallel.ring_attention import softmax_weights
    w = softmax_weights(q, k, causal=causal)
    w[..., -BLOCK:] = 0.0
    dropped = torch.matmul(w / w.sum(-1, keepdim=True), v.float())
    return {"last kv tile dropped": dropped.to(q.dtype),
            "output scaled by 1+1/64": (ref * (1 + 1 / 64)).to(q.dtype)}


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION",
                 "MATH")


def sdpa_times(q, k, v, causal: bool, ref32, tag: str = "K2") -> dict:
    """Each SDPA backend alone on the 4-D ([1, H, T, D]) form of the inputs:
    its time in ms, or None where it refused them, with its max abs error
    against the f32 plain output. Only a 4-D input reaches the fused
    backends; on 3-D input SDPA runs its math backend."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    q4, k4, v4 = (x.reshape(1, -1, *x.shape[-2:]) for x in (q, k, v))
    times = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            def run():
                return F.scaled_dot_product_attention(q4, k4, v4,
                                                      is_causal=causal)
            try:
                out = run()
            except RuntimeError as exc:
                times[name] = None
                print(f"[{tag}] sdpa {name}: refused "
                      f"({str(exc).splitlines()[0][:120]})")
                continue
            err = (out.reshape(ref32.shape).float() - ref32).abs().max().item()
            times[name] = graph_ms(run, iters=20)
            print(f"[{tag}] sdpa {name}: {times[name]:.4f} ms in a graph "
                  f"({cuda_ms(run, iters=20):.4f} ms a call from the host), "
                  f"max abs err {err:.3e}")
    return times


# kv tiles per unit; None: one unit per q tile (no combine)
SWEEP_SPLITS = (2, 4, 8, 16, None)


def flash_sweep(q, k, v, causal, ref32, limit) -> dict:
    """K2's time by the most kv tiles a unit takes, each result held to the
    per-element limit."""
    from tpu_operator_torch.ops import flash_attention as flash
    scale = 1.0 / math.sqrt(q.shape[-1])
    times = {}
    for split in SWEEP_SPLITS:
        s = split or q.shape[-2] // flash.BLOCK
        out = flash.flash_launch(q, k, v, scale, causal, s)
        ratio = limit_ratio(out, ref32, limit)
        check(ratio <= 1.0, f"K2 split {split}: error {ratio:.3f}x its "
                            "per-element limit")
        label = str(split or "none")
        times[label] = graph_ms(
            lambda: flash.flash_launch(q, k, v, scale, causal, s), iters=20)
        units = len(flash.work_list(1, q.shape[-2], causal, s)[0])
        print(f"[K2] split sweep: at most {label} kv tiles a unit "
              f"({units} units): {times[label]:.4f} ms, limit ratio "
              f"{ratio:.3f}")
    return times


def flash_profile(q, k, v, causal) -> dict:
    """Device microseconds per call of each K2 kernel (the unit kernel and
    the merge), from torch.profiler over 10 wrapper calls; empty where the
    profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from tpu_operator_torch.ops.flash_attention import flash_attention
    flash_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
    times = {}
    for e in prof.key_averages():
        name = re.search(r"flash_\w*kernel", e.key)
        if name and e.device_time_total > 0:
            times[name.group()] = e.device_time_total / 10
    return times


def phase_flash(dev, kind) -> dict:
    from tpu_operator_torch.ops.flash_attention import (attention_plain,
                                                        flash_attention,
                                                        kernel_error_limit)
    from tpu_operator_torch.parallel.numerics import attention_tolerance
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 is on: the plain f32 version would not be f32")
    gen = torch.Generator(device=dev).manual_seed(1)
    main = None
    # (heads, T, D, causal); the first is the validator's main-path shape
    for h, t, d, causal in ((None, 4096, 128, True), (None, 4096, 128, False),
                            (8, 1024, 128, True)):
        shape = (t, d) if h is None else (h, t, d)
        q, k, v = (torch.randn(shape, generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal)
        check(out.shape == q.shape and out.dtype == q.dtype,
              f"K2 output {tuple(out.shape)} {out.dtype}")
        # the validator's gate: an absolute tolerance against the plain
        # version in bf16
        ref = attention_plain(q, k, v, causal=causal)
        err = (out.float() - ref.float()).abs().max().item()
        tol = attention_tolerance(torch.bfloat16, d, "cuda")
        check(math.isfinite(err) and err <= tol,
              f"K2 {shape} causal={causal}: max abs err {err:.3e} > "
              f"{tol:.3e}")
        # the per-element limit against the f32 plain output, and proof
        # that it rejects a kernel that is slightly wrong
        ref32, limit = kernel_error_limit(q, k, v, causal=causal)
        ratio = limit_ratio(out, ref32, limit)
        check(ratio <= 1.0, f"K2 {shape} causal={causal}: error "
                            f"{ratio:.3f}x its per-element limit")
        faults = {name: limit_ratio(bad, ref32, limit) for name, bad
                  in k2_faults(q, k, v, ref32, causal).items()}
        check(all(r > 1.0 for r in faults.values()),
              f"K2 limit passes a planted fault: {faults}")
        sweep = profiled = None
        if main is None:
            sweep = flash_sweep(q, k, v, causal, ref32, limit)
            profiled = flash_profile(q, k, v, causal)
            print("[K2] device time per call by kernel (torch.profiler): "
                  + (", ".join(f"{name} {us:.2f} us"
                               for name, us in profiled.items())
                     or "none seen"))
        del limit
        # the kernels alone, and a call of the wrapper from the host
        ms = graph_ms(lambda: flash_attention(q, k, v, causal=causal),
                      iters=20)
        call_ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                          iters=20)
        plain_ms = cuda_ms(lambda: attention_plain(q, k, v, causal=causal),
                           iters=10)
        sdpa = sdpa_times(q, k, v, causal, ref32)
        del ref32
        ran = {name: t for name, t in sdpa.items() if t is not None}
        check(bool(ran), "no SDPA backend took the inputs")
        backend = min(ran, key=ran.get)
        library_ms = ran[backend]
        heads = h or 1
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 4.0 * d * pairs * heads
        nbytes = 4 * heads * t * d * 2
        bound_ms, bound_by = bound(flops, nbytes, kind)
        print(f"[K2] {shape} bf16 causal={causal}: max abs err {err:.3e} "
              f"(tolerance {tol:.3e}); per-element limit ratio "
              f"{ratio:.3f} (planted faults: "
              + ", ".join(f"{n} {r:.2f}" for n, r in faults.items())
              + f"); kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s); "
              f"wrapper call {call_ms:.4f} ms; plain {plain_ms:.4f} ms; "
              f"fastest sdpa {backend} "
              f"{library_ms:.4f} ms (math {sdpa['MATH']:.4f} ms); bound "
              f"{bound_ms:.4f} ms ({bound_by})")
        if main is None:
            main = {"name": "flash_fwd", "route": "cuda",
                    "source": "tpu_operator_torch/csrc/flash_fwd.cu",
                    "replaces": "tpu_operator/ops/flash_attention.py:48",
                    "max_abs_err": err, "limit_ratio": ratio, "ms": ms,
                    "call_ms": call_ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms,
                    "bound_by": bound_by, "library_ms": library_ms,
                    "library_backend": backend,
                    "library_math_ms": sdpa["MATH"],
                    "shape": f"bf16 [{t}, {d}] causal", "split_sweep": sweep,
                    "profiled_us": profiled}
    return main


# K2g's grid: every head-dim bucket and one D off them, each dtype, causal
# and full, at T = 1024 over 2 heads; then T that 64 does not divide, with
# the blocks the reference would take for them
GENERIC_DIMS = (64, 128, 256, 96)
GENERIC_GRID_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
GENERIC_RAGGED = ((96, (32, 96)), (200, (40, 200)))
# the shapes K2g is timed at: Ulysses' per-head width, and f32 at K2's
GENERIC_TIMED = ((torch.bfloat16, 4096, 256), (torch.float32, 4096, 128))


def phase_flash_generic(dev, kind) -> dict:
    """K2g (``csrc/flash_fwd_generic.cu``) against the plain version over
    its grid, through its own wrapper and through ``flash_attention``'s
    routing, with no CUDA call reaching the plain version; the refused head
    dim; and its times beside every SDPA backend at ``GENERIC_TIMED``."""
    from tpu_operator_torch.ops import flash_attention as flash
    from tpu_operator_torch.parallel.numerics import attention_tolerance
    plain = flash.attention_plain
    plain_calls = []

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return plain(*a, **kw)
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = [(dtype, 1024, d, None, causal) for dtype in GENERIC_GRID_DTYPES
             for d in GENERIC_DIMS for causal in (True, False)]
    cases += [(dtype, t, 96, blocks, True) for dtype in GENERIC_GRID_DTYPES
              for t, blocks in GENERIC_RAGGED]
    worst = 0.0
    for dtype, t, d, blocks, causal in cases:
        q, k, v = (torch.randn((2, t, d), generator=gen, device=dev)
                   .to(dtype) for _ in range(3))
        bq, bk = blocks or (None, None)
        before = (flash.flash_attention.launches, flash.flash_generic.launches)
        flash.attention_plain = counted_plain
        try:
            direct = flash.flash_generic(q, k, v, causal=causal)
            routed = flash.flash_attention(q, k, v, causal=causal,
                                           block_q=bq, block_k=bk)
        finally:
            flash.attention_plain = plain
        wgmma = flash.takes_wgmma(q)
        check((flash.flash_attention.launches - before[0],
               flash.flash_generic.launches - before[1])
              == (int(wgmma), 2 - int(wgmma)),
              f"K2g {dtype} [{t}, {d}]: routed to the wrong kernel")
        ref = plain(q, k, v, causal=causal).float()
        tol = attention_tolerance(dtype, d, "cuda")
        for label, out in (("K2g", direct), ("routed", routed)):
            check(out.shape == q.shape and out.dtype == dtype,
                  f"{label} {dtype} [{t}, {d}]: output {tuple(out.shape)} "
                  f"{out.dtype}")
            err = (out.float() - ref).abs().max().item()
            check(math.isfinite(err) and err <= tol,
                  f"{label} {dtype} [2, {t}, {d}] causal={causal} blocks "
                  f"{blocks}: max abs err {err:.3e} > {tol:.3e}")
            worst = max(worst, err / tol)
        print(f"[K2g] {str(dtype).removeprefix('torch.')} [2, {t}, {d}] "
              f"causal={causal} blocks {blocks or 'default'}: max abs err "
              f"{(direct.float() - ref).abs().max().item():.3e} (tolerance "
              f"{tol:.3e}); flash_attention took "
              f"{'K2' if wgmma else 'K2g'}")
    check(not plain_calls, f"{len(plain_calls)} CUDA calls reached the "
                           "plain version")
    wide = torch.zeros((64, 320), device=dev)
    for fn in (flash.flash_attention, flash.flash_generic):
        try:
            fn(wide, wide, wide)
        except ValueError as exc:
            check("at most 256" in str(exc), f"D=320: {exc}")
        else:
            raise SmokeFailure(f"{fn.__name__} took D=320")
    print(f"[K2g] {len(cases)} cases x 2 wrappers within attention_tolerance "
          f"(worst {worst:.3f} of it); no CUDA call reached the plain "
          "version; D=320 raises")

    timed = []
    for dtype, t, d in GENERIC_TIMED:
        q, k, v = (torch.randn((t, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        ref32 = plain(q.float(), k.float(), v.float(), causal=True)
        out = flash.flash_generic(q, k, v, causal=True)
        err = (out.float() - ref32).abs().max().item()
        tol = attention_tolerance(dtype, d, "cuda")
        check(err <= tol, f"K2g timed shape {dtype} [{t}, {d}]: max abs err "
                          f"{err:.3e} > {tol:.3e}")
        ms = graph_ms(lambda: flash.flash_generic(q, k, v, causal=True),
                      iters=10)
        plain_ms = cuda_ms(lambda: plain(q, k, v, causal=True), iters=5)
        sdpa = sdpa_times(q, k, v, True, ref32, tag="K2g")
        ran = {name: ms_ for name, ms_ in sdpa.items() if ms_ is not None}
        check(bool(ran), "no SDPA backend took K2g's inputs")
        backend = min(ran, key=ran.get)
        flops = 4.0 * d * t * (t + 1) / 2
        nbytes = 4 * t * d * q.element_size()
        bound_ms, bound_by = bound(
            flops, nbytes, kind,
            F32_PEAK_TFLOPS if dtype == torch.float32 else None)
        shape = f"{str(dtype).removeprefix('torch.')} [{t}, {d}] causal"
        print(f"[K2g] {shape}: kernel {ms:.4f} ms in a graph "
              f"({flops / ms / 1e9:.1f} TFLOP/s); plain {plain_ms:.4f} ms; "
              f"fastest sdpa {backend} {ran[backend]:.4f} ms; bound "
              f"{bound_ms:.4f} ms ({bound_by}); max abs err {err:.3e}")
        timed.append({"shape": shape, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": ran[backend], "library_backend": backend,
                      "max_abs_err": err})
        del q, k, v, ref32, out
    main, f32 = timed
    return {"name": "flash_fwd_generic", "route": "cuda",
            "source": "tpu_operator_torch/csrc/flash_fwd_generic.cu",
            "replaces": "tpu_operator/ops/flash_attention.py:48",
            **main, "grid_worst_tolerance_share": worst, "f32": f32}


# (name, wrapper, plain version, TPU kernel it replaces, rows per rank
# divisible by n or 2n)
RING_KERNELS = (
    ("ring_all_gather", "ring_all_gather", "all_gather_plain", 48, 1),
    ("ring_reduce_scatter", "ring_reduce_scatter", "reduce_scatter_plain",
     216, 1),
    ("ring_all_reduce", "ring_all_reduce", "all_reduce_plain", 126, 1),
    ("ring_all_reduce_bidir", "ring_all_reduce_bidir",
     "all_reduce_bidir_plain", 311, 2),
)
# the kernels' own schedule on the card, beside the TPU kernels' one
DIRECT_PLAIN = {"ring_all_gather": "all_gather_direct_plain",
                "ring_reduce_scatter": "reduce_scatter_direct_plain",
                "ring_all_reduce": "all_reduce_direct_plain",
                "ring_all_reduce_bidir": "all_reduce_bidir_direct_plain"}
PAYLOAD_MB, PAYLOAD_COLS = 64, 512   # the validator's collective payload


def ring_library(name: str, xs):
    """The library result: what every rank (or rank d, for the
    reduce-scatter) must hold."""
    if name == "ring_all_gather":
        return [torch.cat(xs)] * len(xs)
    total = torch.stack(xs).sum(0)
    if name == "ring_reduce_scatter":
        return list(total.chunk(len(xs)))
    return [total] * len(xs)


def ring_bytes(name: str, n: int, per_rank: int) -> tuple[int, float]:
    """Bytes the ranks must move (each rank's input read once and output
    written once), and nccl-tests' bus-bandwidth factor on ``per_rank``
    input bytes (``tpu_operator/parallel/collectives.py:15-19``)."""
    if name == "ring_all_gather":
        return n * (per_rank + n * per_rank), (n - 1) / n * n
    if name == "ring_reduce_scatter":
        return n * (per_rank + per_rank // n), (n - 1) / n
    return n * 2 * per_rank, 2 * (n - 1) / n


def design_bytes(name: str, n: int, per_rank: int) -> int:
    """Bytes the kernel's own schedule reads and writes in device memory,
    all ranks together (``csrc/ring.cu``'s note): the sender writes into
    the neighbour's output or, K4's partial sums, its staging area."""
    c = per_rank // n    # a hop's chunk (K6: a chunk of each half); K3's
    # hop moves a whole rank's input
    return n * {"ring_all_gather": per_rank * (2 * n - 1),
                "ring_reduce_scatter": c * (3 * n - 1),
                "ring_all_reduce": c * (5 * n - 4),
                "ring_all_reduce_bidir": c * (5 * n - 4)}[name]


def ring_library_n(name: str, xs, outs):
    """One call that computes the function with a library call and leaves
    it in every rank's output, as the kernel does."""
    n = len(xs)
    if name == "ring_all_gather":
        def run():
            for o in outs:
                torch.cat(xs, out=o)
    elif name == "ring_reduce_scatter":
        def run():
            torch._foreach_copy_(outs, torch.stack(xs).sum(0).chunk(n))
    else:
        def run():
            torch.sum(torch.stack(xs), 0, out=outs[0])
            torch._foreach_copy_(outs[1:], [outs[0]] * (n - 1))
    return run


def phase_ring(dev, kind) -> list[dict]:
    from tpu_operator_torch.parallel import ring
    from tpu_operator_torch.parallel.numerics import reduction_tolerance
    gen = torch.Generator(device=dev).manual_seed(5)
    entries = {}
    for n in (2, 4, 8):
        tol = reduction_tolerance(torch.float32, n)
        for name, wrapper, plain, line, step in RING_KERNELS:
            fn, plain_fn = getattr(ring, wrapper), getattr(ring, plain)
            payload_rows = PAYLOAD_MB * (1 << 20) // 4 // PAYLOAD_COLS
            payload_rows += -payload_rows % (step * n)
            # the dry run's array (2n², 128) split over the ranks, and the
            # validator's 64 MiB per rank shaped as its ring bandwidth
            # probe shapes it
            for label, rows, cols in (("dry run", 2 * n, 128),
                                      ("64 MiB", payload_rows, PAYLOAD_COLS)):
                xs = [torch.randn((rows, cols), generator=gen, device=dev)
                      for _ in range(n)]
                outs = fn(xs)
                want = plain_fn(xs)
                check(all(torch.equal(o, w) for o, w in zip(outs, want)),
                      f"{name} n={n} {label}: kernel differs from its plain "
                      "version")
                # the card's own schedule, one piece a rank (its bits do
                # not depend on the blocks and pieces)
                direct = getattr(ring, DIRECT_PLAIN[name])(
                    xs, piece_bytes=4 * xs[0].numel())
                check(all(torch.equal(o, w) for o, w in zip(outs, direct)),
                      f"{name} n={n} {label}: kernel differs from the "
                      "plain version of its own schedule")
                del direct
                lib = ring_library(name, xs)
                errs = [(o - w).abs().max().item() for o, w in zip(outs, lib)]
                if name == "ring_all_gather":
                    check(max(errs) == 0.0,
                          f"{name} n={n} {label}: differs from torch.cat")
                else:
                    ok = all(bool(((o - w).abs() <= tol + tol * w.abs()).all())
                             for o, w in zip(outs, lib))
                    check(ok, f"{name} n={n} {label}: max abs err "
                              f"{max(errs):.3e} against the library sum, "
                              f"beyond reduction_tolerance {tol:.3e}")
                print(f"[{name}] n={n} {label} per rank ({rows}, {cols}) "
                      f"f32: == plain (exact, both schedules); max abs err "
                      f"{max(errs):.3e} "
                      f"against the library (tolerance "
                      f"{0.0 if name == 'ring_all_gather' else tol:.3e})")
                if n == 4 and label == "64 MiB":
                    entries[name] = ring_timing(
                        name, fn, plain_fn, xs, want, kind, line, max(errs))
                del xs, outs, want, lib
    ring_small(dev)
    ring_suite(dev)
    return [entries[name] for name, *_ in RING_KERNELS]


def ring_timing(name, fn, plain_fn, xs, want, kind, line, lib_err) -> dict:
    """Times one kernel alone: its launch is set up once (staging, signal
    words, pointer table) and the timed loop holds only the launches, each
    with the zeroing of its signal words. ``want`` is the plain version's
    result on ``xs``."""
    from tpu_operator_torch.parallel import ring
    from tpu_operator_torch.parallel.numerics import reduction_tolerance
    n = len(xs)
    per_rank = xs[0].numel() * 4
    launch = ring.RingLaunch(name.removeprefix("ring_"), xs)
    ms = cuda_ms(launch.launch, iters=10)
    launch.raise_on_stall()
    err = max((o - w).abs().max().item() for o, w in zip(launch.outs, want))
    check(err == 0.0, f"{name} n={n}: repeated launches differ from the "
                      f"plain version by {err:.3e}")
    # what a caller of the wrapper waits per call: set-up, the launch and
    # the read of the status words
    call_ms = cuda_ms(lambda: fn(xs), iters=10)
    plain_ms = cuda_ms(lambda: plain_fn(xs), iters=3)
    if name == "ring_all_gather":
        library_ms = cuda_ms(lambda: torch.cat(xs), iters=10)
    else:
        library_ms = cuda_ms(lambda: torch.stack(xs).sum(0), iters=10)
    lib_outs = [torch.empty_like(o) for o in launch.outs]
    library_n = ring_library_n(name, xs, lib_outs)
    library_n_ms = cuda_ms(library_n, iters=10)
    tol = reduction_tolerance(torch.float32, n)
    check(all(torch.equal(o, w) if name == "ring_all_gather" else
              bool(((o - w).abs() <= tol + tol * w.abs()).all())
              for o, w in zip(lib_outs, ring_library(name, xs))),
          f"{name}: the {n}-output library call gives another result")
    nbytes, factor = ring_bytes(name, n, per_rank)
    bound_ms, bound_by = bound(0.0, nbytes, kind)
    moved = design_bytes(name, n, per_rank)
    busbw = factor * per_rank / ms / 1e6
    print(f"[{name}] n={n} x 64 MiB: kernel {ms:.4f} ms; wrapper call "
          f"{call_ms:.4f} ms; plain {plain_ms:.4f} ms; library "
          f"{library_ms:.4f} ms (one output), {library_n_ms:.4f} ms "
          f"({n} outputs); bound "
          f"{bound_ms:.4f} ms ({bound_by}, {nbytes / 2**20:.0f} MiB); "
          f"the design moves {moved / 2**20:.0f} MiB: "
          f"{moved / ms / 1e9:.1f} TB/s effective; busbw "
          f"{busbw:.1f} GB/s (loopback on one card: device-memory copies, "
          f"not NVLink)")
    return {"name": name, "route": "cuda",
            "source": "tpu_operator_torch/csrc/ring.cu",
            "replaces": f"tpu_operator/parallel/ring.py:{line}",
            "max_abs_err": err, "library_max_abs_err": lib_err, "ms": ms,
            "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_n_ms": library_n_ms, "design_bytes": moved,
            "shape": f"f32 n=4 x ({xs[0].shape[0]}, {xs[0].shape[1]}) per rank",
            "loopback_busbw_gbps": busbw, "blocks": launch.blocks,
            "piece_bytes": 16 * launch.piece4,
            "sweep": ring_sweep(name, xs, want)}


# piece bytes; None: one piece per slice
SWEEP_PIECES = (8 << 10, 16 << 10, 32 << 10, 64 << 10, 128 << 10, None)


def ring_sweep(name, xs, want) -> dict:
    """A ring kernel's time alone by piece size, each checked
    against the plain version after its launches."""
    from tpu_operator_torch.parallel import ring
    kind = name.removeprefix("ring_")
    times = {}
    whole = 4 * xs[0].numel()          # at least a slice
    for piece in SWEEP_PIECES:
        launch = ring.RingLaunch(kind, xs, piece_bytes=piece or whole)
        ms = cuda_ms(launch.launch, iters=10)
        launch.raise_on_stall()
        check(all(torch.equal(o, w) for o, w in zip(launch.outs, want)),
              f"{name} piece {piece}: differs from plain")
        label = f"{piece >> 10} KiB" if piece else "slice"
        times[label] = ms
        print(f"[{name}] sweep: {label} ({launch.blocks} blocks/rank, "
              f"piece {16 * launch.piece4} B): {ms:.4f} ms")
    return times


def ring_small(dev) -> None:
    """Each ring kernel alone at 64 KiB per rank, where the handshakes and
    not the bytes set the time. The launch and the entry barrier cost about
    the same at n = 2 and n = 8, so the difference over the hops added is
    what one hop's wait, copy and signal cost (the least of 5 means of 50
    launches each, since a launch's own time varies by microseconds)."""
    from tpu_operator_torch.parallel import ring
    gen = torch.Generator(device=dev).manual_seed(9)
    for name, _, plain, *_ in RING_KERNELS:
        times, hops = {}, {}
        for n in (2, 8):
            xs = [torch.randn((64, 256), generator=gen, device=dev)
                  for _ in range(n)]
            launch = ring.RingLaunch(name.removeprefix("ring_"), xs)
            times[n] = min(cuda_ms(launch.launch, iters=50, warmup=3)
                           for _ in range(5))
            launch.raise_on_stall()
            want = getattr(ring, plain)(xs)
            check(all(torch.equal(o, w) for o, w in zip(launch.outs, want)),
                  f"{name} n={n} at 64 KiB per rank: differs from plain")
            hops[n] = n - 1 if name in ("ring_all_gather",
                                        "ring_reduce_scatter") \
                else 2 * (n - 1)
        per_hop = (times[8] - times[2]) / (hops[8] - hops[2])
        print(f"[{name}] 64 KiB per rank: kernel {times[2] * 1e3:.1f} us "
              f"at n=2 ({hops[2]} hops), {times[8] * 1e3:.1f} us at n=8 "
              f"({hops[8]} hops, {launch.blocks} blocks/rank): "
              f"{per_hop * 1e3:.2f} us per hop")


def ring_suite(dev) -> None:
    """The validator's collective suite on 4 virtual ranks at its 64 MiB
    payload, report by report. On one card every figure is a loopback
    through device memory with the host's time per call in it."""
    from tpu_operator_torch.parallel.collectives import run_collective_suite
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    mesh = make_mesh(4, MeshPlan(data=1, model=4), device=dev)
    for r in run_collective_suite(mesh, "model", mbytes=PAYLOAD_MB, iters=3):
        print(f"[suite] {r.op}: n={r.n_devices}, {r.payload_bytes} B, best "
              f"of 3 {r.seconds * 1e3:.4f} ms on the host clock, loopback "
              f"busbw {r.busbw_gbps:.1f} GB/s")


def phase_dryrun() -> None:
    from tpu_operator_torch.entry import dryrun_multigpu
    t0 = time.perf_counter()
    loss = dryrun_multigpu(4)
    torch.cuda.synchronize()
    check(math.isfinite(loss), f"dry run loss {loss}")
    print(f"[dryrun] dryrun_multigpu(4) at full width: "
          f"{time.perf_counter() - t0:.3f} s on the host clock")


def phase_entry() -> None:
    from tpu_operator_torch.entry import entry
    from tpu_operator_torch.ops.burnin import BurninConfig, BurninModel
    from tpu_operator_torch.parallel.numerics import residual_limit
    cfg = BurninConfig()
    model, args = entry()
    with torch.no_grad():
        y = model(*args)
        torch.cuda.synchronize()
        check(y.shape == (cfg.batch, cfg.d_model) and y.dtype == cfg.dtype,
              f"entry output {tuple(y.shape)} {y.dtype}")
        check(bool(torch.isfinite(y).all()), "entry output not finite")
        w_in = model.w_in.detach().float().cpu()
        w_out = model.w_out.detach().float().cpu()
        x = args[0].float().cpu()
        want = BurninModel(w_in, w_out)(x)
        # a wrong forward the limit must reject: the last layer left out
        short = BurninModel(w_in[:-1], w_out[:-1])(x)
    limit = residual_limit(want, cfg.dtype, cfg.n_layers, "cuda")
    ratio = limit_ratio(y.cpu(), want, limit)
    fault = limit_ratio(short, want, limit)
    check(ratio <= 1.0, f"entry: bf16 on the card vs f32 on the CPU: error "
                        f"{ratio:.3f}x its per-element limit")
    check(fault > 1.0, f"entry: the limit passes a forward without its "
                       f"last layer ({fault:.3f}x)")
    err = (y.float().cpu() - want).abs().max().item()
    print(f"[entry] burn-in forward d_model={cfg.d_model} "
          f"d_hidden={cfg.d_hidden} layers={cfg.n_layers} batch={cfg.batch}"
          f" bf16 on {y.device}: finite; max abs err {err:.3e} against f32 "
          f"on the CPU (output max {want.abs().max().item():.3f}); "
          f"per-element limit ratio {ratio:.3f} (last layer left out: "
          f"{fault:.2f})")


VALIDATE_COMPONENTS = ("driver", "fabric", "workload")


def phase_validate() -> dict:
    """The node validator's CLI, as the DaemonSet calls it, on this
    machine's own ``/dev``, ``libcuda.so.1`` and
    ``/proc/driver/nvidia/version``: ``driver``, ``fabric`` and
    ``workload`` in turn, then the gate on their status files."""
    import contextlib
    import io
    from tpu_operator_torch.cli.validator import main as validator
    with tempfile.TemporaryDirectory() as vdir:
        lines = {}
        for name in VALIDATE_COMPONENTS + ("gate",):
            argv = ["--component", name, "--validations-dir", vdir]
            if name == "gate":
                argv += ["--gates", ",".join(VALIDATE_COMPONENTS)]
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rc = validator(argv)
            print(f"[validate] {name}: {out.getvalue().strip()}")
            line = json.loads(out.getvalue())
            check(rc == 0 and line["ok"] is True,
                  f"validator --component {name}: rc {rc}, {line}")
            lines[name] = line["info"]
        with open(os.path.join(vdir, "workload-ready")) as f:
            status = json.load(f)
        runtime_build = os.path.exists(os.path.join(vdir, "runtime-build"))
    info = lines["workload"]
    check(status["ok"] is True and status["info"] == info,
          "status file does not hold the info")
    check(info["hbm_backend"] == "cuda" and info["platform"] == "cuda",
          f"validator ran off the card: {info}")
    check(lines["fabric"]["nvlink"] == "skipped (single device)",
          f"fabric on one card: {lines['fabric']}")
    check(lines["driver"]["devices"] and not lines["driver"]["skew"],
          f"driver: {lines['driver']}")
    print(f"[validate] driver {lines['driver']['build']} (library "
          f"{lines['driver']['library']}); kernel module recorded by the "
          f"workload: {runtime_build}")
    return info


SUITE_OPS = ("allreduce", "all_gather", "reduce_scatter", "all_to_all",
             "ppermute_ring", "ring_allreduce", "ring_allreduce_bidir")


def phase_validate_ranks() -> None:
    """The validator with its multi-device leg, on 4 virtual ranks."""
    from tpu_operator_torch.validator.components import WorkloadComponent
    with tempfile.TemporaryDirectory() as vdir:
        info = WorkloadComponent(device="cuda", ranks=4,
                                 validations_dir=vdir).run()
    check(tuple(info["collectives"]) == SUITE_OPS,
          f"collective suite reported {list(info['collectives'])}")
    check(all(math.isfinite(bw) and bw > 0
              for bw in info["collectives"].values()),
          f"collective suite rates {info['collectives']}")
    ring_check = info["ring_attention"]
    check(ring_check["ok"] is True and ring_check["seq_len"] == 512
          and ring_check["max_abs_err"] <= ring_check["tolerance"],
          f"ring attention check {ring_check}")
    legs = info["leg_seconds"]
    print(f"[validate ranks=4] collectives (loopback busbw, GB/s) "
          f"{json.dumps(info['collectives'])}; ring attention "
          f"{json.dumps(ring_check)}; leg_seconds {json.dumps(legs)}")


# (Dh, T): K2's head width at the full sequence, and a width only K2g
# takes, at a shorter one (K2g runs on CUDA cores)
ULYSSES_SHAPES = ((128, 4096), (256, 1024))


def phase_ulysses() -> None:
    """Ulysses attention on 4 virtual ranks, 8 heads, bf16, causal and not:
    at Dh = 128 each rank's [2, T, 128] goes through K2, at Dh = 256 through
    K2g, once per rank; the result is held to K2's per-element limit
    against the single-device computation."""
    from tpu_operator_torch.ops import flash_attention as flash
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.numerics import attention_tolerance
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, h = 4, 8
    dev = torch.device("cuda", 0)
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    for d, t in ULYSSES_SHAPES:
        q, k, v = (torch.randn((t, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        tol = attention_tolerance(torch.bfloat16, d, "cuda")
        kernel = "K2" if d == 128 else "K2g"
        for causal in (True, False):
            shards = [list(x.chunk(n)) for x in (q, k, v)]
            before = (flash.flash_attention.launches,
                      flash.flash_generic.launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = torch.cat(ulysses_attention(*shards, mesh, "model",
                                              causal=causal))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = (flash.flash_attention.launches - before[0],
                        flash.flash_generic.launches - before[1])
            check(launched == ((n, 0) if kernel == "K2" else (0, n)),
                  f"Ulysses Dh={d} causal={causal}: (K2, K2g) launched "
                  f"{launched} times for {n} ranks")
            check(out.shape == (t, h, d) and out.dtype == torch.bfloat16,
                  f"Ulysses output {tuple(out.shape)} {out.dtype}")
            # the single-device computation, heads first
            ref32, limit = flash.kernel_error_limit(
                *(x.permute(1, 0, 2) for x in (q, k, v)), causal=causal)
            got = out.permute(1, 0, 2)
            ratio = limit_ratio(got, ref32, limit)
            err = (got.float() - ref32).abs().max().item()
            check(ratio <= 1.0, f"Ulysses Dh={d} causal={causal}: error "
                                f"{ratio:.3f}x K2's per-element limit")
            check(math.isfinite(err) and err <= tol,
                  f"Ulysses Dh={d} causal={causal}: max abs err {err:.3e} "
                  f"> {tol:.3e}")
            del ref32, limit
            print(f"[ulysses] n={n} T={t} H={h} Dh={d} bf16 causal={causal}: "
                  f"{kernel} launched {n} times on [{h // n}, {t}, {d}]; "
                  f"per-element limit ratio {ratio:.3f}; max abs err "
                  f"{err:.3e} (tolerance {tol:.3e}); {wall * 1e3:.3f} ms on "
                  f"the host clock")
        del q, k, v


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from tpu_operator_torch.ops import flash_attention as flash_mod
    from tpu_operator_torch.ops import hbm as hbm_mod
    from tpu_operator_torch.parallel import ring as ring_mod

    dev = torch.device("cuda", 0)
    kind, smi_line = phase_card()
    phase_build()
    kernels = [phase_hbm(dev, kind), phase_flash(dev, kind),
               phase_flash_generic(dev, kind), *phase_ring(dev, kind)]

    # each path runs with its kernels' counts set to 0 just before it and
    # read just after
    paths = (
        ("single-GPU validation", (phase_entry, phase_validate),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        ("dry run", (phase_dryrun,),
         {name: getattr(ring_mod, wrapper)
          for name, wrapper, *_ in RING_KERNELS}),
        ("4-rank validation", (phase_validate_ranks,),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention,
          "ring_all_reduce": ring_mod.ring_all_reduce,
          "ring_all_reduce_bidir": ring_mod.ring_all_reduce_bidir}),
        ("Ulysses", (phase_ulysses,),
         {"flash_fwd": flash_mod.flash_attention,
          "flash_fwd_generic": flash_mod.flash_generic}),
    )
    # a kernel's launches: the sum over the paths that must reach it
    launches = {entry_["name"]: 0 for entry_ in kernels}
    for path, phases, counters in paths:
        for fn in counters.values():
            fn.launches = 0
        for phase in phases:
            phase()
        counts = {name: fn.launches for name, fn in counters.items()}
        print(f"[kernels] launches on the {path} path: {counts}")
        for name, count in counts.items():
            check(count > 0, f"{name} never launched on the {path} path")
            launches[name] += count
    for entry_ in kernels:
        entry_["launches"] = launches[entry_["name"]]
        check(entry_["launches"] > 0,
              f"{entry_['name']} never launched on the main path")

    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
