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
the fastest is its library time; it is also held and timed at the
bench's shape, bf16 [16384, 128] causal. K2w (K2's kernel template at
every other f16 or bf16 input with D ≤ 256, D % 8 = 0) and K2s (the
register-tiled CUDA-core kernel: f32, and 16-bit inputs K2w does not take,
D ≤ 512) are
held against the plain version over f32, f16 and bf16, head dims 64, 96,
128, 256, 384 and 512, causal and full, and sequence lengths that 64 does
not divide, through their own wrappers and through ``flash_attention``'s
routing, and timed the same way (K2w also by the keys a kv step takes at
D = 256). Then it holds the ring kernels (K3–K6) against their
plain versions and the library sums for 2, 4 and 8 virtual ranks on the
card, times them at 4 × 64 MiB (with the bytes their schedules move, a
library call that fills all n outputs, and a sweep of piece sizes) and at
4 × 64 KiB (the per-hop handshake), prints the collective bandwidth
suite's reports on 4 virtual ranks, and runs the multi-device dry run
``dryrun_multigpu(4)``, whose ring checks must go through those kernels.
Then ``WorkloadComponent(ranks=4)`` runs the validator's multi-device leg
on 4 virtual ranks, whose collective suite must launch K5 and K6 at its 64
MiB payload, and Ulysses attention runs with 8 heads over 4 virtual ranks,
causal and not, at T = 4096 with Dh = 128, where K2 must launch once per
rank, Dh = 256, where K2w must, and Dh = 384, where K2s must; the result is
held to the per-element limit against the single-device computation; at
Dh = 384 it is also timed beside the same call with each rank's attention
dense (``attention_plain``), outside the counted run. The build phase prints ptxas's registers and spills for every flash kernel.
Last, the node health monitor's CLI runs once as its DaemonSet would, on
the machine's ``/dev`` and NVML with the HBM sweep on K1 at 256 MiB, and
must publish the node healthy; then each probe is called directly
(presence, NVLink and error counters through NVML, the HBM sweep at 8 and
256 MiB), each card NVML sees must have its device node, and the device
scan and feature discovery's labels are printed. Then the node agents
(``tpu_operator_torch/native``) are built with the host C++ compiler and
run on the machine: ``gpu-smoke --run-add`` JIT-compiles its PTX add on
the machine's ``libcuda.so.1`` at n = 1024 and 1 << 24 and must be exact
(and must fail on a library without ``cuInit``); ``gpu-metrics-agent``
must list each card NVML lists under its minor number and name, and the
metrics exporter must scrape it over HTTP; ``gpu-node-agent`` generates
the CDI spec, probes, and stages the machine's driver library into a
temporary directory; ``gpu-oci-hook`` injects NVML's card into a
temporary bundle with its node's device number. Last, the operator's
states: the NVLink slice manager's CLI runs once per profile (``full``,
``nvlink-pairs``, ``per-gpu``) on the machine's ``/dev`` and NVML against a
fake cluster file, and its plan must hold exactly the cards NVML lists;
the state pipeline renders every operand for a fake cluster holding this
node (labelled by the port's feature discovery on this card) and a CPU
node, and a second pass must write nothing; then the ``workload``
validation container it rendered runs through the validator CLI with its
own environment, where K1 and K2 must launch. Last, the operator: its CLI
(``tpu_operator_torch.cli.operator``, ``--client fake:<file> --once``)
runs pass after pass on a file-backed fake cluster of this node, a CPU
node and the sample ``GPUClusterPolicy``, with this script marking the
rendered DaemonSets ready between passes, until it reports ready; three
more passes must move no object's resourceVersion; the ``workload``
container of the validator DaemonSet it rendered runs on the card (K1 and
K2 must launch); and ``gpu-oci-hook`` must inject the same card node for
the card's NVML UUID as for its minor number. Last, the operator over the
wire: the port's apiserver runs as its own process over TLS
(``python -m tpu_operator_torch.kube.apiserver``), seeded over the wire
with this node (labelled by feature discovery on this card), a CPU node
and the sample policy; the operator's serving loop runs as a process
with leader election (``cli.operator --leader-elect``) beside a standby;
this script plays kubelet, running the validator DaemonSet's ``workload``
container on the card (K1 and K2 must launch) before it writes the
DaemonSets' rollouts done; the policy must reach ready, a disabled
exporter's DaemonSet must go through the watch wake in under 20 s, the
standby must take the Lease after the leader is killed without moving any
object but the Lease, and ``e2e.time_to_ready`` must pass with 13 states
and no read in its converged pass. Last, the operator installed from its
chart: the port's cfg tool passes ``validate chart``, ``crd``,
``clusterpolicy`` (the sample) and ``csv`` offline; the port's apiserver
runs as its own process over TLS, seeded through ``cli.kubectl apply``
with this node (labelled by feature discovery on this card and NFD's PCI
label) and a CPU node; ``cfg render chart | kubectl apply -f -`` installs
the release; the operator starts from the applied Deployment, its image
resolved to a port Dockerfile through ``tpu_operator_torch/Makefile`` and
its command to that image's shim, with two printed substitutions (the
wire URL for the in-cluster client, the checkout for the image's baked
paths), and reconciles the chart's policy; the validator DaemonSet's
``workload`` container runs through the validator image's shim on the card
(K1 and K2 must launch); the policy must reach ready; a re-install with
``--set metricsExporter.enabled=false`` must remove the exporter's
DaemonSet in under 20 s; must-gather must dump the policy and the
DaemonSets; uninstall deletes the CR and the chart's objects, and the
operator exits 0 on SIGINT. Last, the relay replica: the operator CLI
drives a policy with the relay enabled (QoS, sessions, SPMD, the
utilization ledger, tracing, and resharding with its plan file) to ready,
with ``state-relay-service`` ready and the validator DaemonSet's
``workload`` container run on the card (K1 and K2 must launch); the
rendered ``gpu-relay-service`` command, resolved through the relay image,
self-tests as its own process (64 admitted, 64 completed, 0 missing, rc
0); ``build_service()`` under the rendered environment serves a seeded
drive at full width (8 tenants over three QoS classes, 64 sessions of 16
decode steps, 10,000 one-shot requests, a plan cutover halfway) in which
every admitted request and step is committed exactly once, every KV cache
holds its pages byte for byte, no SPMD output is gathered by copy and the
ledger's six components sum to the elapsed time on the ``h100`` kind; then
the command serves on a free port, its ``/metrics`` holds the
``gpu_operator_relay_*`` families, and SIGINT exits 0. The replica itself
launches no kernel: it runs on the simulated backend, as the reference's
does. Last, the relay tier: the operator CLI drives the same relay policy
with the router (2 replicas), its autoscaler (1 to 4) and the federation
(2 cells) switched on to ready, with the three relay Deployments rendered
and the ``workload`` container run on the card (K1 and K2 must launch);
``gpu-relay-router --self-test`` and ``gpu-relay-federation --self-test``,
resolved through the relay image, run as processes (rc 0, 0 missing); a
seeded drive of each front door under its rendered environment (the
router: one-shot traffic with a flooding tenant across a scale-up, a
replica kill and an autoscaler scale-down; the federation: a cell kill, a
fresh cell, a cell drain) executes every admitted request exactly once
against the backends' execution counts, and every 429 is raised by one
replica and never run; both commands serve on a free port with their
``gpu_operator_relay_router_*`` and ``..._fed_*`` families, the router's
``/debug/pools`` keyed by replica id, and exit 0 on SIGINT; the
federation harness (``e2e/federation.py --ci``) reports ok, and the tier
harness (``e2e/relay_tier.py --ci``) reports only its scaling gate, an
open fault (F13) it shares with the reference under the ``h100`` kind.
Then the port's bench, ``tpu_operator_torch.bench.main([])``, in this
process: it must print one JSON line of the reference's shape, every
device line named for the card and none for a TPU; the matmul must clear
the validator's efficiency gate, the HBM line (K1 at 256 MiB, 2048/512
sweeps) and the flash line (K2 at bf16 [16384, 128] causal in CUDA graphs,
against the fastest fused SDPA backend) must not be suspect, the smoke
must score 1.0 through the machine's ``libcuda.so.1``, the collectives
line must be the one-card N/A, and each harness line must be ok but for
two host-clock bars and F13 (``BENCH_ALLOWED``); K1 and K2 must launch,
and each line's host-clock seconds are printed (``[bench]`` lines).
Last, the static gate, which launches no kernel: the invariant analyzer
(``python -m tpu_operator_torch.analysis --all``) must find nothing in
the checkout, ``--list`` must name its eight passes, ``make -C
tpu_operator_torch lint-compile`` must pass, and the CI case
``scripts/cases/cdi-runtime.sh`` must render its two chart overrides and
hand over (to a stub here: the e2e cycle is the other paths' work); each
step's rc and seconds on the host clock go to a ``[lint]`` line.
Nothing is written outside temporary directories but the byte-compiled
files of the sweep.

Output: progress lines, then the ``nvidia-smi`` name and power limit, then
one JSON line with every kernel's launches on the main path, error, times
and bound, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
Any failed check raises, and the script exits non-zero without that line.
Without a CUDA card, or without the ``tpu_operator_torch`` package beside
it, it fails.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
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


def demangle(names: list[str]) -> list[str]:
    """C++ names of mangled symbols, by c++filt where the machine has it."""
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
        got = out.stdout.splitlines()
        return got if len(got) == len(names) else names
    except OSError:
        return names


def phase_build() -> None:
    """Builds the kernels, and prints ptxas's registers and spills for each
    flash-attention kernel; a flash kernel that spills fails."""
    from tpu_operator_torch import _native
    t0 = time.perf_counter()
    _native.library()
    print(f"[build] {len(_native.sources())} sources -> "
          f"{_native.library_path().name} in "
          f"{time.perf_counter() - t0:.1f} s")
    res = {name: r for name, r in _native.kernel_resources().items()
           if "flash" in name}
    for pretty, (regs, spill) in zip(demangle(list(res)), res.values()):
        print(f"[build] {pretty.replace('(anonymous namespace)::', '')}: "
              f"{regs} registers, {spill} bytes spilled")
    spilled = [name for name, (_, spill) in res.items() if spill]
    check(bool(res) and not spilled, f"flash kernels spill: {spilled}")


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
    # (heads, T, D, causal); the first is the validator's main-path shape,
    # the last the bench's (flash_vs_sdpa_tflops)
    for h, t, d, causal in ((None, 4096, 128, True), (None, 4096, 128, False),
                            (8, 1024, 128, True), (None, 16384, 128, True)):
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


# K2w's and K2s's grid: each dtype, the head-dim buckets both kernels take
# and one D off them (96), the buckets only K2s takes, causal and full, at T
# = 1024 and at T that 64 does not divide (with the blocks the reference
# would take for them), over 2 heads
GRID_DTYPES = (torch.float32, torch.float16, torch.bfloat16)
GRID_DIMS = (64, 96, 128, 256, 384, 512)
GRID_T = ((1024, (None, None)), (96, (32, 96)), (200, (40, 200)))
# the shapes timed: the main path's first on each kernel (Ulysses' head
# widths, 256 on K2w and 384 on K2s), then two others on K2w and f32 at K2's
# shape on K2s
TIMED = ((torch.bfloat16, 4096, 256), (torch.float16, 4096, 128),
         (torch.bfloat16, 4096, 64), (torch.bfloat16, 4096, 384),
         (torch.float32, 4096, 128))
# K2w's keys a kv step at DP = 256
SWEEP_BLOCK_K = (32, 64)
# the wrapper that counts each kernel's launches
WRAPPERS = {"K2": "flash_attention", "K2w": "flash_wgmma",
            "K2s": "flash_generic"}


def flash_within(out, q, k, v, causal) -> tuple[float, str]:
    """The error of a flash output as a share of what it may be: 16-bit
    against ``kernel_error_limit`` per element, f32 against
    ``attention_tolerance`` (max abs)."""
    from tpu_operator_torch.ops import flash_attention as flash
    from tpu_operator_torch.parallel.numerics import attention_tolerance
    if q.dtype == torch.float32:
        ref = flash.attention_plain(q, k, v, causal=causal).float()
        err = (out.float() - ref).abs().max().item()
        return err / attention_tolerance(q.dtype, q.shape[-1], "cuda"), \
            "of attention_tolerance"
    ref32, limit = flash.kernel_error_limit(q, k, v, causal=causal)
    return limit_ratio(out, ref32, limit), "of the per-element limit"


def time_flash(label, run, q, k, v, kind) -> dict:
    """One timed shape (causal): the kernel in a CUDA graph beside the
    plain version, every SDPA backend and the bound."""
    from tpu_operator_torch.ops import flash_attention as flash
    t, d = q.shape[-2:]
    ref32 = flash.attention_plain(q.float(), k.float(), v.float(),
                                  causal=True)
    out = run()
    ratio, of = flash_within(out, q, k, v, True)
    check(ratio <= 1.0, f"{label} timed shape: error {ratio:.3f} {of}")
    err = (out.float() - ref32).abs().max().item()
    ms = graph_ms(run, iters=20)
    plain_ms = cuda_ms(lambda: flash.attention_plain(q, k, v, causal=True),
                       iters=5)
    sdpa = sdpa_times(q, k, v, True, ref32, tag=label)
    ran = {name: ms_ for name, ms_ in sdpa.items() if ms_ is not None}
    check(bool(ran), f"no SDPA backend took {label}'s inputs")
    backend = min(ran, key=ran.get)
    flops = 4.0 * d * t * (t + 1) / 2
    nbytes = 4 * t * d * q.element_size()
    bound_ms, bound_by = bound(
        flops, nbytes, kind,
        F32_PEAK_TFLOPS if q.dtype == torch.float32 else None)
    shape = f"{str(q.dtype).removeprefix('torch.')} [{t}, {d}] causal"
    print(f"[{label}] {shape}: kernel {ms:.4f} ms in a graph "
          f"({flops / ms / 1e9:.1f} TFLOP/s); plain {plain_ms:.4f} ms; "
          f"fastest sdpa {backend} {ran[backend]:.4f} ms; bound "
          f"{bound_ms:.4f} ms ({bound_by}); error {ratio:.3f} {of}; max abs "
          f"err {err:.3e}")
    return {"shape": shape, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": ran[backend], "library_backend": backend,
            "max_abs_err": err, "error_share": ratio}


def phase_flash_generic(dev, kind) -> list[dict]:
    """K2w (``csrc/flash_fwd.cu``'s template at any 16-bit input with D ≤
    256, D % 8 = 0) and K2s (``csrc/flash_fwd_generic.cu``) against the
    plain version over the grid, through their own wrappers and through
    ``flash_attention``'s routing, with no CUDA call reaching the plain
    version; the refused head dim; their times beside every SDPA backend at
    ``TIMED``, and K2w's sweep of kv-step keys at DP = 256."""
    from tpu_operator_torch.ops import flash_attention as flash
    plain = flash.attention_plain
    plain_calls = []

    def counted_plain(*a, **kw):
        plain_calls.append(1)
        return plain(*a, **kw)
    counters = {name: getattr(flash, fn) for name, fn in WRAPPERS.items()}
    gen = torch.Generator(device=dev).manual_seed(13)
    worst = {"K2w": 0.0, "K2s": 0.0}
    n_cases = 0
    for dtype in GRID_DTYPES:
        for d in GRID_DIMS:
            for t, (bq, bk) in GRID_T:
                for causal in (True, False):
                    q, k, v = (torch.randn((2, t, d), generator=gen,
                                           device=dev).to(dtype)
                               for _ in range(3))
                    route = flash.kernel_for(dtype, d, t)
                    # each kernel that takes the input, by its own wrapper
                    own = [("K2s", flash.flash_generic)]
                    if route in ("K2", "K2w"):
                        own.append(("K2w", flash.flash_wgmma))
                    before = {n: fn.launches for n, fn in counters.items()}
                    flash.attention_plain = counted_plain
                    try:
                        outs = [(name, fn(q, k, v, causal=causal))
                                for name, fn in own]
                        routed = flash.flash_attention(
                            q, k, v, causal=causal, block_q=bq, block_k=bk)
                    finally:
                        flash.attention_plain = plain
                    want = {n: sum(1 for name, _ in own if name == n)
                            + int(n == route) for n in counters}
                    got = {n: fn.launches - before[n]
                           for n, fn in counters.items()}
                    label = (f"{str(dtype).removeprefix('torch.')} "
                             f"[2, {t}, {d}] causal={causal}")
                    check(got == want, f"{label}: launches {got}, routing "
                                       f"names {route}, expected {want}")
                    shares = []
                    for name, out in outs + [(route, routed)]:
                        check(out.shape == q.shape and out.dtype == dtype,
                              f"{name} {label}: output {tuple(out.shape)} "
                              f"{out.dtype}")
                        ratio, of = flash_within(out, q, k, v, causal)
                        check(math.isfinite(ratio) and ratio <= 1.0,
                              f"{name} {label}: error {ratio:.3f} {of}")
                        if name in worst:
                            worst[name] = max(worst[name], ratio)
                        shares.append(f"{name} {ratio:.3f}")
                    n_cases += 1
                    print(f"[K2w/K2s] {label} blocks {bq or 'default'}: "
                          f"routed to {route}; error "
                          + ", ".join(shares) + f" {of}")
    check(not plain_calls, f"{len(plain_calls)} CUDA calls reached the "
                           "plain version")
    wide = torch.zeros((64, 640), device=dev)
    for fn in (flash.flash_attention, flash.flash_generic):
        try:
            fn(wide, wide, wide)
        except ValueError as exc:
            check("at most 512" in str(exc), f"D=640: {exc}")
        else:
            raise SmokeFailure(f"{fn.__name__} took D=640")
    print(f"[K2w/K2s] {n_cases} cases: within their limits (worst share "
          f"K2w {worst['K2w']:.3f}, K2s {worst['K2s']:.3f}); no CUDA call "
          "reached the plain version; D=640 raises")

    timed = {"K2w": [], "K2s": []}
    sweep = {}
    for dtype, t, d in TIMED:
        q, k, v = (torch.randn((t, d), generator=gen, device=dev).to(dtype)
                   for _ in range(3))
        route = flash.kernel_for(dtype, d, t)
        run = getattr(flash, WRAPPERS[route])
        timed[route].append(time_flash(
            route, lambda: run(q, k, v, causal=True), q, k, v, kind))
        if route == "K2w" and d == 256:
            for block_k in SWEEP_BLOCK_K:
                def launch():
                    return flash._wgmma_launch(q, k, v, d ** -0.5, True,
                                               block_k=block_k)
                ratio, of = flash_within(launch(), q, k, v, True)
                check(ratio <= 1.0, f"K2w block_k {block_k}: error "
                                    f"{ratio:.3f} {of}")
                sweep[block_k] = graph_ms(launch, iters=20)
                print(f"[K2w] kv-step sweep at bf16 [{t}, {d}] causal: "
                      f"{block_k} keys a step: {sweep[block_k]:.4f} ms "
                      f"(error {ratio:.3f} {of})")
        del q, k, v
    kw, ks = timed["K2w"], timed["K2s"]
    return [{"name": "flash_fwd_wgmma", "route": "cuda",
             "source": "tpu_operator_torch/csrc/flash_fwd.cu",
             "replaces": "tpu_operator/ops/flash_attention.py:48",
             **kw[0], "other_shapes": kw[1:], "block_k_sweep": sweep,
             "grid_worst_share": worst["K2w"]},
            {"name": "flash_fwd_generic", "route": "cuda",
             "source": "tpu_operator_torch/csrc/flash_fwd_generic.cu",
             "replaces": "tpu_operator/ops/flash_attention.py:48",
             **ks[0], "other_shapes": ks[1:],
             "grid_worst_share": worst["K2s"]}]


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


# (Dh, T, kernel): K2's head width, K2w's widest bucket and a width only
# K2s takes, each at the full sequence
ULYSSES_SHAPES = ((128, 4096, "K2"), (256, 4096, "K2w"), (384, 4096, "K2s"))


def phase_ulysses() -> None:
    """Ulysses attention on 4 virtual ranks, 8 heads, bf16, causal and not:
    each rank's [2, T, Dh] goes through K2 at Dh = 128, K2w at 256 and K2s
    at 384, once per rank; the result is held to the per-element limit
    against the single-device computation."""
    from tpu_operator_torch.ops import flash_attention as flash
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.numerics import attention_tolerance
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, h = 4, 8
    dev = torch.device("cuda", 0)
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(11)
    counters = {name: getattr(flash, fn) for name, fn in WRAPPERS.items()}
    for d, t, kernel in ULYSSES_SHAPES:
        q, k, v = (torch.randn((t, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(3))
        tol = attention_tolerance(torch.bfloat16, d, "cuda")
        for causal in (True, False):
            shards = [list(x.chunk(n)) for x in (q, k, v)]
            before = {name: fn.launches for name, fn in counters.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = torch.cat(ulysses_attention(*shards, mesh, "model",
                                              causal=causal))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = {name: fn.launches - before[name]
                        for name, fn in counters.items()}
            check(launched == {name: n if name == kernel else 0
                               for name in counters},
                  f"Ulysses Dh={d} causal={causal}: launched {launched} "
                  f"for {n} ranks, expected {kernel} only")
            check(out.shape == (t, h, d) and out.dtype == torch.bfloat16,
                  f"Ulysses output {tuple(out.shape)} {out.dtype}")
            # the single-device computation, heads first
            ref32, limit = flash.kernel_error_limit(
                *(x.permute(1, 0, 2) for x in (q, k, v)), causal=causal)
            got = out.permute(1, 0, 2)
            ratio = limit_ratio(got, ref32, limit)
            err = (got.float() - ref32).abs().max().item()
            check(ratio <= 1.0, f"Ulysses Dh={d} causal={causal}: error "
                                f"{ratio:.3f}x the per-element limit")
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


def phase_ulysses_dense() -> None:
    """Ulysses at Dh = 384 (K2s's width on the main path) beside the same
    call with each rank's attention dense (``attention_plain``, the port's
    path at that width before K2s took it): mean ms a call by CUDA events
    over 5 back-to-back calls after one warm-up, host time included."""
    from tpu_operator_torch.ops import flash_attention as flash
    from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
    from tpu_operator_torch.parallel.ring_attention import ulysses_attention
    n, h, t, d = 4, 8, 4096, 384
    dev = torch.device("cuda", 0)
    mesh = make_mesh(n, MeshPlan(data=1, model=n), device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    shards = [list(torch.randn((t, h, d), generator=gen, device=dev)
                   .to(torch.bfloat16).chunk(n)) for _ in range(3)]
    routed = flash.flash_attention

    def dense(q, k, v, causal=False):
        return flash.attention_plain(q, k, v, causal=causal)
    for causal in (True, False):
        times = {}
        for name, fn in (("K2s", routed), ("dense", dense)):
            flash.flash_attention = fn
            try:
                times[name] = cuda_ms(lambda: ulysses_attention(
                    *shards, mesh, "model", causal=causal), iters=5)
            finally:
                flash.flash_attention = routed
        print(f"[ulysses] n={n} T={t} H={h} Dh={d} bf16 causal={causal}: "
              f"on K2s {times['K2s']:.3f} ms a call, dense (attention_plain "
              f"a rank) {times['dense']:.3f} ms a call")


HEALTH_NODE = "gpu-node-0"
HEALTH_SIZES_MB = (8, 256)   # the probe's default (in L2) and K1's array


def phase_health_monitor() -> None:
    """The node health monitor's CLI as its DaemonSet runs it, once, on
    this machine's ``/dev`` and NVML, with the HBM sweep on K1 at 256 MiB,
    against a fake cluster file: the node must come out healthy, its
    condition ``"True"`` and the health file empty."""
    import contextlib
    import io
    from tpu_operator_torch.cli.health_monitor import main as monitor
    from tpu_operator_torch.health.monitor import NODE_CONDITION_TYPE
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    from tpu_operator_torch.ops import hbm
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.json")
        health_file = os.path.join(tmp, "gpu-health")
        FileBackedFakeClient(state).add_node(HEALTH_NODE, {})
        out = io.StringIO()
        before = hbm.read_sum.launches
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = monitor(["--client", f"fake:{state}",
                          "--node-name", HEALTH_NODE, "--once",
                          "--hbm-sweep", "--hbm-sweep-config",
                          '{"enable": true, "sizeMb": 256}',
                          "--health-file", health_file])
        wall = time.perf_counter() - t0
        launched = hbm.read_sum.launches - before
        line = out.getvalue().strip().splitlines()[-1]
        print(f"[health] --once: {line} (rc {rc}; {wall:.3f} s on the host "
              f"clock; K1 launched {launched} times)")
        check(launched > 0, "the monitor's HBM sweep never launched K1")
        report = json.loads(line)
        check(rc == 0 and report["healthy"] is True,
              f"health monitor --once: rc {rc}, {report}")
        node = FileBackedFakeClient(state).get("Node", HEALTH_NODE)
        conds = [c for c in node.get("status", "conditions", default=[])
                 if c["type"] == NODE_CONDITION_TYPE]
        check(len(conds) == 1 and conds[0]["status"] == "True",
              f"node condition {conds}")
        with open(health_file) as f:
            check(f.read() == "", "health file not empty")


def phase_health_probes() -> None:
    """Each probe called directly, so that a probe that crashes cannot
    pass as "unknown" the way the monitor treats it: presence must report
    a healthy GPU, NVML must load and see a card whose device node is
    there, the HBM sweep must give one healthy result at 8 and at 256 MiB;
    then the device scan and feature discovery's labels."""
    from tpu_operator_torch.deviceplugin.discovery import GpuDiscovery
    from tpu_operator_torch.health.probes import (CounterThresholdProbe,
                                                  DevicePresenceProbe,
                                                  HbmSweepProbe, NvLinkProbe)
    from tpu_operator_torch.kube.fake import FakeClient
    from tpu_operator_torch.ops.hbm import hbm_read_gbps
    from tpu_operator_torch.operands.feature_discovery import (
        PREFIX, FeatureDiscovery)
    from tpu_operator_torch.utils.nvml import COUNTERS, NvmlSource
    nodes = GpuDiscovery().scan()
    opens = {}
    for d in nodes:      # the scan reads permission bits; try the open
        try:
            os.close(os.open(d.path, os.O_RDWR))
            opens[d.id] = "opens"
        except OSError as e:
            opens[d.id] = f"open fails: {e.strerror}"
    print(f"[health] GpuDiscovery().scan(): {nodes}; {opens}")
    presence = DevicePresenceProbe().run()
    print(f"[health] device-presence: {presence}")
    check(any(r.healthy and r.gpu_index is not None for r in presence),
          "presence probe reports no healthy GPU")
    source = NvmlSource()
    check(source.library() is not None, "libnvidia-ml.so.1 does not load")
    t0 = time.perf_counter()
    attrs = source.attributes()
    secs = time.perf_counter() - t0
    print(f"[health] NVML driver {source.driver_version()}: {len(attrs)} "
          f"device(s) in {secs:.3f} s, device nodes {len(nodes)} "
          f"(NVIDIA_VISIBLE_DEVICES={os.environ.get('NVIDIA_VISIBLE_DEVICES')}"
          f"): {json.dumps(attrs)}")
    # NVML sees the cards this container may use; /dev may hold more
    # nodes than that. Each card NVML sees must have its node, under its
    # minor number, healthy to the presence probe, and torch's card must
    # be one of them.
    healthy = {r.gpu_index for r in presence if r.healthy}
    check(attrs and set(attrs) <= healthy,
          f"NVML's cards {sorted(attrs)}, healthy device nodes "
          f"{sorted(healthy)}")
    check(torch.cuda.get_device_name(0) in
          {a["name"] for a in attrs.values()},
          f"NVML does not name {torch.cuda.get_device_name(0)}")
    print(f"[health] nvlink: {NvLinkProbe(source).run()}")
    counters = CounterThresholdProbe({c: 0 for c in COUNTERS}, source)
    print(f"[health] counter-threshold (all at 0): {counters.run()}")
    for size in HEALTH_SIZES_MB:
        results = HbmSweepProbe(size_mb=size).run()
        check(len(results) == 1 and results[0].healthy,
              f"hbm-sweep at {size} MiB: {results}")
        # the probe's own measurement three more times, unrounded
        rates = [hbm_read_gbps(size_mb=size, sweeps=2, iters=2).read_gbps
                 for _ in range(3)]
        print(f"[health] hbm-sweep {size} MiB: {results[0].detail}; "
              f"hbm_read_gbps(sweeps=2, iters=2) x3: {rates} GB/s")
    client = FakeClient()
    client.add_node(HEALTH_NODE, {})
    labels = FeatureDiscovery(client, HEALTH_NODE).apply_once()
    print(f"[health] feature discovery: {json.dumps(labels)}")
    # the count is of the cards present, NVML's (F9), not of the nodes
    check(labels.get(PREFIX + "gpu.present") == "true"
          and labels.get(PREFIX + "gpu.count") == str(len(attrs))
          and labels.get(PREFIX + "cuda.driver") == "true"
          and PREFIX + "gpu.product" in labels,
          f"feature discovery labels {labels}")


AGENT_NODE = "gpu-node-0"


def agent_bins():
    """The node agents' directory, built from the checkout on first use."""
    from tpu_operator_torch.native import build
    return build.build()


def agent(name: str, *args, timeout: float = 120) -> tuple:
    """Run a node agent; (rc, stdout, stderr, host-clock seconds)."""
    t0 = time.perf_counter()
    out = subprocess.run([str(agent_bins() / name), *map(str, args)],
                         capture_output=True, text=True, timeout=timeout)
    return (out.returncode, out.stdout, out.stderr,
            time.perf_counter() - t0)


def nvml_cards() -> dict:
    """{minor number: attributes} of the cards NVML lists, by the port's
    Python binding: the yardstick the agents are held to."""
    from tpu_operator_torch.utils.nvml import NvmlSource
    source = NvmlSource()
    check(source.library() is not None, "libnvidia-ml.so.1 does not load")
    cards = source.attributes()
    check(bool(cards), "NVML lists no card")
    return cards


def machine_libcuda() -> str:
    from tpu_operator_torch.utils.nvml import find_driver_library
    lib = find_driver_library("/", "libcuda.so.1")
    check(lib is not None, "no libcuda.so.1 under the machine's library dirs")
    return lib


def phase_agents_build() -> None:
    """The node agents built by the host C++ compiler from the checkout."""
    from tpu_operator_torch.native import build
    t0 = time.perf_counter()
    built = build.output_dir().exists()
    out = agent_bins()
    print(f"[agents] build: {len(build.TARGETS)} targets -> {out.name} in "
          f"{time.perf_counter() - t0:.3f} s"
          + (" (already built)" if built else "")
          + f"; {build.compiler()} {' '.join(build.CXX_FLAGS)}")


def phase_agents_smoke() -> None:
    """``gpu-smoke --run-add`` on the machine's ``libcuda.so.1``: the PTX
    add JIT-compiled for this card and checked exactly, at the reference's
    n and at 64 MiB a vector; then a library without ``cuInit`` must fail
    it, and the probe mode must pass."""
    lib = machine_libcuda()
    kind = torch.cuda.get_device_name(0)
    for n in (1024, 1 << 24):
        rc, stdout, stderr, secs = agent("gpu-smoke", "--run-add", "--n", n,
                                         "--libcuda", lib)
        out = json.loads(stdout)
        print(f"[agents] gpu-smoke --run-add --n {n}: rc {rc}, ok "
              f"{out['ok']}, {out['device']} cc {out['cc']}, CUDA driver "
              f"API {out['cuda_driver_version']}, ms {json.dumps(out['ms'])}"
              f", {secs:.3f} s on the host clock"
              + (f", error {out.get('error')}: {out.get('detail')}"
                 if not out["ok"] else ""))
        log = out["jit_log"].strip().splitlines()
        print(f"[agents] the JIT took the sm_52 PTX for cc {out['cc']}: "
              f"{'; '.join(log) if log else '(the driver logged nothing)'}")
        check(rc == 0 and out["ok"] and out["n"] == n,
              f"gpu-smoke --run-add --n {n}: rc {rc}, {out}, {stderr}")
        check(out["device"] == kind and out["cc"] == "9.0",
              f"gpu-smoke ran on {out['device']} cc {out['cc']}")
    import ctypes.util
    libc = ctypes.util.find_library("c")
    rc, stdout, _, _ = agent("gpu-smoke", "--run-add", "--libcuda", libc)
    out = json.loads(stdout)
    print(f"[agents] planted: gpu-smoke --run-add --libcuda {libc}: rc {rc}, "
          f"error {out.get('error')}")
    check(rc == 1 and out["error"] == "dlsym(cuInit)",
          f"a library without cuInit passed gpu-smoke: rc {rc}, {out}")
    rc, stdout, _, secs = agent("gpu-smoke", "--libcuda", lib)
    print(f"[agents] gpu-smoke (probe): rc {rc}, {stdout.strip()} "
          f"({secs:.3f} s)")
    check(rc == 0 and json.loads(stdout)["driver_api"], "gpu-smoke probe")


def metric_lines(page: str, family: str) -> list[str]:
    return [ln for ln in page.splitlines()
            if ln.startswith(family + "{") or ln.startswith(family + " ")]


def phase_agents_metrics() -> None:
    """``gpu-metrics-agent --once`` on the machine's ``/dev`` and NVML:
    every card NVML lists appears under its minor number with its name
    and NVML's attributes; a node NVML does not list reads present 0 (F7).
    Then the agent serves HTTP and the metrics exporter scrapes it."""
    from tpu_operator_torch.operands.metrics_exporter import MetricsExporter
    cards = nvml_cards()
    rc, page, stderr, secs = agent("gpu-metrics-agent", "--once")
    present = metric_lines(page, "gpu_agent_device_present")
    print(f"[agents] gpu-metrics-agent --once: rc {rc} in {secs:.3f} s on "
          f"the host clock; {present}; "
          f"{metric_lines(page, 'gpu_agent_devices_total')}; "
          f"{metric_lines(page, 'gpu_agent_driver_info')}")
    check(rc == 0, f"gpu-metrics-agent --once: rc {rc}, {stderr}")
    for minor, attrs in cards.items():
        want = (f'gpu_agent_device_present{{device="/dev/nvidia{minor}",'
                f'name="{attrs["name"]}"}} 1')
        check(want in present, f"{want} not in {present}")
        for attr, value in attrs.items():
            if attr not in ("name", "nvlink_down"):
                line = (f'gpu_agent_device_attr{{device="nvidia{minor}",'
                        f'attr="{attr}"}} {value}')
                check(line in page, f"{line} not on the page")
    others = [ln for ln in present
              if not any(f'"/dev/nvidia{m}"' in ln for m in cards)]
    check(all(ln.endswith("} 0") for ln in others),
          f"nodes NVML does not list read present: {others}")
    check(f"gpu_agent_devices_total {len(cards)}" in page,
          "devices_total is not NVML's count")
    check("gpu_agent_driver_loadable 1" in page, "libcuda not loadable")

    proc = subprocess.Popen([str(agent_bins() / "gpu-metrics-agent"),
                             "--port", "0"], stdout=subprocess.PIPE,
                            text=True)
    try:
        port = int(proc.stdout.readline().rsplit(":", 1)[1])
        kind = torch.cuda.get_device_name(0)
        exporter = MetricsExporter(f"127.0.0.1:{port}", node_name=AGENT_NODE,
                                   accelerator=kind)
        t0 = time.perf_counter()
        ok = exporter.scrape_once()
        secs = time.perf_counter() - t0
        out = exporter.render()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    relabeled = [ln for ln in out.splitlines()
                 if ln.startswith("gpu_agent_")]
    stamp = f'node="{AGENT_NODE}",accelerator="{kind}"'
    print(f"[agents] exporter scrape of the served agent: {ok} in "
          f"{secs:.4f} s on the host clock, "
          f"{metric_lines(out, 'gpu_exporter_last_scrape_duration_seconds')}"
          f"; {len(relabeled)} relabeled samples, e.g. {relabeled[:2]}")
    check(ok and "gpu_exporter_up 1" in out, "gpu_exporter_up is not 1")
    check(relabeled and all(stamp in ln for ln in relabeled),
          f"samples without node/accelerator labels: {relabeled}")


def phase_agents_node() -> None:
    """``gpu-node-agent cdi-generate`` and ``probe`` on the machine, then
    ``driver-install`` of the machine's driver library into temporary
    install and validations directories; then ``gpu-oci-hook inject`` of
    NVML's card into a temporary bundle. Nothing is written outside the
    temporaries, and no device setting is touched."""
    from tpu_operator_torch.utils.nvml import NvmlSource
    cards = nvml_cards()
    uuids = NvmlSource().uuids()
    lib = machine_libcuda()
    real = os.path.realpath(lib)
    rc, stdout, stderr, secs = agent("gpu-node-agent", "cdi-generate")
    spec = json.loads(stdout)
    names = [d["name"] for d in spec["devices"]]
    edits = spec["containerEdits"]
    print(f"[agents] gpu-node-agent cdi-generate: rc {rc} in {secs:.3f} s; "
          f"devices {names}; control nodes "
          f"{[n['path'] for n in edits.get('deviceNodes', [])]}; mounts "
          f"{[m['hostPath'] for m in edits.get('mounts', [])]}")
    # each card by its minor number and by its NVML UUID (F10)
    check(rc == 0 and names == [n for m in sorted(cards)
                                for n in (str(m), uuids[m])] + ["all"],
          f"CDI devices {names}, NVML's cards {uuids}")
    check(edits["mounts"][0]["hostPath"] == lib, "CDI mount of libcuda")
    rc, stdout, _, _ = agent("gpu-node-agent", "probe")
    print(f"[agents] gpu-node-agent probe: rc {rc}, {stdout.strip()}")
    probe = json.loads(stdout)
    check(rc == 0 and probe["devices"] == len(cards) and probe["loadable"],
          f"probe {probe}")

    from tpu_operator_torch.validator.driver_build import extract_build
    with tempfile.TemporaryDirectory() as tmp:
        img, host, vdir = (os.path.join(tmp, d)
                           for d in ("img", "host", "validations"))
        os.mkdir(img)
        # the image's layout: the versioned file and the soname's link
        shutil.copy(real, os.path.join(img, os.path.basename(real)))
        os.symlink(os.path.basename(real), os.path.join(img, "libcuda.so.1"))
        rc, stdout, stderr, secs = agent(
            "gpu-node-agent", "driver-install", "--source", img,
            "--install-dir", host, "--validations-dir", vdir, "--oneshot")
        with open(os.path.join(vdir, "driver-ready")) as f:
            status = json.load(f)
        staged = os.path.join(host, "libcuda.so.1")
        print(f"[agents] gpu-node-agent driver-install of {real} "
              f"({os.path.getsize(real)} bytes): rc {rc} in {secs:.3f} s; "
              f"{stdout.strip()}; status {status['info']}; staged version "
              f"{extract_build(staged)} (the machine's {extract_build(lib)})")
        check(rc == 0 and status["ok"] and status["component"] == "driver",
              f"driver-install: rc {rc}, {stderr}")
        check(os.readlink(staged) == os.path.basename(real)
              and extract_build(staged) == extract_build(lib),
              "the staged library is not the machine's")

        minor = min(cards)
        bundle = os.path.join(tmp, "bundle")
        os.mkdir(bundle)
        with open(os.path.join(bundle, "config.json"), "w") as f:
            json.dump({"ociVersion": "1.0.2", "process": {
                "args": ["nvidia-smi"], "cwd": "/",
                "env": [f"NVIDIA_VISIBLE_DEVICES={minor}"]},
                "linux": {"resources": {}}}, f)
        rc, _, stderr, secs = agent("gpu-oci-hook", "inject", "--bundle",
                                    bundle)
        with open(os.path.join(bundle, "config.json")) as f:
            config = json.load(f)
    devices = config["linux"]["devices"]
    print(f"[agents] gpu-oci-hook inject NVIDIA_VISIBLE_DEVICES={minor}: "
          f"rc {rc} in {secs:.3f} s; "
          f"{[(d['path'], d['major'], d['minor']) for d in devices]}; mounts "
          f"{[m['source'] for m in config.get('mounts', [])]}")
    check(rc == 0, f"gpu-oci-hook inject: rc {rc}, {stderr}")
    card = f"/dev/nvidia{minor}"
    for d in devices:
        st = os.stat(d["path"])
        check((d["major"], d["minor"]) == (os.major(st.st_rdev),
                                           os.minor(st.st_rdev)),
              f"{d['path']}: injected {d['major']}:{d['minor']}, the node "
              f"is {os.major(st.st_rdev)}:{os.minor(st.st_rdev)}")
    injected = [d["path"] for d in devices
                if re.fullmatch(r"/dev/nvidia\d+", d["path"])]
    check(injected == [card], f"cards injected: {injected}")


# -- operator states: the slice manager, the state pipeline, the validator
# it renders ---------------------------------------------------------------

STATES_NODE = "gpu-node-0"
STATES_NS = "gpu-operator"
SLICE_PROFILES = """version: v1alpha1
profiles:
  full: {partitions: 1}
  per-gpu: {partitions: per-gpu}
  nvlink-pairs: {gpusPerPartition: 2}
"""
OPERAND_IMAGES = ("DRIVER_IMAGE", "CONTAINER_TOOLKIT_IMAGE",
                  "DEVICE_PLUGIN_IMAGE", "FEATURE_DISCOVERY_IMAGE",
                  "SLICE_MANAGER_IMAGE", "METRICS_AGENT_IMAGE",
                  "METRICS_EXPORTER_IMAGE", "VALIDATOR_IMAGE")
#: what the pipeline's phase hands the validator's phase
STATES_RUN: dict = {}


def nvml_header_p2p_nvlink() -> str:
    """``NVML_P2P_CAPS_INDEX_NVLINK`` as the toolkit's ``nvml.h`` spells
    it, against the value the port declares by hand."""
    from tpu_operator_torch.utils.nvml import NVML_P2P_CAPS_INDEX_NVLINK
    header = "/usr/local/cuda/include/nvml.h"
    if not os.path.exists(header):
        return f"{header} not found"
    m = re.search(r"NVML_P2P_CAPS_INDEX_NVLINK\s*=\s*(\d+)",
                  open(header, errors="replace").read())
    check(m is not None and int(m.group(1)) == NVML_P2P_CAPS_INDEX_NVLINK,
          f"nvml.h's NVML_P2P_CAPS_INDEX_NVLINK is "
          f"{m.group(1) if m else 'absent'}, the port's "
          f"{NVML_P2P_CAPS_INDEX_NVLINK}")
    return f"{header}: NVML_P2P_CAPS_INDEX_NVLINK = {m.group(1)}"


def phase_states_slices() -> None:
    """``gpu-slice-manager --once`` on this machine's ``/dev`` and NVML,
    against a fake cluster file, with its plan and state in a temporary
    directory: ``full`` must make one group of exactly the cards NVML lists
    (never a foreign ``/dev/nvidia0``), ``nvlink-pairs`` on one card must
    fail with rc 1, ``per-gpu`` must make one group a card, and the
    slice-aware device plugin view must advertise the plan's group as one
    healthy unit. No device setting is changed."""
    from tpu_operator_torch.deviceplugin.discovery import (
        HEALTHY, GpuDiscovery, SliceAwareDiscovery)
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    from tpu_operator_torch.operands.slice_manager import CONFIG_LABEL
    from tpu_operator_torch.utils.nvml import NvmlSource
    print(f"[states] {nvml_header_p2p_nvlink()}")
    nvml = NvmlSource()
    peers = nvml.nvlink_peers()
    check(peers is not None, "libnvidia-ml.so.1 does not load")
    own = sorted(f"/dev/nvidia{m}" for m in peers)
    print(f"[states] NVML's NVLink peer map: "
          f"{ {m: sorted(p) for m, p in peers.items()} }; the container's "
          f"cards {own}")
    with tempfile.TemporaryDirectory() as tmp:
        state = os.path.join(tmp, "state.json")
        plan_file = os.path.join(tmp, "slice-partitions.json")
        with open(os.path.join(tmp, "config.yaml"), "w") as f:
            f.write(SLICE_PROFILES)
        FileBackedFakeClient(state).add_node(STATES_NODE, {})
        env = dict(os.environ,
                   SLICE_CONFIG_FILE=os.path.join(tmp, "config.yaml"),
                   SLICE_STATE_DIR=os.path.join(tmp, "slice-manager"),
                   SLICE_PARTITIONS_FILE=plan_file,
                   GPU_HEALTH_FILE=os.path.join(tmp, "gpu-health"))

        def once(profile):
            client = FileBackedFakeClient(state)
            node = client.get("Node", STATES_NODE)
            node.labels[CONFIG_LABEL] = profile
            client.update(node)
            t0 = time.perf_counter()
            out = subprocess.run(
                [sys.executable, "-m", "tpu_operator_torch.cli.slice_manager",
                 "--once", "--client", f"fake:{state}",
                 "--node-name", STATES_NODE], capture_output=True,
                text=True, env=env, timeout=120)
            wall = time.perf_counter() - t0
            plan = None
            if os.path.exists(plan_file):
                with open(plan_file) as f:
                    plan = json.load(f)
            print(f"[states] slice manager {profile}: rc {out.returncode}, "
                  f"{out.stdout.strip()}"
                  + (f", plan {plan['partitions']}" if out.returncode == 0
                     else "") + f" ({wall:.3f} s on the host clock)")
            return out.returncode, json.loads(out.stdout), plan

        rc, line, plan = once("full")
        check(rc == 0 and line["state"] == "success", f"full: {line}")
        check(plan["partitions"] == [own], f"full: {plan['partitions']}")
        check(all(p in own for g in plan["partitions"] for p in g),
              "a card NVML does not list entered the plan")
        units = [u for u in SliceAwareDiscovery(
            GpuDiscovery(), plan_file).scan() if u.health == HEALTHY]
        print(f"[states] slice-aware units: "
              f"{[(u.id, list(u.member_paths)) for u in units]}")
        check(len(units) == 1 and list(units[0].member_paths) == own,
              f"slice-aware view of full: {units}")
        if len(own) % 2:
            rc, line, _ = once("nvlink-pairs")
            check(rc == 1 and line["state"] == "failed",
                  f"nvlink-pairs on {len(own)} card(s): rc {rc}, {line}")
        rc, line, plan = once("per-gpu")
        check(rc == 0 and plan["partitions"] == [[p] for p in own],
              f"per-gpu: rc {rc}, {plan}")


def phase_states_pipeline() -> None:
    """The state pipeline over a fake cluster holding this node, labelled
    by the port's feature discovery run on this card plus NFD's PCI vendor
    label, and a CPU node: the default ``GPUClusterPolicy`` with images
    from the environment, ``init`` and the DAG walk, then a second pass
    that must write nothing."""
    from tpu_operator_torch.api.v1alpha1 import GPUClusterPolicy, State
    from tpu_operator_torch.controllers.state_manager import (
        NFD_PCI_LABEL, StateManager)
    from tpu_operator_torch.kube import FakeClient, Obj
    from tpu_operator_torch.operands.feature_discovery import \
        FeatureDiscovery
    client = FakeClient(auto_ready=True)
    client.add_node(STATES_NODE, {})
    labels = FeatureDiscovery(client, node_name=STATES_NODE).apply_once()
    for key in ("nvidia.com/gpu.product", "nvidia.com/gpu.count",
                "nvidia.com/cuda.driver"):
        check(key in labels, f"feature discovery gave no {key}: {labels}")
    from tpu_operator_torch.utils.nvml import NvmlSource
    cards = NvmlSource().minor_numbers()
    check(labels["nvidia.com/gpu.count"] == str(len(cards)),
          f"gpu.count {labels['nvidia.com/gpu.count']}, NVML's cards "
          f"{sorted(cards)}")
    node = client.get("Node", STATES_NODE)
    node.labels[NFD_PCI_LABEL] = "true"
    client.update(node)
    client.add_node("cpu-node-0", {})
    print(f"[states] node labels from feature discovery: {labels}")
    saved = {k: os.environ.get(k) for k in OPERAND_IMAGES}
    os.environ.update({k: f"registry.local/gpu-operator/"
                          f"{k[:-6].lower().replace('_', '-')}:smoke"
                       for k in OPERAND_IMAGES})
    try:
        cr = client.create(Obj({
            "apiVersion": "nvidia.com/v1alpha1", "kind": "GPUClusterPolicy",
            "metadata": {"name": "gpu-cluster-policy"}, "spec": {}}))
        sm = StateManager(client, STATES_NS)
        t0 = time.perf_counter()
        sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
        statuses = sm.run_all()
        first_ms = (time.perf_counter() - t0) * 1e3
        kinds: dict = {}
        for kind in ("DaemonSet", "Deployment", "Service", "ServiceMonitor",
                     "ConfigMap", "ServiceAccount", "Role", "RoleBinding",
                     "ClusterRole", "ClusterRoleBinding", "RuntimeClass",
                     "PriorityClass", "PrometheusRule"):
            n = len(client.list(kind))
            if n:
                kinds[kind] = n
        print(f"[states] pass 1: {json.dumps(statuses, sort_keys=True)}")
        print(f"[states] pass 1: objects {kinds}; {first_ms:.3f} ms on the "
              f"host clock (labels, compile, apply; DAG walk "
              f"{sm.last_dag_wall_s * 1e3:.3f} ms, peak "
              f"{sm.last_concurrency} states in flight)")
        client.actions.clear()
        t0 = time.perf_counter()
        sm.init(GPUClusterPolicy.from_obj(cr.raw), cr)
        sm.run_all()
        second_ms = (time.perf_counter() - t0) * 1e3
        writes = [a for a in client.actions
                  if a[0] in ("create", "update", "patch", "delete")]
        print(f"[states] pass 2: {len(writes)} writes; {second_ms:.3f} ms "
              f"on the host clock ({sm.last_compile_hits} compiles served "
              f"from the cache)")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(writes == [], f"the converged pass wrote {writes}")
    opt_in = ("state-node-status-exporter", "state-relay-service")
    for name, status in statuses.items():
        want = State.DISABLED if name in opt_in else State.READY
        check(status == want, f"{name}: {status}, not {want}")
    cpu = client.get("Node", "cpu-node-0").labels
    check(not any(k.startswith("nvidia.com/gpu.deploy.") for k in cpu),
          f"the CPU node carries deploy labels: {cpu}")
    STATES_RUN["client"] = client


def phase_states_validator() -> None:
    """The ``workload-validation`` init container of the DaemonSet the
    pipeline rendered, run as a node would run it (``run_rendered_workload``).
    K1 and K2 must launch."""
    run_rendered_workload(STATES_RUN.pop("client"), "[states]")


def run_rendered_workload(client, tag: str, validator=None) -> None:
    """The ``workload-validation`` init container of the validator
    DaemonSet in ``client``: its command through ``validator`` (the port's
    validator CLI's ``main`` unless the caller resolved it through the
    container's image) in this process, with its environment and its
    hostPaths mapped into a temporary directory (the device tree stays the
    machine's; the install dir holds the machine's ``libcuda.so.1``, as the
    driver installer leaves it). It must pass on the card."""
    import contextlib
    import io
    if validator is None:
        from tpu_operator_torch.cli.validator import main as validator
    ds = client.get("DaemonSet", "gpu-operator-validator", STATES_NS)
    spec = ds.get("spec", "template", "spec")
    [c] = [c for c in spec["initContainers"]
           if c["name"] == "workload-validation"]
    check(c["command"] == ["gpu-validator", "--component", "workload"],
          f"workload container command {c['command']}")
    volumes = {v["name"]: v for v in spec["volumes"]}
    with tempfile.TemporaryDirectory() as tmp:
        moved = {}
        for m in c["volumeMounts"]:
            if "/dev" in (m["mountPath"], volumes[m["name"]]
                          .get("hostPath", {}).get("path")):
                continue
            moved[m["mountPath"]] = os.path.join(tmp, m["name"])
            os.makedirs(moved[m["mountPath"]], exist_ok=True)

        def mapped(value):
            for mount, local in moved.items():
                if value == mount or value.startswith(mount + "/"):
                    return local + value[len(mount):]
            return value

        env = {}
        for e in c.get("env", []):
            if "value" in e:
                env[e["name"]] = mapped(e["value"])
            elif e["valueFrom"]["fieldRef"]["fieldPath"] == "spec.nodeName":
                env[e["name"]] = STATES_NODE
        os.symlink(machine_libcuda(),
                   os.path.join(env["DRIVER_INSTALL_DIR"], "libcuda.so.1"))
        vdir = mapped(next(m["mountPath"] for m in c["volumeMounts"]
                           if m["name"] == "validations"))
        print(f"{tag} workload container env: "
              f"{json.dumps(env, sort_keys=True)}")
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        out = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(out):
                rc = validator(c["command"][1:] + ["--validations-dir", vdir])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        wall = time.perf_counter() - t0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(f"{tag} rendered workload validation: rc {rc}, ok "
              f"{line['ok']}, platform {line['info']['platform']} "
              f"({wall:.3f} s on the host clock)")
        check(rc == 0 and line["ok"] is True,
              f"rendered workload validation: rc {rc}, {line}")
        info = line["info"]
        check(info["hbm_backend"] == "cuda" and info["platform"] == "cuda",
              f"the rendered validator ran off the card: {info}")
        check(os.path.exists(os.path.join(vdir, "workload-ready")),
              "no workload status file")


# -- the operator: its CLI drives the node to ready, the workload it renders
# runs on the card, the OCI hook injects the card by its NVML UUID ---------

#: what the operator's phases hand each other
OPERATOR_RUN: dict = {}
SAMPLE_CR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tpu_operator_torch", "config", "samples",
                         "v1alpha1_gpuclusterpolicy.yaml")


def resource_versions(path: str) -> dict:
    """{object key: resourceVersion} of a file-backed fake cluster."""
    with open(path) as f:
        doc = json.load(f)
    return {"/".join(str(p) for p in e["key"]):
            e["raw"]["metadata"].get("resourceVersion")
            for e in doc["objects"]}


def phase_operator_cli() -> None:
    """``tpu_operator_torch.cli.operator.main`` with ``--client fake:<file>
    --once --no-retry``, pass after pass, on a file-backed fake cluster of
    this node (labelled by the port's feature discovery run on this card
    plus NFD's PCI vendor label), a CPU node and the sample
    ``GPUClusterPolicy``; between passes this script plays kubelet and
    marks the rendered DaemonSets ready. The CLI must reach ready (rc 0)
    within 10 passes; then three more passes must move no object's
    resourceVersion."""
    operator_to_ready("[operator]", OPERATOR_RUN)


def operator_to_ready(tag: str, run: dict, spec=None) -> dict:
    """``phase_operator_cli``'s passes under ``tag``, its temporary
    directory and cluster file in ``run``; ``spec(tmp)``, when given, is
    merged into the sample policy's spec. Returns the last pass's JSON."""
    import contextlib
    import io
    import yaml
    from tpu_operator_torch.cli import operator as cli
    from tpu_operator_torch.controllers.state_manager import NFD_PCI_LABEL
    from tpu_operator_torch.kube import Obj
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    from tpu_operator_torch.operands.feature_discovery import \
        FeatureDiscovery
    tmp = tempfile.mkdtemp(prefix="gpu-operator-")
    run["tmp"] = tmp
    path = os.path.join(tmp, "cluster.json")
    client = FileBackedFakeClient(path)
    client.add_node(STATES_NODE, {})
    labels = FeatureDiscovery(client, node_name=STATES_NODE).apply_once()
    node = client.get("Node", STATES_NODE)
    node.labels[NFD_PCI_LABEL] = "true"
    client.update(node)
    client.add_node("cpu-node-0", {})
    with open(SAMPLE_CR) as f:
        raw = yaml.safe_load(f)
    extra = spec(tmp) if spec is not None else {}
    raw["spec"].update(extra)
    cr = client.create(Obj(raw))
    print(f"{tag} cluster {path}: {STATES_NODE} labelled {labels} and "
          f"{NFD_PCI_LABEL}; cpu-node-0; {cr.kind} {cr.name} "
          f"(config/samples{''.join(f', spec.{k}' for k in extra)})")

    metrics = []
    real_metrics = cli.OperatorMetrics

    class Recorded(real_metrics):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            metrics.append(self)

    def once():
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--client", f"fake:{path}", "--once",
                           "--no-retry"])
        return rc, json.loads(out.getvalue()), (time.perf_counter() - t0) * 1e3

    saved = {k: os.environ.get(k) for k in cli.IMAGE_ENVS}
    cli.OperatorMetrics = Recorded
    try:
        passes = []
        for _ in range(10):
            rc, res, ms = once()
            passes.append(ms)
            print(f"{tag} pass {len(passes)}: rc {rc}, ready "
                  f"{res['ready']}, {res['message']!r}, requeue "
                  f"{res['requeueAfter']} s; {ms:.3f} ms on the host clock")
            if rc == 0:
                break
            FileBackedFakeClient(path).mark_daemonsets_ready()
        check(rc == 0 and res["ready"],
              f"the operator did not reach ready in {len(passes)} passes")
        status = FileBackedFakeClient(path).get(cr.kind, cr.name).raw[
            "status"]
        gauge = metrics[-1].reconciliation_status.get()
        print(f"{tag} ready after {len(passes)} passes "
              f"({', '.join(f'{ms:.3f}' for ms in passes)} ms); CR "
              f"status.state {status['state']!r}; "
              f"gpu_operator_reconciliation_status {gauge}; states "
              f"{json.dumps(res['states'], sort_keys=True)}")
        check(status["state"] == "ready" and gauge == 1,
              f"CR state {status['state']}, gauge {gauge}")
        before = resource_versions(path)
        converged = []
        for _ in range(3):
            rc, res, ms = once()
            converged.append(ms)
            check(rc == 0 and res["ready"], f"converged pass: rc {rc}")
        after = resource_versions(path)
        moved = sorted(k for k in set(before) | set(after)
                       if before.get(k) != after.get(k))
        print(f"{tag} 3 converged passes: "
              f"{', '.join(f'{ms:.3f}' for ms in converged)} ms on the host "
              f"clock; {len(moved)} objects' resourceVersion moved of "
              f"{len(after)}")
        check(moved == [], f"converged passes wrote {moved}")
    finally:
        cli.OperatorMetrics = real_metrics
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run["path"] = path
    return res


def phase_operator_validator() -> None:
    """The ``workload-validation`` container of the validator DaemonSet the
    operator rendered in this path's cluster, run on the card
    (``run_rendered_workload``). K1 and K2 must launch."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    try:
        run_rendered_workload(FileBackedFakeClient(OPERATOR_RUN["path"]),
                              "[operator]")
    finally:
        shutil.rmtree(OPERATOR_RUN.pop("tmp"), ignore_errors=True)


def phase_operator_oci_hook() -> None:
    """F10 on the card: the device plugin names this card by its NVML UUID
    where NVML loads, so ``gpu-oci-hook`` must inject, for
    ``NVIDIA_VISIBLE_DEVICES=<UUID>``, the same card node it injects for
    the card's minor number."""
    from tpu_operator_torch.utils.nvml import NvmlSource
    uuids = NvmlSource().uuids()
    check(bool(uuids), f"NVML's UUIDs: {uuids}")
    props = torch.cuda.get_device_properties(0)
    torch_uuid = str(getattr(props, "uuid", ""))
    print(f"[operator] NVML's UUIDs by minor number: {uuids}; torch's card "
          f"{torch_uuid or 'not reported'}")
    minor = min(uuids)
    check(not torch_uuid
          or uuids[minor].lower() == f"gpu-{torch_uuid.lower()}",
          "NVML's UUID is not the card torch runs on")
    injected = {}
    with tempfile.TemporaryDirectory() as tmp:
        for value in (str(minor), uuids[minor]):
            bundle = os.path.join(tmp, f"bundle-{len(injected)}")
            os.mkdir(bundle)
            with open(os.path.join(bundle, "config.json"), "w") as f:
                json.dump({"ociVersion": "1.0.2", "process": {
                    "args": ["nvidia-smi"], "cwd": "/",
                    "env": [f"NVIDIA_VISIBLE_DEVICES={value}"]},
                    "linux": {"resources": {}}}, f)
            rc, _, stderr, secs = agent("gpu-oci-hook", "inject", "--bundle",
                                        bundle)
            check(rc == 0, f"gpu-oci-hook NVIDIA_VISIBLE_DEVICES={value}: "
                           f"rc {rc}, {stderr}")
            with open(os.path.join(bundle, "config.json")) as f:
                devices = json.load(f)["linux"]["devices"]
            injected[value] = [(d["path"], d["major"], d["minor"])
                               for d in devices
                               if re.fullmatch(r"/dev/nvidia\d+", d["path"])]
            print(f"[operator] gpu-oci-hook inject "
                  f"NVIDIA_VISIBLE_DEVICES={value}: rc {rc} in {secs:.3f} s;"
                  f" cards {injected[value]}")
    card = f"/dev/nvidia{minor}"
    check([p for p, *_ in injected[uuids[minor]]] == [card]
          and injected[uuids[minor]] == injected[str(minor)],
          f"by UUID {injected[uuids[minor]]}, by minor {injected[str(minor)]}")



# -- the operator over the wire: the port's apiserver as its own process, the
# operator's serving loop with leader election against it over TLS, this
# script playing kubelet -----------------------------------------------------

#: the Lease's length for the serving loop (the standby retries every 5 s)
WIRE_LEASE_S = 4
WIRE_POLICY = "gpu-cluster-policy"


class Child:
    """A process of this path whose stderr is drained continuously (a full
    pipe would stall it) into ``lines``."""

    def __init__(self, name: str, args: list, env: dict, stdout=None):
        self.name = name
        self.proc = subprocess.Popen(
            args, env=env, text=True, cwd=os.path.dirname(
                os.path.abspath(__file__)),
            stdout=stdout or subprocess.DEVNULL, stderr=subprocess.PIPE)
        self.lines: list = []
        self.drain = threading.Thread(target=self._drain, daemon=True)
        self.drain.start()

    def _drain(self):
        for line in self.proc.stderr:
            self.lines.append(line)

    def tail(self, n: int = 20) -> str:
        return "".join(self.lines[-n:])

    def logged(self, pattern: str, timeout: float):
        """The first match of ``pattern`` in its log, waiting up to
        ``timeout`` seconds while the process lives."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            for line in list(self.lines):
                m = re.search(pattern, line)
                if m:
                    return m
            check(self.proc.poll() is None,
                  f"{self.name} exited rc {self.proc.returncode}: "
                  f"{self.tail()}")
            time.sleep(0.05)
        raise SmokeFailure(f"{self.name} never logged {pattern!r}: "
                           f"{self.tail()}")

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(timeout=10)


def prom_samples(url: str, token: str | None = None,
                 ca: str | None = None) -> dict:
    """{sample's name and labels: value} of a Prometheus page."""
    import ssl
    import urllib.request
    req = urllib.request.Request(
        url, headers={"Authorization": f"Bearer {token}"} if token else {})
    ctx = ssl.create_default_context(cafile=ca) if ca else None
    with urllib.request.urlopen(req, timeout=10, context=ctx) as resp:
        text = resp.read().decode()
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, value = line.rpartition(" ")
            out[key] = float(value)
    return out


def prom_total(samples: dict, family: str, **where) -> float:
    """The sum of ``family``'s samples whose labels match ``where`` (a
    value may be a tuple of allowed values, or a callable)."""
    total = 0.0
    for key, value in samples.items():
        name, _, rest = key.partition("{")
        if name != family:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', rest))
        ok = True
        for k, want in where.items():
            got = labels.get(k)
            ok &= want(got) if callable(want) else (
                got in want if isinstance(want, tuple) else got == want)
        if ok:
            total += value
    return total


def wire_versions(client) -> dict:
    """{kind/namespace/name: resourceVersion} of every object the wire
    apiserver holds."""
    from tpu_operator_torch.kube.objects import REGISTRY
    out = {}
    for kind in REGISTRY:
        for o in client.list(kind):
            out[f"{kind}/{o.namespace or ''}/{o.name}"] = o.resource_version
    return out


def mark_rollouts_done(client) -> int:
    """Kubelet's part, over the wire: every DaemonSet of the operator's
    namespace whose pods are not all ready gets a status saying they are,
    written through the status subresource as a DaemonSet controller writes
    it (so the operator's watch and cache see it; the apiserver's
    ``/_kubelet/mark-ready`` changes the store behind the watch). Returns
    the number written."""
    done = 0
    for ds in client.list("DaemonSet", STATES_NS):
        st = ds.raw.get("status") or {}
        n = st.get("desiredNumberScheduled", 0)
        if (st.get("numberReady"), st.get("numberUnavailable", 0),
                st.get("updatedNumberScheduled")) != (n, 0, n):
            client.patch("DaemonSet", ds.name, STATES_NS, {"status": {
                "numberReady": n, "numberUnavailable": 0,
                "updatedNumberScheduled": n}}, subresource="status")
            done += 1
    return done


def policy_state(client):
    return client.get("GPUClusterPolicy", WIRE_POLICY).raw.get(
        "status", {}).get("state")


def wait_for(what: str, predicate, timeout: float, every: float = 0.1):
    """Seconds until ``predicate()`` held (on the host clock)."""
    t0 = time.monotonic()
    while not predicate():
        check(time.monotonic() - t0 < timeout,
              f"timed out after {timeout} s waiting for {what}")
        time.sleep(every)
    return time.monotonic() - t0


def start_apiserver(env: dict, children: list) -> tuple:
    """The port's wire apiserver (``python -m tpu_operator_torch.kube.
    apiserver``) as its own process over TLS, appended to ``children``.
    Returns its connection (``host``, ``token``, ``ca``) and a client."""
    from tpu_operator_torch.kube.incluster import InClusterClient
    api = Child("apiserver", [sys.executable, "-m",
                              "tpu_operator_torch.kube.apiserver"],
                env, stdout=subprocess.PIPE)
    children.append(api)
    conn = json.loads(api.proc.stdout.readline() or "null") or {}
    check(conn.get("host", "").startswith("https://127.0.0.1:"),
          f"the apiserver did not start: {conn} {api.tail()}")
    return conn, InClusterClient(host=conn["host"], token=conn["token"],
                                 ca_file=conn["ca"], timeout=30)


def exists(client, kind: str, name: str, ns: str | None = None) -> bool:
    from tpu_operator_torch.kube.client import NotFoundError
    try:
        client.get(kind, name, ns)
        return True
    except NotFoundError:
        return False


def ready_after_marks(client) -> bool:
    """Kubelet's part: mark the rendered rollouts done, then read whether
    the policy is ready."""
    mark_rollouts_done(client)
    return policy_state(client) == "ready"


def phase_wire_serve() -> None:
    """The operator's production serving loop over TLS: the port's wire
    apiserver (``python -m tpu_operator_torch.kube.apiserver``) as its own
    process, seeded over the wire with this node (labelled by the port's
    feature discovery run on this card against the server, plus NFD's PCI
    label), a CPU node and the sample ``GPUClusterPolicy``; then
    ``cli.operator --leader-elect --metrics-port 0`` as a process. This
    script plays kubelet: when the validator DaemonSet appears it runs its
    ``workload`` container on the card (K1 and K2 must launch), and only
    then marks the rendered DaemonSets ready over the wire. The policy
    must reach ready and the Lease have a holder; a second instance stands
    by; disabling the metrics exporter must delete its DaemonSet in under
    20 s (the ready requeue is 60 s: only the watch wake explains it);
    after the leader is SIGKILLed the standby must take the Lease and its
    passes move no object's resourceVersion but the Lease's; after SIGINT
    it exits 0."""
    import yaml
    from tpu_operator_torch.controllers.state_manager import NFD_PCI_LABEL
    from tpu_operator_torch.kube import Obj
    from tpu_operator_torch.operands.feature_discovery import \
        FeatureDiscovery
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, GPU_OPERATOR_LEASE_SECONDS=str(WIRE_LEASE_S),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    children: list = []
    try:
        t0 = time.monotonic()
        conn, client = start_apiserver(env, children)
        start_s = time.monotonic() - t0
        version = client.server_version()
        print(f"[wire] apiserver {conn['host']} over TLS up in "
              f"{start_s:.3f} s; /version {version['gitVersion']}")

        def node(name):
            return Obj({"apiVersion": "v1", "kind": "Node",
                        "metadata": {"name": name, "labels": {}},
                        "status": {"nodeInfo": {
                            "containerRuntimeVersion": "containerd://1.7.0",
                            "kubeletVersion": "v1.29.0"},
                            "capacity": {}, "allocatable": {}}})
        client.create(node(STATES_NODE))
        labels = FeatureDiscovery(client, node_name=STATES_NODE).apply_once()
        n = client.get("Node", STATES_NODE)
        n.labels[NFD_PCI_LABEL] = "true"
        client.update(n)
        client.create(node("cpu-node-0"))
        with open(SAMPLE_CR) as f:
            cr = yaml.safe_load(f)
        check(cr["metadata"]["name"] == WIRE_POLICY, "the sample's name")
        t_cr = time.monotonic()
        client.create(Obj(cr))
        print(f"[wire] seeded over the wire: {STATES_NODE} labelled "
              f"{labels} and {NFD_PCI_LABEL}; cpu-node-0; GPUClusterPolicy "
              f"{WIRE_POLICY} (config/samples)")

        env.update(KUBE_TOKEN=conn["token"], KUBE_CA_FILE=conn["ca"])
        args = [sys.executable, "-m", "tpu_operator_torch.cli.operator",
                "--client", conn["host"], "--leader-elect",
                "--metrics-port", "0", "-v"]
        leader = Child("operator", args, env)
        children.append(leader)
        leader_port = int(leader.logged(r"metrics/health on :(\d+)",
                                        60).group(1))

        ds_s = wait_for("the validator DaemonSet", lambda: exists(
            client, "DaemonSet", "gpu-operator-validator", STATES_NS), 120)
        print(f"[wire] the validator DaemonSet appeared "
              f"{time.monotonic() - t_cr:.3f} s after the policy's create")
        run_rendered_workload(client, "[wire]")
        wait_for("the policy to reach ready", lambda: ready_after_marks(
            client), 120, every=0.25)
        ready_s = time.monotonic() - t_cr
        lease = client.get("Lease", "gpu-operator-leader", STATES_NS)
        first = lease.get("spec", "holderIdentity")
        print(f"[wire] CR create -> ready {ready_s:.3f} s on the host clock "
              f"(validator DaemonSet after {ds_s:.3f} s of the operator's "
              f"run, then the workload container, then kubelet's marks); "
              f"Lease gpu-operator-leader held by {first!r}")
        check(bool(first), "the Lease has no holder")

        standby = Child("standby", args, env)
        children.append(standby)
        standby_port = int(standby.logged(r"metrics/health on :(\d+)",
                                          60).group(1))
        standby.logged(r"not leader", 30)

        def leader_metrics():
            return prom_samples(f"http://127.0.0.1:{leader_port}/metrics")

        # the reads a converged pass sends to the wire: the cache's live
        # gets and lists (gpu_operator_api_requests_total) over the passes
        # of a quiet window; the elector's Lease calls bypass the cache
        def reads_and_passes():
            m = leader_metrics()
            return (prom_total(m, "gpu_operator_api_requests_total",
                               verb=("get", "list")),
                    prom_total(m, "gpu_operator_reconciliation_total"),
                    prom_total(m, "gpu_operator_api_requests_total",
                               verb=lambda v: v not in ("get", "list")))
        r0, p0, w0 = reads_and_passes()
        time.sleep(WIRE_LEASE_S + 0.5)    # about three of the leader's passes
        r1, p1, w1 = reads_and_passes()
        check(p1 > p0, f"no converged pass in the window ({p0} -> {p1})")
        print(f"[wire] converged passes: {int(p1 - p0)} in the window, "
              f"{(r1 - r0) / (p1 - p0):g} reads and {(w1 - w0) / (p1 - p0):g}"
              f" writes a pass sent to the wire")
        check(w1 == w0, f"converged passes wrote {w1 - w0} times")

        t1 = time.monotonic()
        client.patch("GPUClusterPolicy", WIRE_POLICY, None,
                     {"spec": {"metricsExporter": {"enabled": False}}})

        wake_s = wait_for("the watch wake to delete the exporter",
                          lambda: not exists(client, "DaemonSet",
                                             "gpu-metrics-exporter",
                                             STATES_NS), 20, every=0.05)
        print(f"[wire] metricsExporter disabled -> its DaemonSet gone in "
              f"{wake_s:.3f} s on the host clock (the ready requeue is "
              f"60 s, the leader's renewal {WIRE_LEASE_S / 3:.3f} s)")
        check(wake_s < 20, f"the watch wake took {wake_s:.3f} s")
        wait_for("the policy to settle ready", lambda: policy_state(
            client) == "ready", 30)

        before = wire_versions(client)
        t_kill = time.monotonic()
        leader.proc.kill()                # SIGKILL: the Lease stays held
        leader.proc.wait(timeout=10)

        def holder():
            return client.get("Lease", "gpu-operator-leader",
                              STATES_NS).get("spec", "holderIdentity")
        failover_s = wait_for("the standby to take the Lease",
                              lambda: holder() not in (None, "", first),
                              6 * WIRE_LEASE_S + 10)
        second = holder()

        def standby_passes():
            return prom_total(prom_samples(
                f"http://127.0.0.1:{standby_port}/metrics"),
                "gpu_operator_reconciliation_total")
        wait_for("the new leader's passes", lambda: standby_passes() >= 2,
                 30, every=0.2)
        after = wire_versions(client)
        moved = sorted(k for k in before if k in after
                       and before[k] != after[k])
        created = sorted(set(after) - set(before))
        gone = sorted(set(before) - set(after))
        print(f"[wire] leader SIGKILLed: {second!r} took the Lease "
              f"{failover_s:.3f} s later (lease {WIRE_LEASE_S} s, standby "
              f"retry 5 s); its {int(standby_passes())} passes moved "
              f"{moved} of {len(before)} objects, created {created}, "
              f"deleted {gone}")
        check(all(k.startswith("Lease/") for k in moved) and not gone,
              f"the new leader wrote {moved}, deleted {gone}")
        check(not [k for k in created if not k.startswith("Event/")],
              f"the new leader created {created}")

        standby.proc.send_signal(signal.SIGINT)
        rc = standby.proc.wait(timeout=15)
        check(rc == 0, f"the standby exited rc {rc}: {standby.tail()}")
        server = prom_samples(f"{conn['host']}/metrics", conn["token"],
                              conn["ca"])
        family = "gpu_apiserver_request_duration_seconds_count"
        by_verb = {}
        for key, value in server.items():
            if key.startswith(family + "{"):
                verb = re.search(r'verb="(\w+)"', key).group(1)
                by_verb[verb] = by_verb.get(verb, 0) + int(value)
        print(f"[wire] the apiserver's requests by verb (its histogram): "
              f"{json.dumps(by_verb, sort_keys=True)}")
        print(f"[wire] standby exited rc {rc} on SIGINT; the path took "
              f"{time.monotonic() - t0:.3f} s on the host clock")
    finally:
        for child in reversed(children):
            child.stop()


def phase_wire_time_to_ready() -> None:
    """``e2e.time_to_ready.measure_time_to_ready()`` on this machine: the
    reconciler drives the 13 states to ready over TLS against an
    in-process wire apiserver; the extra converged pass must send no
    read to the wire."""
    from tpu_operator_torch.e2e.time_to_ready import measure_time_to_ready
    rep = measure_time_to_ready()
    print(f"[wire] time_to_ready: {json.dumps(rep, sort_keys=True)}")
    check(rep["ok"] is True, f"time_to_ready not ok: {rep.get('error')}")
    check(len(rep["per_state_s"]) == 13,
          f"{len(rep['per_state_s'])} states, not 13")
    check(rep["converged"]["api_reads"] == 0,
          f"the converged pass read {rep['converged']}")


# -- the operator installed from its chart: the port's chart rendered by its
# cfg tool and applied through its kubectl shim over the wire, the operator
# started from the applied Deployment, the node driven to ready ------------

#: the override the path re-applies (the exporter's DaemonSet must go)
INSTALL_OVERRIDE = "metricsExporter.enabled=false"
#: every render of the path sets this: the operator binds its metrics port
#: on all interfaces, and a fixed one (the chart's 8080) collides with any
#: other process on the host that holds it; 0 lets the kernel pick a free
#: port, which the operator logs
INSTALL_METRICS_PORT = "operator.metricsPort=0"


def install_tool(module: str, *args, env: dict, stdin: str | None = None
                 ) -> str:
    """``python -m tpu_operator_torch.cli.<module> args`` as a process; it
    must exit 0. Returns its standard output."""
    p = subprocess.run([sys.executable, "-m",
                        f"tpu_operator_torch.cli.{module}", *args],
                       input=stdin, capture_output=True, text=True,
                       timeout=120, env=env,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    check(p.returncode == 0, f"{module} {' '.join(args)}: rc "
          f"{p.returncode}: {p.stderr[-2000:]}")
    return p.stdout


def render_chart(env: dict, *sets) -> str:
    """``gpu-cfg render chart --namespace gpu-operator --set
    operator.metricsPort=0 [--set ...]``."""
    return install_tool("cfg", "render", "chart", "--namespace", STATES_NS,
                        *[a for s in (INSTALL_METRICS_PORT, *sets)
                          for a in ("--set", s)], env=env)


def install_chart(env: dict, kubectl: list, *sets) -> dict:
    """``render_chart(*sets) | kubectl apply -n gpu-operator -f -``;
    returns {kind: objects applied}."""
    rendered = render_chart(env, *sets)
    out = install_tool("kubectl", *kubectl, "apply", "-n", STATES_NS, "-f",
                       "-", env=env, stdin=rendered)
    applied: dict = {}
    for line in out.splitlines():
        kind = line.split("/", 1)[0]
        applied[kind] = applied.get(kind, 0) + 1
    return applied


def container_process(c) -> tuple:
    """(image, argv, env) of the container ``c`` as a runtime would start
    it: its image resolved to a port Dockerfile through
    ``tpu_operator_torch/Makefile``, its command to that image's shim, then
    its args; this host's PATH, HOME, TMPDIR and LANG, the image's ENV with
    the paths the image bakes (``/opt/gpu-operator/...``) mapped to the
    checkout's, and the container's literal env."""
    from tpu_operator_torch.packaging import images
    image = images.image_for(c["image"])
    argv = images.resolve(image, c.get("command"), c.get("args"))
    env = {k: os.environ[k] for k in ("PATH", "HOME", "TMPDIR", "LANG")
           if k in os.environ}
    for name, value in image.env.items():
        env[name] = images.checkout_path(image, value)
    env.update({e["name"]: e["value"] for e in c.get("env", [])
                if "value" in e})
    return image, argv, env


def operator_process(dep, host: str, token: str, ca: str) -> tuple:
    """The argv and environment of the operator container of the applied
    Deployment ``dep`` (``container_process``). Two things are
    substituted: the in-cluster client becomes the wire URL with its token
    and CA (no service-account mount outside a pod), and the paths the
    image bakes become the checkout's."""
    spec = dep.get("spec", "template", "spec")
    [c] = spec["containers"]
    image, argv, env = container_process(c)
    print(f"[install] operator container: image {c['image']} -> "
          f"{image.dockerfile}; command {c.get('command')} args "
          f"{c.get('args')} -> {argv}")
    for name, value in image.env.items():
        print(f"[install] substitution: image ENV {name}={value} -> "
              f"{env[name]} (the checkout's copy)")
    for e in c.get("env", []):
        if "value" not in e:
            field = e["valueFrom"]["fieldRef"]["fieldPath"]
            check(field == "metadata.namespace", f"downward API {field}")
            env[e["name"]] = dep.namespace
    check("--client" not in " ".join(argv),
          f"the Deployment already names a client: {argv}")
    argv = argv + ["--client", host]
    env.update(KUBE_TOKEN=token, KUBE_CA_FILE=ca)
    print(f"[install] substitution: --client incluster (the default) -> "
          f"--client {host}, KUBE_TOKEN and KUBE_CA_FILE from the apiserver "
          f"(no service-account mount outside a pod)")
    return argv, env


def phase_install() -> None:
    """The operator installed from its chart. The port's cfg tool passes its
    four gates offline (``validate chart``, ``crd``, ``clusterpolicy`` on
    the sample, ``csv``); the port's apiserver runs as its own process over
    TLS, and ``cli.kubectl apply`` seeds it with this node (labelled by
    feature discovery on this card, plus NFD's PCI label) and a CPU node;
    ``cfg render chart | kubectl apply -f -`` installs the release. The
    operator starts from the applied Deployment (``operator_process``) and
    reconciles the chart's ``GPUClusterPolicy``; this script plays kubelet:
    the validator DaemonSet's ``workload`` container runs through the
    validator image's shim (K1 and K2 must launch), then the rollouts are
    written done, and the policy must reach ready. A re-install with
    ``--set metricsExporter.enabled=false`` must remove the exporter's
    DaemonSet in under 20 s and show in the applied CR; must-gather
    (``tpu_operator_torch/hack/must-gather.sh`` on the port's kubectl) must
    dump the policy and the DaemonSets; uninstall deletes the CR, then the
    chart's objects, and the operator exits 0 on SIGINT."""
    import importlib
    import yaml
    from tpu_operator_torch.controllers.state_manager import NFD_PCI_LABEL
    from tpu_operator_torch.operands.feature_discovery import \
        FeatureDiscovery
    from tpu_operator_torch.packaging import images
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get(
        "PYTHONPATH", ""))
    sample = os.path.relpath(SAMPLE_CR, root)
    for gate in (("chart",), ("crd",), ("clusterpolicy", "--path", sample),
                 ("csv",)):
        report = json.loads(install_tool("cfg", "validate", *gate, env=env))
        check(report["ok"] is True, f"cfg validate {gate}: {report}")
        print(f"[install] gpu-cfg validate {' '.join(gate)}: ok "
              f"{json.dumps({k: v for k, v in report.items() if k not in ('ok', 'errors')})}")
    children: list = []
    try:
        t0 = time.monotonic()
        conn, client = start_apiserver(env, children)
        env.update(KUBE_TOKEN=conn["token"], KUBE_CA_FILE=conn["ca"])
        kubectl = ["--client", conn["host"]]
        print(f"[install] apiserver {conn['host']} over TLS up in "
              f"{time.monotonic() - t0:.3f} s")

        labels = FeatureDiscovery(None, node_name=STATES_NODE).discover({})
        nodes = []
        for name, node_labels in ((STATES_NODE, {**labels,
                                                 NFD_PCI_LABEL: "true"}),
                                  ("cpu-node-0", {})):
            nodes.append({"apiVersion": "v1", "kind": "Node",
                          "metadata": {"name": name, "labels": node_labels},
                          "status": {"nodeInfo": {
                              "containerRuntimeVersion": "containerd://1.7.0",
                              "kubeletVersion": "v1.29.0"}}})
        out = install_tool("kubectl", *kubectl, "apply", "-f", "-", env=env,
                           stdin=yaml.safe_dump_all(nodes))
        print(f"[install] seeded through kubectl apply: "
              f"{out.split()}; {STATES_NODE} labelled {labels} and "
              f"{NFD_PCI_LABEL}")

        t_install = time.monotonic()
        applied = install_chart(env, kubectl)
        print(f"[install] gpu-cfg render chart | kubectl apply over the "
              f"wire: {json.dumps(applied, sort_keys=True)}")
        check(applied.get("gpuclusterpolicy") == 1 and
              applied.get("deployment") == 1, f"applied {applied}")
        cr = client.get("GPUClusterPolicy", WIRE_POLICY)
        check(cr.labels.get("app.kubernetes.io/instance") == "gpu-operator",
              f"the policy is not the chart's: {cr.labels}")

        dep = client.get("Deployment", "gpu-operator", STATES_NS)
        argv, op_env = operator_process(dep, conn["host"], conn["token"],
                                        conn["ca"])
        operator = Child("operator", argv, op_env)
        children.append(operator)
        operator.logged(r"metrics/health on :(\d+)", 60)

        wait_for("the validator DaemonSet", lambda: exists(
            client, "DaemonSet", "gpu-operator-validator", STATES_NS), 120)
        ds_s = time.monotonic() - t_install
        [c] = [c for c in client.get(
            "DaemonSet", "gpu-operator-validator", STATES_NS).get(
                "spec", "template", "spec")["initContainers"]
               if c["name"] == "workload-validation"]
        shim = images.resolve(images.image_for(c["image"]), c["command"])
        check(shim[:2] == ["python", "-m"], f"the workload runs {shim}")
        print(f"[install] workload container: {c['command']} in "
              f"{c['image']} -> {shim}")
        run_rendered_workload(client, "[install]",
                              importlib.import_module(shim[2]).main)
        wait_for("the chart's policy to reach ready", lambda:
                 ready_after_marks(client), 120, every=0.25)
        ready_s = time.monotonic() - t_install
        print(f"[install] install -> validator DaemonSet {ds_s:.3f} s, "
              f"install -> ready {ready_s:.3f} s on the host clock (the "
              f"operator's start, the workload container, kubelet's marks)")

        t1 = time.monotonic()
        applied = install_chart(env, kubectl, INSTALL_OVERRIDE)
        apply_s = time.monotonic() - t1
        wait_for("the override to remove the exporter",
                 lambda: not exists(client, "DaemonSet",
                                    "gpu-metrics-exporter", STATES_NS),
                 20 - apply_s, every=0.05)
        gone_s = time.monotonic() - t1
        check(gone_s < 20, f"the exporter went after {gone_s:.3f} s")
        spec = client.get("GPUClusterPolicy", WIRE_POLICY).get("spec")
        check(spec["metricsExporter"]["enabled"] is False,
              f"the applied CR lost the override: {spec['metricsExporter']}")
        print(f"[install] --set {INSTALL_OVERRIDE} rendered and applied in "
              f"{apply_s:.3f} s ({json.dumps(applied, sort_keys=True)}); the "
              f"exporter's DaemonSet gone {gone_s:.3f} s after the re-render "
              f"began, on the host clock; the applied CR shows "
              f"metricsExporter.enabled false")
        wait_for("the policy to settle ready", lambda: ready_after_marks(
            client), 30)

        with tempfile.TemporaryDirectory() as tmp:
            gather_env = dict(env, NS=STATES_NS, KCTL=" ".join(
                [sys.executable, "-m", "tpu_operator_torch.cli.kubectl",
                 *kubectl]))
            p = subprocess.run(["bash", os.path.join(
                root, "tpu_operator_torch", "hack", "must-gather.sh"),
                os.path.join(tmp, "gather")], env=gather_env,
                capture_output=True, text=True, timeout=120)
            check(p.returncode == 0, f"must-gather rc {p.returncode}: "
                  f"{p.stderr[-2000:]}")
            dump = os.path.join(tmp, "gather")
            with open(os.path.join(dump, "clusterpolicy.json")) as f:
                policy = json.load(f)
            with open(os.path.join(dump, "daemonsets.json")) as f:
                daemonsets = json.load(f)["items"]
            files = [os.path.join(d, n) for d, _, ns in os.walk(dump)
                     for n in ns]
            check(policy["kind"] == "GPUClusterPolicy" and daemonsets,
                  f"must-gather dumped {policy.get('kind')} and "
                  f"{len(daemonsets)} DaemonSets")
            print(f"[install] must-gather: {len(files)} files, "
                  f"{sum(os.path.getsize(f) for f in files)} bytes; the "
                  f"policy ({policy.get('status', {}).get('state')}) and "
                  f"{len(daemonsets)} DaemonSets")

        install_tool("kubectl", *kubectl, "delete", "gpucp", WIRE_POLICY,
                     env=env)
        rendered = [d for d in yaml.safe_load_all(render_chart(
            env, INSTALL_OVERRIDE)) if d]
        for doc in reversed(rendered):
            if doc["kind"] == "GPUClusterPolicy":
                continue
            ns = doc["metadata"].get("namespace")
            install_tool("kubectl", *kubectl, "delete", doc["kind"],
                         doc["metadata"]["name"],
                         *(("-n", ns) if ns else ()), env=env)
        left = [doc["kind"] for doc in rendered
                if exists(client, doc["kind"], doc["metadata"]["name"],
                          doc["metadata"].get("namespace"))]
        check(not left, f"uninstall left {left}")
        operator.proc.send_signal(signal.SIGINT)
        rc = operator.proc.wait(timeout=15)
        check(rc == 0, f"the operator exited rc {rc}: {operator.tail()}")
        print(f"[install] uninstall: the CR, then the chart's "
              f"{len(rendered) - 1} objects deleted, none left; the "
              f"operator exited rc {rc} on SIGINT; the path took "
              f"{time.monotonic() - t0:.3f} s on the host clock")
    finally:
        for child in reversed(children):
            child.stop()


@contextlib.contextmanager
def relay_environ(env: dict):
    """``os.environ`` with ``env``'s ``RELAY_*`` variables for the length
    of the block (the CLIs' ``build_*`` read them, at construction and at
    every scale-up)."""
    env = {k: v for k, v in env.items() if k.startswith("RELAY_")}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def served(argv: list, env: dict, pattern: str):
    """``argv`` serving on ``--port 0`` for the length of the block: the
    process and the port its log names (``pattern`` followed by ``metrics
    on :N``). The process is killed at the end if it still runs."""
    import queue
    proc = subprocess.Popen(argv + ["--port", "0"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True,
                            cwd=os.path.dirname(os.path.abspath(__file__)))
    try:
        lines: queue.Queue = queue.Queue()
        threading.Thread(target=lambda: [lines.put(line)
                                         for line in proc.stderr],
                         daemon=True).start()
        port = None
        deadline = time.monotonic() + 60
        while port is None and time.monotonic() < deadline:
            try:
                line = lines.get(timeout=1)
            except queue.Empty:
                check(proc.poll() is None, f"{argv[2]} exited rc "
                      f"{proc.returncode}")
                continue
            m = re.search(pattern + r" metrics on :(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, f"{argv[2]} logged no port")
        yield proc, port
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def http_get(port: int, path: str) -> str:
    import urllib.request
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=10) as r:
        return r.read().decode()


# -- the relay replica: the operator renders the relay state, its Deployment's
# command resolves through the relay image and self-tests as its own
# process, a seeded drive at full width runs in this process under the
# rendered environment, then the command serves and stops on SIGINT --------

#: what the relay's phases hand each other
RELAY_RUN: dict = {}
#: eight tenants over the three QoS classes
RELAY_TENANTS = {f"tenant-{i}": cls for i, cls in enumerate(
    ("latency-critical",) * 2 + ("standard",) * 3
    + ("batch-best-effort",) * 3)}
RELAY_SEED = 14
RELAY_SESSIONS = 64
RELAY_DECODE_STEPS = 16
RELAY_ONE_SHOT = 10_000
#: the one-shot traffic: (op, shape, dtype); the warm set holds each
RELAY_OPS = (("matmul", (128, 128), "bf16"), ("matmul", (100, 120), "bf16"),
             ("reduce", (1024,), "f32"), ("embed_lookup", (64, 512), "bf16"))
#: virtual seconds between two pump turns of the drive; a turn offers 2 to
#: 5 one-shot requests, about 350 a second, near the tenants' admission
#: budget (``relay.admissionRate`` 100 a second per tenant over 2
#: replicas, scaled by the class's rate multiplier)
RELAY_TICK_S = 0.01


def relay_spec(tmp: str) -> dict:
    """The policy's relay block (every replica feature on; the router and
    the federation off, their defaults) and the resharding block whose
    plan file the replica watches, with its files under ``tmp``."""
    return {
        "relay": {
            "enabled": True, "repository": "ghcr.io/gpu-operator",
            "image": "gpu-relay-service", "version": "v0.1.0",
            "qos": {"enabled": True, "tenantClassMap": RELAY_TENANTS},
            "sessions": {"enabled": True, "maxSessions": 48,
                         "spillDir": os.path.join(tmp, "sessions")},
            "spmd": {"enabled": True, "partitionRules": [
                {"pattern": "embed", "axes": ["data"]}]},
            "utilization": {"enabled": True},
            "tracing": {"enabled": True},
            "warmStart": [{"op": op, "shape": list(shape), "dtype": dtype}
                          for op, shape, dtype in RELAY_OPS]},
        "resharding": {"enabled": True,
                       "planFile": os.path.join(tmp, "reshard-plan.json")}}


class VirtualClock:
    """The drive's clock: the simulated backend advances it by what each
    dial, compile and dispatch costs; the drive by its tick."""

    def __init__(self, t0: float = 1_700_000_000.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def relay_deployment():
    """The relay Deployment the operator rendered in this path's cluster."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    return FileBackedFakeClient(RELAY_RUN["path"]).get(
        "Deployment", "gpu-relay-service", STATES_NS)


def relay_process(dep) -> tuple:
    """The container, image, argv and environment of the relay container
    of ``dep`` (``container_process``); ``python`` is this interpreter."""
    [c] = dep.get("spec", "template", "spec")["containers"]
    image, argv, env = container_process(c)
    check(argv[:3] == ["python", "-m", "tpu_operator_torch.cli.relay_service"],
          f"the relay command resolves to {argv}")
    return c, image, [sys.executable, *argv[1:]], env


def phase_relay_render() -> None:
    """The operator CLI's passes (``operator_to_ready``) on a file-backed
    fake cluster whose policy enables the relay with QoS, sessions, SPMD,
    the utilization ledger, tracing and resharding; the policy must reach
    ready with ``state-relay-service`` ready, the relay Deployment
    rendered and neither the router's nor the federation's."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    res = operator_to_ready("[relay]", RELAY_RUN, spec=relay_spec)
    states = res["states"]
    print(f"[relay] state-relay-service {states.get('state-relay-service')}"
          f"; the policy ready {res['ready']}")
    check(states.get("state-relay-service") == "ready",
          f"the relay state is {states.get('state-relay-service')}")
    client = FileBackedFakeClient(RELAY_RUN["path"])
    relay = sorted(d.name for d in client.list("Deployment", STATES_NS)
                   if d.name.startswith("gpu-relay"))
    check(relay == ["gpu-relay-service"], f"relay Deployments {relay}")
    dep = relay_deployment()
    [c] = dep.get("spec", "template", "spec")["containers"]
    env = {e["name"]: e["value"] for e in c["env"]}
    print(f"[relay] Deployment gpu-relay-service: {dep.get('spec', 'replicas')}"
          f" replicas, image {c['image']}, command {c['command']}, "
          f"{len(env)} RELAY_* variables")
    plan = RELAY_RUN["plan"] = env["RELAY_PLAN_FILE"]
    with open(plan) as f:
        print(f"[relay] the reshard controller's plan {plan}: {f.read()}")


def phase_relay_workload() -> None:
    """The ``workload`` container of the validator DaemonSet the operator
    rendered beside the relay, run on the card; K1 and K2 must launch."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    run_rendered_workload(FileBackedFakeClient(RELAY_RUN["path"]), "[relay]")


def phase_relay_self_test() -> None:
    """The rendered command resolved through the relay image, run as its
    own process with the rendered environment and ``--self-test``: it must
    report ok, 64 admitted, 64 completed, 0 missing, and exit 0."""
    c, image, argv, env = relay_process(relay_deployment())
    print(f"[relay] relay container: image {c['image']} -> "
          f"{image.dockerfile}; command {c['command']} -> {argv[1:]}")
    t0 = time.perf_counter()
    p = subprocess.run(argv + ["--self-test"], env=env, capture_output=True,
                       text=True, timeout=120,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    secs = time.perf_counter() - t0
    check(p.returncode == 0, f"--self-test rc {p.returncode}: "
          f"{p.stderr[-2000:]}")
    report = json.loads(p.stdout)
    got = (report["ok"], report["admitted"], report["completed"],
           report["missing"])
    print(f"[relay] gpu-relay-service --self-test: rc {p.returncode}, ok "
          f"{got[0]}, admitted {got[1]}, completed {got[2]}, missing "
          f"{got[3]}; {secs:.3f} s on the host clock (the process "
          f"included)")
    check(got == (True, 64, 64, 0), f"self-test {got}")


def relay_drive(env: dict, plan_file: str) -> dict:
    """The seeded drive: ``build_service()`` under ``env`` on the
    simulated backend and a virtual clock, 8 tenants over the three QoS
    classes, ``RELAY_SESSIONS`` sessions of ``RELAY_DECODE_STEPS`` decode
    steps, ``RELAY_ONE_SHOT`` one-shot requests, and a plan cutover
    written to ``plan_file`` halfway. Returns what it observed."""
    import random
    from tpu_operator_torch.cli import relay_service as cli
    from tpu_operator_torch.kube.client import ThrottledError
    from tpu_operator_torch.relay import (RelayMetrics, SessionManager,
                                          SloShedError, expected_kv)
    from tpu_operator_torch.relay.service import SimulatedBackend
    from tpu_operator_torch.utils.prom import Registry
    clock = VirtualClock()
    backend = SimulatedBackend(clock)
    with relay_environ(env):
        metrics = RelayMetrics(registry=Registry())
        svc = cli.build_service(metrics, clock=clock, dial=backend.dial,
                                compile=backend.compile)
        sessions = SessionManager(cli.build_sessions(), service=svc,
                                  clock=clock, metrics=metrics)
        watcher = cli.build_plan_watcher(svc)
    check(svc.qos.enabled and svc.spmd is not None
          and svc.ledger is not None and svc.tracing is not None
          and watcher is not None, "a replica feature is off")
    rng = random.Random(RELAY_SEED)
    tenants = sorted(RELAY_TENANTS)
    sids = [f"session-{i:02d}" for i in range(RELAY_SESSIONS)]
    owner = {sid: tenants[i % len(tenants)] for i, sid in enumerate(sids)}
    steps = RELAY_DECODE_STEPS + 1           # the prefill page, then decode
    admitted, refused = [], {"429": 0, "shed": 0}
    created = set()
    sent = pumps = 0
    pump_s = 0.0
    generations = []
    cut_over = False
    t0 = time.perf_counter()

    def offer(fn, *a, **kw):
        try:
            admitted.append(fn(*a, **kw))
            return True
        except SloShedError:
            refused["shed"] += 1
        except ThrottledError:
            refused["429"] += 1
        return False

    def pump():
        nonlocal pumps, pump_s
        clock.advance(RELAY_TICK_S)
        t = time.perf_counter()
        svc.pump()
        sessions.pump()
        fired = watcher.poll()
        pump_s += time.perf_counter() - t
        pumps += 1
        if fired is not None:
            generations.append((fired["generation"], fired["data"],
                                fired["model"]))

    def unfinished():
        return [sid for sid in sids if sid not in created
                or sessions.session(sid).steps_done < steps]

    pump()                                   # the operator's plan
    while sent < RELAY_ONE_SHOT or unfinished():
        for _ in range(rng.randint(2, 5)):
            if sent >= RELAY_ONE_SHOT:
                break
            op, shape, dtype = rng.choice(RELAY_OPS)
            offer(svc.submit, rng.choice(tenants), op, shape, dtype,
                  size_bytes=rng.randint(256, 8192))
            sent += 1
        for sid in rng.sample(sids, 8):
            if sid not in created:
                if offer(sessions.create, sid, owner[sid],
                         prompt_bytes=rng.randint(1024, 16384)):
                    created.add(sid)
                continue
            s = sessions.session(sid)
            if s.next_step < steps or s.retry_steps:
                offer(sessions.decode, sid)
        if sent >= RELAY_ONE_SHOT // 2 and not cut_over:
            cut_over = True
            with open(plan_file) as f:
                gen = json.load(f)["generation"]
            tmp = f"{plan_file}.tmp"
            with open(tmp, "w") as f:
                json.dump({"generation": gen + 1, "data": 2, "model": 2}, f)
            os.replace(tmp, plan_file)
        pump()
        check(pumps < 200_000, "the drive does not finish")
    svc.drain()
    wall = time.perf_counter() - t0

    executions = backend.executions
    shed = {rid for rid in admitted
            if isinstance(svc.completed.get(rid), SloShedError)}
    lost = [rid for rid in admitted if rid not in svc.completed]
    twice = [rid for rid, n in executions.items() if n != 1]
    stray = set(executions) - set(admitted)
    unrun = [rid for rid in admitted
             if rid not in executions and rid not in shed]
    kv_wrong = [sid for sid in sids if sessions.kv_bytes(sid) != expected_kv(
        sid, steps, sessions.config.page_bytes)]
    snap = svc.utilization_debug()
    return {"admitted": len(admitted), "refused": refused,
            "shed_at_formation": len(shed), "lost": len(lost),
            "executed_twice": len(twice), "stray": len(stray),
            "admitted_unrun": len(unrun), "executions": len(executions),
            "kv_wrong": kv_wrong, "sessions": sessions.stats(),
            "generations": generations, "gather_copies":
                svc.spmd_gather_copies,
            "gather_counter": metrics.spmd_gather_copies_total.get(),
            "ledger": snap, "pumps": pumps, "pump_s": pump_s, "wall_s": wall,
            "virtual_s": clock.t - 1_700_000_000.0,
            "arena": svc.stats().get("arena", {})}


def phase_relay_drive() -> None:
    """``relay_drive`` under the rendered environment (the spill dir and
    the plan file are the policy's, under this path's temporary
    directory). Every admitted request and session step must be committed
    exactly once by the backend (a request shed at formation, never);
    every session's KV cache must hold its 17 pages byte for byte; 0 SPMD
    gather copies; the ledger's six components must sum to the elapsed
    time, on the ``h100`` kind."""
    import math
    _, _, _, env = relay_process(relay_deployment())
    r = relay_drive(env, RELAY_RUN["plan"])
    snap = r["ledger"]
    parts = snap["components"]
    total = math.fsum(parts.values())
    print(f"[relay] drive: {RELAY_ONE_SHOT} one-shot requests and "
          f"{RELAY_SESSIONS} sessions x {RELAY_DECODE_STEPS} decode steps "
          f"from {len(RELAY_TENANTS)} tenants; {r['admitted']} admitted, "
          f"refused {r['refused']}, {r['shed_at_formation']} shed at "
          f"formation; backend executions {r['executions']}, executed twice "
          f"{r['executed_twice']}, admitted and never run "
          f"{r['admitted_unrun']}, lost {r['lost']}, stray {r['stray']}")
    print(f"[relay] drive: sessions {json.dumps(r['sessions'], sort_keys=True)}"
          f"; KV caches wrong {r['kv_wrong']}; plan generations fired "
          f"{r['generations']}; SPMD gather copies {r['gather_copies']} "
          f"(gpu_operator_relay_spmd_gather_copies_total "
          f"{r['gather_counter']}); arena {json.dumps(r['arena'])}")
    print(f"[relay] drive: ledger kind {snap['kind']}, elapsed "
          f"{snap['elapsed_s']!r} s, components "
          f"{json.dumps(parts, sort_keys=True)}, sum {total!r}, residue "
          f"{snap['residue_s']!r}, busy_ideal fraction "
          f"{snap['busy_ideal_fraction']!r}, {snap['batches']} batches")
    print(f"[relay] drive: {r['pumps']} pump turns (the service's, the "
          f"sessions' and the plan watcher's), "
          f"{r['pump_s'] / r['pumps'] * 1e6:.3f} us per turn on the host "
          f"clock; the drive took {r['wall_s']:.3f} s on the host clock "
          f"for {r['virtual_s']:.3f} s of virtual time")
    check(r["lost"] == 0 and r["executed_twice"] == 0 and r["stray"] == 0
          and r["admitted_unrun"] == 0, "a request was not committed "
          "exactly once")
    check(r["admitted"] > RELAY_ONE_SHOT // 2, "most requests were refused")
    check(not r["kv_wrong"], f"KV caches differ: {r['kv_wrong']}")
    check(len(r["generations"]) == 2, f"plan generations {r['generations']}")
    check(r["gather_copies"] == 0 and r["gather_counter"] == 0,
          "SPMD gathered by copy")
    check(snap["kind"] == "h100", f"the ledger's kind {snap['kind']}")
    check(abs(total - snap["elapsed_s"]) <= 1e-9 * max(1.0,
                                                       snap["elapsed_s"]),
          f"the components sum to {total!r} of {snap['elapsed_s']!r}")


def phase_relay_serve() -> None:
    """The rendered command serving on a free port (``--port 0``, as the
    tenth path's ``operator.metricsPort=0``): ``/metrics`` must hold the
    ``gpu_operator_relay_*`` families, ``/debug/utilization`` the ledger
    on the ``h100`` kind and ``/debug/slow`` the flight recorder; SIGINT
    must exit 0."""
    _, _, argv, env = relay_process(relay_deployment())
    print(f"[relay] substitution: RELAY_PORT={env['RELAY_PORT']} -> --port "
          f"0 (a free port; the replica logs the one it binds)")
    try:
        with served(argv, env, "relay") as (proc, port):
            page = http_get(port, "/metrics")
            families = sorted(set(re.findall(
                r"^# TYPE (gpu_operator_relay_\w+)", page, re.M)))
            util = json.loads(http_get(port, "/debug/utilization"))
            slow = json.loads(http_get(port, "/debug/slow"))
            print(f"[relay] serving on :{port}: /metrics {len(page)} bytes, "
                  f"{len(families)} gpu_operator_relay_* families; "
                  f"/debug/utilization enabled {util.get('enabled')}, kind "
                  f"{util.get('kind')}, residue {util.get('residue_s')!r}; "
                  f"/debug/slow offered {slow.get('offered_total')}")
            check(len(families) >= 40 and "tpu_" not in page,
                  f"families {families}")
            check(util.get("enabled") is True and util.get("kind") == "h100",
                  f"/debug/utilization {util}")
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=30)
            print(f"[relay] SIGINT: rc {rc} in "
                  f"{time.perf_counter() - t0:.3f} s")
            check(rc == 0, f"the relay exited rc {rc}")
    finally:
        shutil.rmtree(RELAY_RUN.pop("tmp"), ignore_errors=True)


# -- the relay tier: the operator renders the relay state with the router,
# its autoscaler and the federation switched on; both front commands
# resolve through the relay image and self-test as their own processes, a
# seeded drive of each runs in this process under its rendered
# environment, both serve and stop on SIGINT, and the tier's two harnesses
# run as processes ------------------------------------------------------------

#: what the relay tier's phases hand each other
TIER_RUN: dict = {}
TIER_SEED = 15
#: the bucketed keys of the tier's traffic: sixteen ops at four shapes
TIER_OPS = tuple((f"layer-{i:02d}", (64 * (1 + i % 4), 512), "bf16")
                 for i in range(16))
#: one-shot requests of the router's drive: before the scale-up, between
#: the scale-up and the kill, and the light tail the autoscaler scales
#: down on (one request a turn)
TIER_ROUTER_LEGS = (4000, 4000, 1500)
#: one-shot requests of the federation's drive: before the cell kill,
#: between it and the drain, after the drain
TIER_FED_LEGS = (3000, 3000, 2000)
#: the tenant that floods past its admission budget in the first leg of
#: each drive, so that 429s are offered to the front doors
TIER_FLOOD = "tenant-flood"
#: what ``e2e/relay_tier.py --ci`` reports on the port and on the reference
#: under the ``h100`` kind: its scaling gate, an open fault (F13, ROADMAP
#: queue 3)
TIER_OPEN_FAULTS = [
    "4-replica aggregate rps only 2.65x single-replica (< 3x)"]


def tier_spec(tmp: str) -> dict:
    """``relay_spec`` with the router (2 replicas), its autoscaler (1 to 4
    replicas) and the federation (2 cells) on, and the tier's shared
    compile-cache dir under ``tmp``."""
    spec = relay_spec(tmp)
    spec["relay"].update({
        "replicas": 2, "router": {"enabled": True},
        "autoscaler": {"enabled": True, "minReplicas": 1,
                       "maxReplicas": 4},
        "federation": {"enabled": True, "cells": 2},
        "compileCacheDir": os.path.join(tmp, "compile-cache")})
    return spec


def tier_process(kind: str) -> tuple:
    """The container, image, argv and environment of the relay tier's
    ``gpu-relay-{kind}`` Deployment (``container_process``); ``python`` is
    this interpreter."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    dep = FileBackedFakeClient(TIER_RUN["path"]).get(
        "Deployment", f"gpu-relay-{kind}", STATES_NS)
    [c] = dep.get("spec", "template", "spec")["containers"]
    image, argv, env = container_process(c)
    module = f"tpu_operator_torch.cli.relay_{kind.replace('-', '_')}"
    check(argv[:3] == ["python", "-m", module],
          f"gpu-relay-{kind} resolves to {argv}")
    return c, image, [sys.executable, *argv[1:]], env


def phase_tier_render() -> None:
    """The operator CLI's passes (``operator_to_ready``) on a policy with
    the relay tier switched on; the policy must reach ready with
    ``state-relay-service`` ready and the replica's, the router's and the
    federation's Deployments rendered."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    res = operator_to_ready("[relay-tier]", TIER_RUN, spec=tier_spec)
    state = res["states"].get("state-relay-service")
    print(f"[relay-tier] state-relay-service {state}; the policy ready "
          f"{res['ready']}")
    check(state == "ready", f"the relay state is {state}")
    client = FileBackedFakeClient(TIER_RUN["path"])
    deps = sorted((d for d in client.list("Deployment", STATES_NS)
                   if d.name.startswith("gpu-relay")), key=lambda d: d.name)
    names = [d.name for d in deps]
    check(names == ["gpu-relay-federation", "gpu-relay-router",
                    "gpu-relay-service"], f"relay Deployments {names}")
    for dep in deps:
        [c] = dep.get("spec", "template", "spec")["containers"]
        print(f"[relay-tier] Deployment {dep.name}: "
              f"{dep.get('spec', 'replicas')} replicas, image {c['image']}, "
              f"command {c['command']}, {len(c['env'])} RELAY_* variables")


def phase_tier_workload() -> None:
    """The ``workload`` container of the validator DaemonSet the operator
    rendered beside the relay tier, run on the card; K1 and K2 must
    launch."""
    from tpu_operator_torch.kube.fake import FileBackedFakeClient
    run_rendered_workload(FileBackedFakeClient(TIER_RUN["path"]),
                          "[relay-tier]")


def phase_tier_self_test() -> None:
    """``gpu-relay-router --self-test`` (a scale-up, a replica kill, a
    scale-down) and ``gpu-relay-federation --self-test`` (a cell kill, a
    cell drain), each resolved through the relay image and run as its own
    process with its rendered environment: rc 0, ok, 0 missing."""
    for kind, done in (("router", "routed"), ("federation", "placed")):
        c, image, argv, env = tier_process(kind)
        print(f"[relay-tier] {kind} container: image {c['image']} -> "
              f"{image.dockerfile}; command {c['command']} -> {argv[1:]}")
        t0 = time.perf_counter()
        p = subprocess.run(argv + ["--self-test"], env=env,
                           capture_output=True, text=True, timeout=120,
                           cwd=os.path.dirname(os.path.abspath(__file__)))
        secs = time.perf_counter() - t0
        check(p.returncode == 0, f"gpu-relay-{kind} --self-test rc "
              f"{p.returncode}: {p.stderr[-2000:]}")
        report = json.loads(p.stdout)
        got = (report["ok"], report[done], report["completed"],
               report["missing"])
        print(f"[relay-tier] gpu-relay-{kind} --self-test: rc "
              f"{p.returncode}, ok {got[0]}, {done} {got[1]}, completed "
              f"{got[2]}, missing {got[3]}; {secs:.3f} s on the host clock "
              f"(the process included)")
        check(got[0] is True and got[1] == got[2] and got[3] == 0,
              f"gpu-relay-{kind} self-test {got}")


class TierDrive:
    """What a front door's drive sees: the simulated backends of every
    replica it built, the 429s its replicas raised, and its traffic's
    ids and outcomes."""

    def __init__(self, clock):
        from tpu_operator_torch.cli import relay_service as scli
        from tpu_operator_torch.relay import RelayRejectedError
        from tpu_operator_torch.relay.service import SimulatedBackend
        self.clock = clock
        self.backends: list = []
        self.replica_429 = 0
        self.admitted: list = []
        self.refused = {"429": 0, "shed": 0, "saturated": 0}
        self.pumps = 0
        self.pump_s = 0.0

        def replica(_rid: str):
            """A replica as the router CLI builds one, on a backend of
            this drive's; its 429s are counted."""
            backend = SimulatedBackend(clock)
            self.backends.append(backend)
            svc = scli.build_service(None, clock=clock, dial=backend.dial,
                                     compile=backend.compile)
            real = svc.submit

            def submit(*a, **kw):
                try:
                    return real(*a, **kw)
                except RelayRejectedError:
                    self.replica_429 += 1
                    raise
            svc.submit = submit
            return svc
        self.replica = replica

    def offer(self, submit, *a, **kw) -> None:
        from tpu_operator_torch.relay import (PoolSaturatedError,
                                              RelayRejectedError,
                                              SloShedError)
        try:
            self.admitted.append(submit(*a, **kw))
        except RelayRejectedError:
            self.refused["429"] += 1
        except SloShedError:
            self.refused["shed"] += 1
        except PoolSaturatedError:
            self.refused["saturated"] += 1

    def pump(self, door) -> None:
        self.clock.advance(RELAY_TICK_S)
        t = time.perf_counter()
        door.pump()
        self.pump_s += time.perf_counter() - t
        self.pumps += 1

    def ledger(self, completed: dict) -> dict:
        """Every admitted request against the backends' execution counts:
        each executed exactly once (a request shed at formation, never)."""
        from collections import Counter
        from tpu_operator_torch.relay import SloShedError
        runs: Counter = Counter()
        for backend in self.backends:
            runs.update(backend.executions)
        admitted = set(self.admitted)
        shed = {r for r in admitted
                if isinstance(completed.get(r), SloShedError)}
        return {"admitted": len(self.admitted), "refused": self.refused,
                "replica_429": self.replica_429,
                "shed_at_formation": len(shed),
                "executions": sum(runs.values()),
                "lost": len(admitted - set(completed)),
                "executed_twice": sum(1 for n in runs.values() if n != 1),
                "stray": len(set(runs) - admitted),
                "admitted_unrun": len(admitted - set(runs) - shed),
                "pumps": self.pumps,
                "pump_us": self.pump_s / max(self.pumps, 1) * 1e6}


def tier_traffic(drive, submit, door, rng, n: int, flood: bool = False,
                 burst: tuple = (2, 5)) -> None:
    """``n`` seeded one-shot requests from the eight tenants over
    ``TIER_OPS``, ``burst`` to a pump turn; with ``flood``, 12 more a turn
    from ``TIER_FLOOD`` for the first 100 turns."""
    tenants = sorted(RELAY_TENANTS)
    sent = turns = 0
    while sent < n:
        for _ in range(min(rng.randint(*burst), n - sent)):
            op, shape, dtype = rng.choice(TIER_OPS)
            drive.offer(submit, rng.choice(tenants), op, shape, dtype,
                        size_bytes=rng.randint(256, 8192))
            sent += 1
        if flood and turns < 100:
            for _ in range(12):
                op, shape, dtype = rng.choice(TIER_OPS)
                drive.offer(submit, TIER_FLOOD, op, shape, dtype,
                            size_bytes=1024)
        drive.pump(door)
        turns += 1


def tier_router_drive(env: dict) -> dict:
    """The router's drive: ``build_router()`` and ``build_autoscaler()``
    under ``env`` (the router Deployment's), every replica built as the
    CLI builds it on a simulated backend and one virtual clock. One-shot
    traffic with a flooding tenant, an explicit scale-up, more traffic, a
    replica killed while it holds queued work, then a light tail in which
    the autoscaler evaluates every 20 turns until it has scaled down."""
    import random
    from tpu_operator_torch.cli import relay_router as rcli
    from tpu_operator_torch.relay import (PoolSaturatedError,
                                          RelayRejectedError, RouterMetrics,
                                          SloShedError)
    from tpu_operator_torch.utils.prom import Registry
    clock = VirtualClock()
    drive = TierDrive(clock)
    rng = random.Random(TIER_SEED)
    out: dict = {}
    t0 = time.perf_counter()
    with relay_environ(env):
        metrics = RouterMetrics(registry=Registry())
        router = rcli.build_router(metrics, clock=clock,
                                   factory=drive.replica)
        scaler = rcli.build_autoscaler(router, metrics)
        check(scaler is not None, "the autoscaler is off")
        out["replicas_at_start"] = list(router.replica_ids)

        def submit(*a, **kw):
            rid = router.allocate_rid()
            try:
                return router.submit(*a, rid=rid, **kw)
            except (RelayRejectedError, SloShedError, PoolSaturatedError):
                out.setdefault("refused_ids", []).append(rid)
                raise
        tier_traffic(drive, submit, router, rng, TIER_ROUTER_LEGS[0],
                     flood=True)
        out["scaled_up_to"] = router.scale_up()
        tier_traffic(drive, submit, router, rng, TIER_ROUTER_LEGS[1] // 2)
        # a burst with no pump turn after it: the victim holds queued work
        for _ in range(24):
            op, shape, dtype = rng.choice(TIER_OPS)
            drive.offer(submit, "tenant-0", op, shape, dtype,
                        size_bytes=4096)
        victim = router.replica_ids[0]
        out["killed"] = victim
        out["resubmitted_by_kill"] = router.kill(victim)
        tier_traffic(drive, submit, router, rng,
                     TIER_ROUTER_LEGS[1] - TIER_ROUTER_LEGS[1] // 2)
        actions = []
        sent = 0
        while sent < TIER_ROUTER_LEGS[2] or "down" not in actions:
            tier_traffic(drive, submit, router, rng, 20, burst=(1, 1))
            sent += 20
            actions.append(scaler.evaluate())
            check(sent < 20 * TIER_ROUTER_LEGS[2],
                  f"the autoscaler never scaled down: {actions}")
        router.drain()
    out["autoscaler"] = actions
    out["replicas_at_end"] = list(router.replica_ids)
    out["wall_s"] = time.perf_counter() - t0
    out["virtual_s"] = clock.t - 1_700_000_000.0
    out["stats"] = router.stats()
    refused = set(out.pop("refused_ids", []))
    runs = set()
    for backend in drive.backends:
        runs |= set(backend.executions)
    out["refused_run_or_completed"] = len(refused & (runs
                                                     | set(router.completed)))
    out.update(drive.ledger(router.completed))
    return out


def tier_federation_drive(env: dict) -> dict:
    """The federation's drive: ``build_federation()`` under ``env`` (the
    federation Deployment's), every cell a router tier as the CLI builds
    one, every replica on a simulated backend and one virtual clock.
    One-shot traffic with a flooding tenant, a cell killed while it holds
    queued work, a fresh cell added, more traffic, one of the first cells
    drained while it holds queued work, then a last leg."""
    import random
    from tpu_operator_torch.cli import relay_federation as fcli
    from tpu_operator_torch.cli import relay_router as rcli
    from tpu_operator_torch.relay import FederationMetrics
    from tpu_operator_torch.utils.prom import Registry
    clock = VirtualClock()
    drive = TierDrive(clock)
    rng = random.Random(TIER_SEED + 1)
    out: dict = {}
    t0 = time.perf_counter()
    with relay_environ(env):
        metrics = FederationMetrics(registry=Registry())
        fed = fcli.build_federation(
            metrics, clock=clock, cell_factory=lambda cell_id:
            rcli.build_router(None, clock=clock, factory=drive.replica))
        out["cells_at_start"] = list(fed.cell_ids)

        def burst():
            for _ in range(24):
                op, shape, dtype = rng.choice(TIER_OPS)
                drive.offer(fed.submit, rng.choice(sorted(RELAY_TENANTS)),
                            op, shape, dtype, size_bytes=4096)
        tier_traffic(drive, fed.submit, fed, rng, TIER_FED_LEGS[0],
                     flood=True)
        burst()
        out["killed"] = fed.cell_ids[0]
        out["resubmitted_by_kill"] = fed.kill_cell(out["killed"])
        out["added"] = fed.add_cell()
        tier_traffic(drive, fed.submit, fed, rng, TIER_FED_LEGS[1])
        burst()
        out["drained"] = fed.cell_ids[0]
        fed.drain_cell(out["drained"])
        tier_traffic(drive, fed.submit, fed, rng, TIER_FED_LEGS[2])
        fed.drain()
    out["cells_at_end"] = list(fed.cell_ids)
    out["wall_s"] = time.perf_counter() - t0
    out["virtual_s"] = clock.t - 1_700_000_000.0
    out["stats"] = fed.stats()
    out.update(drive.ledger(fed.completed))
    return out


def tier_check_ledger(tag: str, r: dict) -> None:
    check(r["lost"] == 0 and r["executed_twice"] == 0 and r["stray"] == 0
          and r["admitted_unrun"] == 0,
          f"{tag}: a request was not executed exactly once: {r}")
    check(r["refused"]["429"] > 0 and r["replica_429"] == r["refused"]["429"],
          f"{tag}: 429s at the front door {r['refused']['429']}, at the "
          f"replicas {r['replica_429']} (a 429 that spills is offered "
          f"twice)")
    check(r["admitted"] > 0.9 * (r["admitted"] + r["refused"]["shed"]
                                 + r["refused"]["saturated"]),
          f"{tag}: most requests were refused: {r['refused']}")


def phase_tier_drive() -> None:
    """Both drives under their rendered environments: every admitted
    request executed exactly once against ``SimulatedBackend.executions``,
    every 429 raised by exactly one replica (never spilled) and never run,
    the kill's queued work resubmitted, the autoscaler's scale-down, the
    drained cell's work completed."""
    _, _, _, env = tier_process("router")
    r = tier_router_drive(env)
    st = r["stats"]
    acts = r["autoscaler"]
    print(f"[relay-tier] router drive: replicas {r['replicas_at_start']}, "
          f"scale-up to {r['scaled_up_to']}, killed {r['killed']} "
          f"(resubmitted {r['resubmitted_by_kill']}), autoscaler "
          f"{ {a: acts.count(a) for a in sorted(set(acts))} } over "
          f"{len(acts)} evaluations (the first 'down' at evaluation "
          f"{acts.index('down') + 1 if 'down' in acts else None}), "
          f"replicas at the end {r['replicas_at_end']}")
    print(f"[relay-tier] router drive: {r['admitted']} admitted, refused "
          f"{r['refused']} ({r['replica_429']} 429s raised by the replicas; "
          f"{r['refused_run_or_completed']} refused ids run or completed), "
          f"{r['shed_at_formation']} shed at formation; backend executions "
          f"{r['executions']}, executed twice {r['executed_twice']}, "
          f"admitted and never run {r['admitted_unrun']}, lost {r['lost']},"
          f" stray {r['stray']}")
    print(f"[relay-tier] router drive: affinity ratio "
          f"{st['affinity_ratio']}, resubmitted {st['resubmitted']}, "
          f"spilled {st['spillovers']}; {r['pumps']} pump turns, "
          f"{r['pump_us']:.3f} us per turn on the host clock; "
          f"{r['wall_s']:.3f} s on the host clock for {r['virtual_s']:.3f} "
          f"s of virtual time")
    tier_check_ledger("router drive", r)
    check(r["refused_run_or_completed"] == 0, "a refused request ran")
    check(r["resubmitted_by_kill"] > 0, "the killed replica held no work")
    check("down" in r["autoscaler"], "the autoscaler never scaled down")

    _, _, _, env = tier_process("federation")
    f = tier_federation_drive(env)
    st = f["stats"]
    print(f"[relay-tier] federation drive: cells {f['cells_at_start']}, "
          f"killed {f['killed']} (resubmitted {f['resubmitted_by_kill']}), "
          f"added {f['added']}, drained {f['drained']}, cells at the end "
          f"{f['cells_at_end']}")
    print(f"[relay-tier] federation drive: {f['admitted']} admitted, "
          f"refused {f['refused']} ({f['replica_429']} 429s raised by the "
          f"replicas), {f['shed_at_formation']} shed at formation; backend "
          f"executions {f['executions']}, executed twice "
          f"{f['executed_twice']}, admitted and never run "
          f"{f['admitted_unrun']}, lost {f['lost']}, stray {f['stray']}")
    print(f"[relay-tier] federation drive: home ratio {st['home_ratio']}, "
          f"resubmitted {st['resubmitted']}, spilled {st['spills']}, cache "
          f"entries replicated {st['cache_replicated']}; {f['pumps']} pump "
          f"turns, {f['pump_us']:.3f} us per turn on the host clock; "
          f"{f['wall_s']:.3f} s on the host clock for {f['virtual_s']:.3f} "
          f"s of virtual time")
    tier_check_ledger("federation drive", f)
    check(f["resubmitted_by_kill"] > 0, "the killed cell held no work")
    check(len(f["cells_at_end"]) == 1, f"cells {f['cells_at_end']}")


def phase_tier_serve() -> None:
    """Each front command serving on a free port (``--port 0``):
    ``/metrics`` must hold the ``gpu_operator_relay_router_*``
    (``..._fed_*``) families and no ``tpu_`` name, the router's
    ``/debug/pools`` must be keyed by replica id (the federation's by cell
    id); SIGINT must end each with rc 0."""
    for kind, family, port_var in (("router", "router", "RELAY_ROUTER_PORT"),
                                   ("federation", "fed", "RELAY_FED_PORT")):
        _, _, argv, env = tier_process(kind)
        print(f"[relay-tier] substitution: {port_var}={env[port_var]} -> "
              f"--port 0 (a free port; the command logs the one it binds)")
        with served(argv, env, f"relay-{kind}") as (proc, port):
            page = http_get(port, "/metrics")
            families = sorted(set(re.findall(
                rf"^# TYPE (gpu_operator_relay_{family}_\w+)", page, re.M)))
            pools = json.loads(http_get(port, "/debug/pools"))
            keyed = sorted(pools["replicas" if kind == "router" else "cells"])
            print(f"[relay-tier] gpu-relay-{kind} serving on :{port}: "
                  f"/metrics {len(page)} bytes, {len(families)} "
                  f"gpu_operator_relay_{family}_* families; /debug/pools "
                  f"keyed by {keyed}"
                  + (f", upstream {pools['upstream']}"
                     if kind == "router" else ""))
            check(len(families) >= 8 and "tpu_" not in page,
                  f"gpu-relay-{kind} families {families}")
            want = ([f"relay-{i}" for i in range(2)] if kind == "router"
                    else [f"cell-{i}" for i in range(2)])
            check(keyed == want, f"/debug/pools keyed by {keyed}")
            t0 = time.perf_counter()
            proc.send_signal(signal.SIGINT)
            rc = proc.wait(timeout=30)
            print(f"[relay-tier] gpu-relay-{kind} SIGINT: rc {rc} in "
                  f"{time.perf_counter() - t0:.3f} s")
            check(rc == 0, f"gpu-relay-{kind} exited rc {rc}")


def phase_tier_harnesses() -> None:
    """``python -m tpu_operator_torch.e2e.federation --ci`` must report ok;
    ``... .e2e.relay_tier --ci`` must report nothing but its open fault
    (``TIER_OPEN_FAULTS``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    try:
        for harness, want in (("federation", []),
                              ("relay_tier", TIER_OPEN_FAULTS)):
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-m", f"tpu_operator_torch.e2e.{harness}",
                 "--ci"], capture_output=True, text=True, timeout=300,
                cwd=root)
            secs = time.perf_counter() - t0
            report = json.loads(p.stdout)
            print(f"[relay-tier] e2e.{harness} --ci: rc {p.returncode}, ok "
                  f"{report['ok']}, problems {report['problems']}; "
                  f"{secs:.3f} s on the host clock")
            if harness == "federation":
                kill, warm = report["kill"], report["warm_cache"]
                print(f"[relay-tier] e2e.federation: cell kill missing "
                      f"{kill['missing']}, duplicated {kill['duplicated']}, "
                      f"p99 spike {kill['p99_spike']}; replication cuts "
                      f"cold compiles {warm['cold_compile_reduction']}x; 2 "
                      f"cells {report['scaling']['speedup_2x']}x one")
            else:
                sc = report["scaling"]
                print(f"[relay-tier] e2e.relay_tier: speedup at 4 replicas "
                      f"{sc['speedup_4x']}x, at 8 {sc['speedup_8x']}x "
                      f"(open fault F13: the 3x gate holds for the "
                      f"reference's placeholder kind, not for h100); kill "
                      f"duplicated {report['kill']['duplicated']}, missing "
                      f"{report['kill']['missing']}")
            check(report["problems"] == want and p.returncode ==
                  (0 if not want else 1),
                  f"e2e.{harness}: rc {p.returncode}, {report['problems']}")
    finally:
        shutil.rmtree(TIER_RUN.pop("tmp"), ignore_errors=True)


#: the analyzer's passes, as ``--list`` names them (and the reference's)
LINT_PASSES = ("locks", "clocks", "errors", "randomness", "allocations",
               "pump-alloc", "wiring", "metrics-docs")


def lint_step(label: str, argv: list, env: dict, timeout: float = 300
              ) -> subprocess.CompletedProcess:
    """One static-gate command as a process from the checkout's root; it
    must exit 0. Prints its rc and its seconds on the host clock."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    p = subprocess.run(argv, capture_output=True, text=True, timeout=timeout,
                       env=env, cwd=root)
    secs = time.perf_counter() - t0
    print(f"[lint] {label}: rc {p.returncode}; {secs:.3f} s on the host "
          f"clock")
    check(p.returncode == 0, f"{label}: rc {p.returncode}: "
          f"{(p.stdout + p.stderr)[-2000:]}")
    return p


def phase_static_gate() -> None:
    """The port's static gate on this machine, each step as a process: the
    invariant analyzer over the checkout (``--all``, 0 findings), its
    ``--list`` (the eight passes), the byte-compile sweep (``make -C
    tpu_operator_torch lint-compile``), and ``scripts/cases/cdi-runtime.sh``
    up to its hand-over (its render check; ``CI_RUN`` points it at a stub,
    so the e2e cycle the other paths cover does not run). Launches no
    kernel."""
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        # the scripts call ``python``: this interpreter (a wrapper, since a
        # link would leave a virtual environment behind)
        wrapper = os.path.join(tmp, "python")
        with open(wrapper, "w") as f:
            f.write(f'#!/bin/sh\nexec "{sys.executable}" "$@"\n')
        os.chmod(wrapper, 0o755)
        env = dict(os.environ, PATH=f"{tmp}:{os.environ.get('PATH', '')}",
                   PYTHONPATH=root)
        p = lint_step("python -m tpu_operator_torch.analysis --all --format "
                      "json", [sys.executable, "-m",
                               "tpu_operator_torch.analysis", "--all",
                               "--format", "json"], env)
        findings = json.loads(p.stdout)["findings"]
        print(f"[lint] gpucheck: {len(findings)} finding(s) from "
              f"{len(LINT_PASSES)} passes ({p.stderr.strip()})")
        check(findings == [], f"gpucheck findings: {findings}")
        p = lint_step("python -m tpu_operator_torch.analysis --list",
                      [sys.executable, "-m", "tpu_operator_torch.analysis",
                       "--list"], env)
        listed = tuple(line.split(":")[0] for line in p.stdout.splitlines())
        print(f"[lint] passes: {', '.join(listed)}")
        check(listed == LINT_PASSES, f"--list names {listed}")
        lint_step("make -C tpu_operator_torch lint-compile",
                  ["make", "-C", "tpu_operator_torch", "lint-compile"], env)
        stub = os.path.join(tmp, "ci-run.sh")
        with open(stub, "w") as f:
            f.write('echo "[case] handed over with CHART_SET_OPTIONS='
                    '${CHART_SET_OPTIONS}"\n')
        p = lint_step("scripts/cases/cdi-runtime.sh (render check)",
                      ["bash", "tpu_operator_torch/scripts/cases/"
                       "cdi-runtime.sh"], dict(env, CI_RUN=stub))
        for line in p.stdout.splitlines():
            print(f"[lint]   {line}")
        check("[case] render check OK" in p.stdout and "[case] handed over "
              "with CHART_SET_OPTIONS=--set containerToolkit.cdiEnabled="
              "true" in p.stdout, "cdi-runtime.sh's render check")
        print("[lint] the static gate launches no kernel")


#: the validator's efficiency gate by default (``WorkloadComponent``'s
#: ``min_efficiency``, the reference's ``minEfficiency``)
MIN_EFFICIENCY = 0.5
#: the bench's device lines, each named for the card
BENCH_DEVICE_LINES = ("gpu_validator_burnin_matmul_bf16", "gpu_hbm_read_gbps",
                      "gpu_flash_attention_causal_bf16",
                      "gpu_allreduce_busbw_gbps", "gpu_smoke_cuda")
#: the SDPA backends that are fused kernels (not the math backend)
FUSED_SDPA = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")
#: F13 (ROADMAP.md queue 3) at the bench's arguments, where the tier
#: harness runs its default 2000 requests (2.65x at ``--ci``'s); the
#: reference's harness reads the same under the port's kind table
#: (tests/test_torch_bench.py)
BENCH_TIER_FAULT = "4-replica aggregate rps only 2.66x single-replica (< 3x)"
#: the floor of the sharded walk's speedup over the serial walk where it
#: reads under its 3.0x bar: a loaded host can (the same code reads above
#: the bar on an idle one), but the sharded walk must still win
WALK_SPEEDUP_FLOOR = 1.0
#: the pump's bar (``e2e/pump_speed.py``) and the measurements of it at
#: most, the bench's included: a loaded host can read one under it, a
#: regression reads every one under it (tests/test_torch_relay_pump.py)
PUMP_SPEEDUP_BAR = 5.0
PUMP_ATTEMPTS = 3
#: the throughput leg's arguments in the bench (``measure_pump_speed``'s
#: defaults)
PUMP_LEG_ARGS = {"rounds": 4, "depth": 2048, "repeats": 3}


def walk_speedup_holds(problem: str) -> bool:
    """``fleet_scale``'s walk bar missed, but the sharded walk still
    beats the serial one by more than :data:`WALK_SPEEDUP_FLOOR`."""
    m = re.fullmatch(r"sharded walk speedup at \d+ nodes is ([0-9.]+)x, "
                     r"acceptance bar is [0-9.]+x", problem)
    if m is None:
        return False
    print(f"[bench]   the sharded walk read {m.group(1)}x, under its bar; "
          f"its floor here is {WALK_SPEEDUP_FLOOR}x")
    return float(m.group(1)) > WALK_SPEEDUP_FLOOR


def pump_speedup_holds(problem: str) -> bool:
    """``pump_speed``'s 5x bar missed: its throughput leg, measured again
    at the harness's arguments, reaches the bar within
    :data:`PUMP_ATTEMPTS` measurements, the bench's included."""
    if not problem.startswith("vectorized pump speedup "):
        return False
    from tpu_operator_torch.e2e import pump_speed
    readings = [problem.split()[3]]
    for _ in range(PUMP_ATTEMPTS - 1):
        thr = pump_speed._leg_throughput(pump_speed.DEFAULT_SEED,
                                         keys=pump_speed.BACKLOG_KEYS,
                                         **PUMP_LEG_ARGS)
        readings.append(f"{thr['speedup']}x")
        if thr["lost"] == 0 and thr["speedup"] >= PUMP_SPEEDUP_BAR:
            break
    print(f"[bench]   the pump's speedup measured again: {readings}; bar "
          f"{PUMP_SPEEDUP_BAR}x")
    return thr["lost"] == 0 and thr["speedup"] >= PUMP_SPEEDUP_BAR


#: the problems a harness line may report: two bars on the host clock,
#: each under the rule above, and the open fault F13, word for word
BENCH_ALLOWED = {
    "fleet_scale_sharded_walk_10k": walk_speedup_holds,
    "relay_pump_speed": pump_speedup_holds,
    "relay_tier_scaling": lambda p: p == BENCH_TIER_FAULT,
}
#: the suite's collectives across cards: the library's (the hand rings
#: hold virtual ranks of one card and are not in the line there)
CROSS_CARD_OPS = ("allreduce", "all_gather", "reduce_scatter", "all_to_all",
                  "ppermute_ring")


def check_collectives_line(co: dict, n: int) -> None:
    """The bench's collectives line on ``n`` cards: the one-card N/A, or
    the suite's library collectives over every card with the all-reduce's
    figure as the value."""
    print(f"[bench] {co['metric']} on {n} card(s): {co['value']} "
          f"({co['detail']})")
    if n < 2:
        check(co["value"] == 0.0 and "skipped" in co["detail"],
              f"collectives line {co}")
        return
    d = co["detail"]
    check(co["value"] > 0 and co["vs_baseline"] == 1.0
          and d["n_devices"] == n and all(
              d["busbw_gbps"].get(op, 0) > 0 for op in CROSS_CARD_OPS)
          and d["busbw_gbps"]["allreduce"] == co["value"],
          f"collectives line {co}")


def bench_timed(seconds: dict, name: str, fn):
    """``fn`` that records its host-clock seconds under ``name``."""
    def run(*args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t0
    run.__name__ = fn.__name__
    return run


def phase_bench() -> None:
    """The port's bench, ``tpu_operator_torch.bench.main([])``, in this
    process (so that the launch counters see K1 and K2), its stdout
    captured, each line's host-clock seconds recorded. The one line it
    prints must have the reference's shape with every device line named
    for the card; the matmul must clear the validator's efficiency gate,
    the HBM and flash lines must not be suspect, the flash comparator must
    be a fused SDPA backend, the smoke must score 1.0 through the
    machine's ``libcuda.so.1``, the collectives line must be the one-card
    N/A, nothing may have crashed, and each harness must report ok but for
    the problems ``BENCH_ALLOWED`` names."""
    import io
    from tpu_operator_torch import bench
    seconds = {}
    saved = {name: getattr(bench, name) for name in (
        "_bench_smoke", "_bench_matmul", "_bench_hbm", "_bench_flash",
        "_bench_collectives", "HARNESS_LINES")}
    for name in saved:
        if name != "HARNESS_LINES":
            setattr(bench, name, bench_timed(seconds, name, saved[name]))
    bench.HARNESS_LINES = tuple(
        (bench_timed(seconds, metric, fn), metric, *rest)
        for fn, metric, *rest in saved["HARNESS_LINES"])
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = bench.main([])
    finally:
        for name, value in saved.items():
            setattr(bench, name, value)
    total = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    print(f"[bench] main([]): rc {rc}, {len(lines)} stdout line(s), "
          f"{len(lines[0]) if lines else 0} bytes; {total:.3f} s on the "
          f"host clock")
    check(rc == 0 and len(lines) == 1, f"bench printed {lines[:3]}")
    result = json.loads(lines[0])
    keys = ["metric", "value", "unit", "vs_baseline"]
    check(list(result)[:4] == keys and {"audit", "extra"} <= set(result),
          f"bench line keys {list(result)}")
    lines_ = [result, *result["extra"]]
    by_metric = {line["metric"]: line for line in lines_}
    for line in lines_:
        check(list(line)[:4] == keys, f"line keys {list(line)}")
        check("tpu" not in line["metric"] and "ici" not in line["metric"],
              f"a TPU name in the bench: {line['metric']}")
        detail = line.get("detail")
        check(line["metric"] != "probe_error"
              and not (isinstance(detail, str) and "crashed" in detail),
              f"bench line crashed: {line}")
    check(all(m in by_metric for m in BENCH_DEVICE_LINES),
          f"bench device lines {sorted(by_metric)}")

    mm = by_metric["gpu_validator_burnin_matmul_bf16"]
    print(f"[bench] {mm['metric']}: {mm['value']} {mm['unit']}, "
          f"vs_baseline {mm['vs_baseline']} (gate {MIN_EFFICIENCY}); audit "
          f"{json.dumps(mm['audit'])}; "
          f"{seconds['_bench_matmul']:.3f} s")
    check(mm["vs_baseline"] >= MIN_EFFICIENCY and not mm["audit"]["suspect"],
          f"matmul line {mm}")
    hb = by_metric["gpu_hbm_read_gbps"]
    print(f"[bench] {hb['metric']}: {hb['value']} {hb['unit']}, "
          f"vs_baseline {hb['vs_baseline']}; suspect "
          f"{hb['audit']['suspect']}, denominator "
          f"{hb['audit']['denominator']}; {seconds['_bench_hbm']:.3f} s")
    check(not hb["audit"]["suspect"] and hb["vs_baseline"] <= 1.05,
          f"HBM line {hb}")
    fl = by_metric["gpu_flash_attention_causal_bf16"]
    d = fl["detail"]
    print(f"[bench] {fl['metric']}: K2 {fl['value']} {fl['unit']} at "
          f"[{d['seq_len']}, {d['d']}] against SDPA {d['sdpa_backend']} "
          f"{d['sdpa_tflops']} TFLOP/s: speedup {fl['vs_baseline']}; "
          f"checksum rel err {d['checksum_rel_err']} (not gated: K2's "
          f"error is the flash phase's per-element limit); dt flash "
          f"{d['flash_dt_s']} s, sdpa {d['sdpa_dt_s']} s; suspect "
          f"{d['suspect']} (peak {d['chip_peak_tflops']}); "
          f"{seconds['_bench_flash']:.3f} s")
    check(not d["suspect"] and d["sdpa_backend"] in FUSED_SDPA,
          f"flash line {fl}")
    check_collectives_line(by_metric["gpu_allreduce_busbw_gbps"],
                           torch.cuda.device_count())
    sm = by_metric["gpu_smoke_cuda"]
    print(f"[bench] {sm['metric']}: {sm['value']}, detail "
          f"{json.dumps(sm['detail'])}; "
          f"{seconds['_bench_smoke']:.3f} s")
    check(sm["value"] == 1.0
          and sm["detail"]["transport"] == "libcuda-local",
          f"smoke line {sm}")
    for _, metric, *_ in bench.HARNESS_LINES:
        line = by_metric[metric]
        d = line["detail"]
        ok = d.get("ok", line["vs_baseline"] == 1.0)
        problems = d.get("problems", [])
        print(f"[bench] {metric}: {line['value']} {line['unit']}, "
              f"vs_baseline {line['vs_baseline']}, ok {ok}, problems "
              f"{problems}; {seconds[metric]:.3f} s")
        allowed = BENCH_ALLOWED.get(metric, lambda p: False)
        check(ok or (problems and all(allowed(p) for p in problems)),
              f"{metric}: ok {ok}, problems {problems}")
    print("[bench] K2's launches on this path are the calls captured into "
          "its CUDA graphs (and the uncaptured ones), not the replays")


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
               *phase_flash_generic(dev, kind), *phase_ring(dev, kind)]

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
          "flash_fwd_wgmma": flash_mod.flash_wgmma,
          "flash_fwd_generic": flash_mod.flash_generic}),
        ("health monitor", (phase_health_monitor, phase_health_probes),
         {"hbm_read": hbm_mod.read_sum}),
        # the node agents launch no TPU kernel's port: gpu-smoke's PTX add
        # is the vectorAdd probe, not a kernel of the table
        ("node agents", (phase_agents_build, phase_agents_smoke,
                         phase_agents_metrics, phase_agents_node), {}),
        ("operator states", (phase_states_slices, phase_states_pipeline,
                             phase_states_validator),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        ("operator", (phase_operator_cli, phase_operator_validator,
                      phase_operator_oci_hook),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        ("operator over the wire", (phase_wire_serve,
                                    phase_wire_time_to_ready),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        ("operator installed from its chart", (phase_install,),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        # the relay replica runs on the simulated backend and launches no
        # kernel; K1 and K2 launch in the workload container rendered
        # beside it
        ("relay replica", (phase_relay_render, phase_relay_workload,
                           phase_relay_self_test, phase_relay_drive,
                           phase_relay_serve),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        # the router and the federation front simulated replicas too
        ("relay tier", (phase_tier_render, phase_tier_workload,
                        phase_tier_self_test, phase_tier_drive,
                        phase_tier_serve, phase_tier_harnesses),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        # the port's bench: the validator's probes at the bench's shapes
        # (K1 256 MiB, 2048/512 sweeps; K2 bf16 [16384, 128] causal in
        # CUDA graphs) and the seventeen harnesses
        ("bench", (phase_bench,),
         {"hbm_read": hbm_mod.read_sum,
          "flash_fwd": flash_mod.flash_attention}),
        # the analyzer and the CI case's render check: AST and YAML work
        # on the host, no kernel
        ("static gate", (phase_static_gate,), {}),
    )
    # a kernel's launches: the sum over the paths that must reach it
    launches = {entry_["name"]: 0 for entry_ in kernels}
    for path, phases, counters in paths:
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        for phase in phases:
            phase()
        counts = {name: fn.launches for name, fn in counters.items()}
        print(f"[kernels] launches on the {path} path: {counts}; the path "
              f"took {time.perf_counter() - t0:.3f} s on the host clock"
              + ("" if counters else "; it launches no kernel"))
        for name, count in counts.items():
            check(count > 0, f"{name} never launched on the {path} path")
            launches[name] += count
    for entry_ in kernels:
        entry_["launches"] = launches[entry_["name"]]
        check(entry_["launches"] > 0,
              f"{entry_['name']} never launched on the main path")
    phase_ulysses_dense()

    print(smi_line)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
