"""Node-side validation: the device workload component.

The port of ``tpu_operator/validator/components.py``'s ``Component`` base
(status files and the retry loop) and ``WorkloadComponent``. Each component writes a JSON status file into the barrier directory
when green; dependents test for its existence and the metrics exporter
reads the measurements in it.

``WorkloadComponent.validate()`` runs on the card, in order:

1. the bf16 matmul-chain probe, gated at ``MIN_EFFICIENCY`` of the card's
   data-sheet peak (an unmatched card is an audit flag, never a red node);
2. the HBM read probe on the CUDA read kernel, whose checksum failure is a
   validation failure;
3. one causal flash-attention pass on the CUDA attention kernel, checked
   against the pinned-precision oracle under a derived tolerance.

With more than one rank it goes on with the multi-device leg, on virtual
ranks of its device (``parallel/mesh.py``):

4. the collective bandwidth suite over a (1, ranks) mesh's model axis,
   which on the card includes the hand-scheduled ring all-reduces;
5. one causal ring-attention pass over the same mesh, checked against the
   oracle on one device under the same derived tolerance.

The runtime-version skew check is not ported yet.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time

import torch

log = logging.getLogger("gpu-validator")

DEFAULT_VALIDATIONS_DIR = "/run/nvidia/validations"
RETRY_INTERVAL_S = 5


class ValidationFailed(Exception):
    pass


class Component:
    name = "component"

    def __init__(self, validations_dir: str = DEFAULT_VALIDATIONS_DIR,
                 wait: bool = False, retry_interval: float = RETRY_INTERVAL_S,
                 max_tries: int | None = None):
        self.dir = validations_dir
        self.wait = wait
        self.retry_interval = retry_interval
        # --wait means wait until ready: an init-container barrier must block,
        # not crash-loop. Without wait, fail fast. An explicit max_tries wins.
        if max_tries is None:
            max_tries = 10 ** 9 if wait else 1
        self.max_tries = max_tries

    # -- status files (the cross-DaemonSet barrier) -----------------------
    def status_path(self, name: str | None = None) -> str:
        return os.path.join(self.dir, f"{name or self.name}-ready")

    def write_status(self, info: dict | None = None):
        os.makedirs(self.dir, exist_ok=True)
        with open(self.status_path(), "w") as f:
            json.dump({"ok": True, "ts": time.time(),
                       "component": self.name, "info": info or {}}, f)

    def clear_status(self):
        try:
            os.unlink(self.status_path())
        except FileNotFoundError:
            pass

    def status_exists(self, name: str) -> bool:
        return os.path.exists(self.status_path(name))

    # -- run loop ---------------------------------------------------------
    def validate(self) -> dict:
        """One attempt; returns info dict or raises ValidationFailed."""
        raise NotImplementedError

    def abort(self) -> None:
        """Release any resource held across retry attempts. Called when
        run() stops retrying, on success or giving up. Must be idempotent."""

    def run(self) -> dict:
        last_err = None
        try:
            for i in range(self.max_tries):
                try:
                    info = self.validate()
                    self.write_status(info)
                    log.info("%s validation ok: %s", self.name, info)
                    return info
                except ValidationFailed as e:
                    last_err = e
                    self.clear_status()
                    if i + 1 < self.max_tries:
                        log.info("%s not ready (%s); retrying in %ss",
                                 self.name, e, self.retry_interval)
                        time.sleep(self.retry_interval)
            raise ValidationFailed(f"{self.name}: {last_err}")
        finally:
            self.abort()


def _require_gpu_default() -> bool:
    """REQUIRE_GPU_PLATFORM env contract: the validation DaemonSet sets it on
    nodes the operator labelled GPU-present, where a validator that cannot
    reach the card must fail, never go green on a shrunken CPU run."""
    return os.environ.get("REQUIRE_GPU_PLATFORM", "").lower() == "true"


def _check_platform(device, require_gpu: bool) -> torch.device:
    """The device to validate; raises when CUDA was asked for and is absent,
    or when the node contract demands a GPU and the CPU was asked for."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ValidationFailed(
            "no CUDA device is reachable from this container (driver, "
            "/dev/nvidia* mounts or CUDA runtime missing); pass "
            "device='cpu' to run the CPU path")
    if dev.type not in ("cuda", "cpu"):
        raise ValidationFailed(f"unsupported device {dev}")
    if require_gpu and dev.type != "cuda":
        raise ValidationFailed(
            f"node is marked GPU-present but the workload was asked to run "
            f"on {dev.type!r}")
    return dev


def _efficiency_gate(tflops: float, kind: str, min_efficiency: float):
    """``(peak, efficiency, matched)`` of a card's matmul rate against its
    data-sheet peak; raises when a matched card falls below
    ``min_efficiency``. An unmatched card is measured against the default
    denominator, logged, and passes: a guessed denominator is an audit
    flag, never a red node."""
    from tpu_operator_torch.ops.matmul import (DEFAULT_PEAK_BF16, PEAK_BF16,
                                               chip_peak_tflops, peak_lookup)
    peak = chip_peak_tflops(kind)
    _, _, matched = peak_lookup(kind, PEAK_BF16, DEFAULT_PEAK_BF16)
    # a CR/env override is a deliberate denominator, same as a table hit
    matched = matched or bool(os.environ.get("PEAK_TFLOPS"))
    eff = tflops / peak
    if eff < min_efficiency:
        if matched:
            raise ValidationFailed(
                f"matmul {tflops:.1f} TFLOP/s is {eff:.2%} of peak "
                f"{peak:.0f} ({kind!r}) < min {min_efficiency:.2%}")
        log.warning(
            "workload: %s not in the peak table; efficiency %.2f is against "
            "the DEFAULT denominator %.0f — gate skipped, set PEAK_TFLOPS "
            "to enforce it", kind, eff, peak)
    return peak, eff, matched


def _significant(rate: float) -> float:
    """A rate to four significant digits: a slow CPU's rate stays above
    zero where a fixed number of decimals would round it away."""
    return float(f"{rate:.4g}")


class WorkloadComponent(Component):
    """The device workload on the local card: matmul probe, HBM probe and
    flash-attention check, plus the collective suite and a ring-attention
    check when it runs over more than one rank. ``ranks`` defaults to the
    number of cards (1 on the CPU); the ranks are virtual ranks of
    ``device``."""

    name = "workload"

    def __init__(self, matmul_dim: int | None = None,
                 min_efficiency: float | None = None,
                 collective_mb: int | None = None,
                 require_gpu: bool | None = None, device=None,
                 ranks: int | None = None, **kw):
        super().__init__(**kw)
        self.matmul_dim = int(matmul_dim or os.environ.get(
            "WORKLOAD_MATMUL_DIM", 4096))
        self.min_efficiency = float(min_efficiency if min_efficiency
                                    is not None else os.environ.get(
                                        "MIN_EFFICIENCY", 0.5))
        self.collective_mb = int(collective_mb or os.environ.get(
            "WORKLOAD_COLLECTIVE_MB", 64))
        self.require_gpu = (require_gpu if require_gpu is not None
                            else _require_gpu_default())
        self.device = device or "cuda"
        self.ranks = ranks

    def _check_flash(self, device: torch.device, on_gpu: bool) -> dict:
        """One causal flash-attention pass checked against the
        pinned-precision oracle: the tensor cores (block matmuls), the
        online softmax and the kernel's shared-memory tiling in one shot, a
        path the matmul chain never touches. Full size on the card; small
        on an explicit CPU, where the plain version runs."""
        from tpu_operator_torch.ops.flash_attention import flash_attention
        from tpu_operator_torch.parallel.numerics import attention_tolerance
        from tpu_operator_torch.parallel.ring_attention import \
            reference_attention
        t, d = (4096, 128) if on_gpu else (256, 128)
        gen = torch.Generator(device=device).manual_seed(7)
        q, k, v = (torch.randn((t, d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        out = flash_attention(q, k, v, causal=True)
        ref = reference_attention(q, k, v, causal=True)
        tol = attention_tolerance(q.dtype, d, platform=device.type)
        err = (out.float() - ref.float()).abs().max().item()
        if not (math.isfinite(err) and err <= tol):
            raise ValidationFailed(
                f"flash attention diverged from the pinned-precision "
                f"reference: max abs err {err:.3e} > tolerance {tol:.3e} "
                f"(seq_len={t})")
        return {"seq_len": t, "ok": True, "max_abs_err": err,
                "tolerance": tol}

    def _check_ring_attention(self, mesh, device: torch.device) -> dict:
        """One causal ring-attention pass over the mesh the suite measured,
        the ppermute consumer a sequence-parallel workload runs, checked
        numerically against the pinned-precision reference on one device:
        a bad reduction or a corrupted hop shows up as a real mismatch,
        not just as a non-finite value."""
        from tpu_operator_torch.parallel.numerics import attention_tolerance
        from tpu_operator_torch.parallel.ring_attention import (
            reference_attention, ring_attention)
        n = mesh.shape["model"]
        # cap the global sequence: the reference side materialises t×t f32
        # scores on one device, so shrink the per-rank block on big meshes
        t, d = n * min(128, max(8, 4096 // n)), 128
        gen = torch.Generator(device=device).manual_seed(0)
        q, k, v = (torch.randn((t, d), generator=gen, device=device)
                   .to(torch.bfloat16) for _ in range(3))
        out = ring_attention(q, k, v, mesh, "model", causal=True)
        ref = reference_attention(q, k, v, causal=True)
        tol = attention_tolerance(q.dtype, d, platform=device.type)
        err = (out.float() - ref.float()).abs().max().item()
        if not (math.isfinite(err) and err <= tol):
            raise ValidationFailed(
                f"ring attention over the slice fabric diverged from the "
                f"pinned-precision reference: max abs err {err:.3e} > "
                f"tolerance {tol:.3e} (seq_len={t})")
        return {"seq_len": t, "ok": True, "max_abs_err": err,
                "tolerance": tol}

    def validate(self) -> dict:
        from tpu_operator_torch.ops.hbm import ProbeError, hbm_device_gbps
        from tpu_operator_torch.ops.matmul import matmul_device_tflops
        from tpu_operator_torch.utils.device import device_kind
        dev = _check_platform(self.device, self.require_gpu)
        on_gpu = dev.type == "cuda"
        legs = {}   # wall seconds of each leg, each ending in a device sync
        t0 = time.perf_counter()
        dim = self.matmul_dim if on_gpu else min(self.matmul_dim, 512)
        rep = matmul_device_tflops(m=dim, k=dim, n=dim,
                                   depth_hi=64 if on_gpu else 8,
                                   depth_lo=16 if on_gpu else 2,
                                   iters=3, device=dev)
        kind = device_kind(dev)
        peak = eff = None
        matched = False
        if on_gpu:
            peak, eff, matched = _efficiency_gate(rep.tflops, kind,
                                                  self.min_efficiency)
        info = {"devices": torch.cuda.device_count() if on_gpu else 1,
                "platform": dev.type,
                "matmul_tflops": _significant(rep.tflops),
                "efficiency": round(eff, 4) if eff is not None else None,
                # denominator provenance, so a green gate is auditable
                "device_kind": kind, "peak_tflops": peak,
                "peak_matched": matched}
        legs["matmul"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        try:
            # on the card the function defaults own the tuning (256 MiB,
            # second-scale windows); on the CPU a small array keeps the
            # plain path covered
            hbm = (hbm_device_gbps(device=dev) if on_gpu else
                   hbm_device_gbps(size_mb=8, sweeps_hi=8, sweeps_lo=2,
                                   iters=1, device=dev, repeats=1))
        except ProbeError as e:
            raise ValidationFailed(str(e)) from None
        info["hbm_read_gbps"] = _significant(hbm.read_gbps)
        info["hbm_backend"] = hbm.backend
        legs["hbm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["flash_attention"] = self._check_flash(dev, on_gpu)
        legs["flash"] = time.perf_counter() - t0
        ranks = self.ranks if self.ranks is not None else (
            torch.cuda.device_count() if on_gpu else 1)
        if ranks > 1:
            from tpu_operator_torch.parallel.collectives import \
                run_collective_suite
            from tpu_operator_torch.parallel.mesh import MeshPlan, make_mesh
            t0 = time.perf_counter()
            mesh = make_mesh(ranks, MeshPlan(data=1, model=ranks), device=dev)
            reports = run_collective_suite(mesh, "model",
                                           mbytes=self.collective_mb, iters=3)
            info["collectives"] = {r.op: _significant(r.busbw_gbps)
                                   for r in reports}
            legs["collectives"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            info["ring_attention"] = self._check_ring_attention(mesh, dev)
            legs["ring_attention"] = time.perf_counter() - t0
        info["leg_seconds"] = {name: round(s, 4) for name, s in legs.items()}
        return info
