"""Node-side validation components.

The port of ``tpu_operator/validator/components.py``: one component per
subsystem, each writing a JSON status file (``{ts, ok, component, info}``)
into the barrier directory when green; dependents test for its existence
and the metrics exporter reads the measurements in it. The TPU components
become their GPU counterparts:

  libtpu       → driver:            ``libcuda.so.1`` staged and loadable,
                                    ``/dev/nvidia*`` present, and its version
                                    equal to the loaded kernel module's
                                    (``driver_build.py``)
  runtime-hook → container-toolkit: a CDI spec or the containerd drop-in
  fabric       → fabric:            peer access and a ring round trip over
                                    every local card (NVLink), and the
                                    multi-host mesh-port barrier
  workload     → workload:          the device workload below
  plugin       → plugin:            ``nvidia.com/gpu`` in node capacity, then
                                    a child pod consuming one card
  gate         → gate:              wait for other components' status files

``WorkloadComponent.validate()`` runs on the card, in order:

1. the bf16 matmul-chain probe, gated at ``MIN_EFFICIENCY`` of the card's
   data-sheet peak (an unmatched card is an audit flag, never a red node);
2. the HBM read probe on the CUDA read kernel, whose checksum failure is a
   validation failure;
3. one causal flash-attention pass on the CUDA attention kernel, checked
   against the pinned-precision oracle under a derived tolerance.

With more than one rank it goes on with the multi-device leg, on virtual
ranks of its device (``parallel/mesh.py``), and says so in the status
(``"fabric": "loopback"`` and ``ranks_device``):

4. the collective bandwidth suite over a (1, ranks) mesh's model axis,
   which on the card includes the hand-scheduled ring all-reduces;
5. one causal ring-attention pass over the same mesh, checked against the
   oracle on one device under the same derived tolerance.

On the card it ends by recording the loaded kernel module's version for the
driver component and the metrics agent, and fails on skew against the
staged library.
"""

from __future__ import annotations

import ctypes
import glob
import json
import logging
import math
import os
import time

import torch

log = logging.getLogger("gpu-validator")

DEFAULT_VALIDATIONS_DIR = "/run/nvidia/validations"
RETRY_INTERVAL_S = 5          # reference: validator/main.go:127
POD_WAIT_TRIES = 60           # reference: 60 x 5 s pod wait (:158-161)
RESOURCE_WAIT_TRIES = 30      # reference: 30 x 5 s resource wait (:162-165)


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


def _driver_root_default() -> str:
    return os.environ.get("NVIDIA_DRIVER_ROOT", "/")


class DriverComponent(Component):
    """The driver's user-space library staged and loadable, the device nodes
    present, and the library's version equal to the loaded kernel
    module's."""

    name = "driver"
    #: where the driver container stages ``libcuda.so.1``, under the root
    LIBRARY_DIRS = ("usr/lib/x86_64-linux-gnu", "usr/lib64",
                    "lib/x86_64-linux-gnu", "lib64", "usr/lib", "lib")
    DEFAULT_DEVICE_GLOB = "/dev/nvidia[0-9]*"

    def __init__(self, driver_root: str | None = None,
                 device_glob: str | None = None, observer: bool = False,
                 **kw):
        super().__init__(**kw)
        self.driver_root = driver_root or _driver_root_default()
        self.device_glob = device_glob or os.environ.get(
            "GPU_DEVICE_GLOB", self.DEFAULT_DEVICE_GLOB)
        # observer=True: a read-only caller (the metrics revalidation loop)
        # that must never consume the one-shot runtime-build record — the
        # consume exists so the VALIDATION pipeline re-derives truth via
        # workload validation, but a pure observer has no workload step to
        # re-record, and consuming would self-clear the skew alert within
        # one poll period while the node is still broken
        self.observer = observer

    def find_library(self) -> str | None:
        for d in self.LIBRARY_DIRS:
            cand = os.path.join(self.driver_root, d, "libcuda.so.1")
            if os.path.exists(cand):
                return cand
        return None

    def find_devices(self) -> list[str]:
        # no fallback: a glob that matches nothing fails
        return sorted(glob.glob(self.device_glob))

    def loadable(self, path: str) -> bool:
        try:
            ctypes.CDLL(path)
            return True
        except OSError:
            return False

    def check_skew(self, lib: str) -> dict:
        """Compare the staged library's version against the recorded
        RUNNING kernel module's (written by workload validation; see
        ``driver_build``). A mismatch means a driver upgrade is half done:
        every CUDA call fails with "Driver/library version mismatch", so it
        must fail validation here, until the node reboots or reloads the
        module onto the new version.

        The record is a ONE-SHOT witness: this component cannot tell
        "module still on the old version" from "module already reloaded,
        record stale". On mismatch the record is consumed before raising,
        so the next attempt passes this gate and reaches workload
        validation, which reads the module afresh: a genuinely skewed node
        fails there (and re-records the truth); a recovered node goes
        green. Without the consume, a stale record would wedge this --wait
        init container forever, since the only writer of the record runs
        after it."""
        from tpu_operator_torch.validator.driver_build import (
            build_epoch, consume_runtime_build, extract_build,
            read_runtime_build)
        build = extract_build(lib)
        runtime = read_runtime_build(self.dir)
        client_epoch, runtime_epoch = build_epoch(build), build_epoch(runtime)
        skew = (client_epoch is not None and runtime_epoch is not None
                and client_epoch != runtime_epoch)
        info = {"build": build, "runtime_build_epoch": runtime_epoch,
                "client_build_epoch": client_epoch, "skew": skew}
        if skew:
            if not self.observer:
                consume_runtime_build(self.dir)
            raise ValidationFailed(
                f"driver version skew: staged user-space library "
                f"({client_epoch}) != recorded kernel module "
                f"({runtime_epoch}) — CUDA calls would fail with "
                f"'Driver/library version mismatch' (driver upgrade "
                f"mid-flight?)"
                + ("" if self.observer else
                   "; record consumed, live verification follows in "
                   "workload validation"))
        return info

    def validate(self) -> dict:
        lib = self.find_library()
        if lib is None:
            raise ValidationFailed(
                f"libcuda.so.1 not found under {self.driver_root}")
        if not self.loadable(lib):
            raise ValidationFailed(f"{lib} exists but dlopen failed")
        devs = self.find_devices()
        if not devs:
            raise ValidationFailed(
                f"no GPU device nodes matching {self.device_glob}")
        return {"library": lib, "devices": devs, **self.check_skew(lib)}


class ContainerToolkitComponent(Component):
    """A CDI spec or the containerd drop-in of the NVIDIA container toolkit
    is in place."""

    name = "container-toolkit"

    def __init__(self, cdi_spec_dir: str | None = None,
                 containerd_config: str | None = None, **kw):
        super().__init__(**kw)
        self.cdi_spec_dir = cdi_spec_dir or os.environ.get(
            "CDI_SPEC_DIR", "/etc/cdi")
        self.containerd_config = containerd_config or os.environ.get(
            "CONTAINERD_CONFIG", "/etc/containerd/config.toml")

    def validate(self) -> dict:
        cdi = glob.glob(os.path.join(self.cdi_spec_dir, "nvidia*.json")) + \
            glob.glob(os.path.join(self.cdi_spec_dir, "nvidia*.yaml"))
        drop_in = os.path.join(
            os.path.dirname(self.containerd_config), "conf.d",
            "nvidia-container-runtime.toml")
        if not cdi and not os.path.exists(drop_in):
            raise ValidationFailed(
                f"neither CDI spec in {self.cdi_spec_dir} nor containerd "
                f"drop-in {drop_in} present")
        return {"cdi_specs": cdi,
                "containerd_drop_in": drop_in if os.path.exists(drop_in)
                else None}


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
                 ranks: int | None = None, driver_root: str | None = None,
                 **kw):
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
        self.driver_root = driver_root or _driver_root_default()

    def _record_runtime_build(self) -> None:
        """The card has just run the probes, so the loaded kernel module is
        the running driver: record its version for the driver component
        and the metrics agent (``driver_build``), and fail on skew against
        the staged library, whose every CUDA call on this node would fail
        with "Driver/library version mismatch"."""
        from tpu_operator_torch.validator.driver_build import (
            build_epoch, extract_build, kernel_module_version,
            record_runtime_build)
        module = kernel_module_version(self.driver_root)
        if module is None:
            return
        if not record_runtime_build(self.dir, module):
            log.warning("could not record runtime build under %s — the "
                        "driver component and metrics agent will lack the "
                        "runtime side of the skew comparison", self.dir)
        staged = DriverComponent(validations_dir=self.dir,
                                 driver_root=self.driver_root).find_library()
        client_epoch = build_epoch(extract_build(staged)) if staged else None
        runtime_epoch = build_epoch(module)
        if client_epoch is not None and runtime_epoch is not None \
                and client_epoch != runtime_epoch:
            raise ValidationFailed(
                f"driver version skew: staged user-space library "
                f"({client_epoch}) != loaded kernel module "
                f"({runtime_epoch}, from {self.driver_root}) — module "
                f"reload or reboot required (driver upgrade mid-flight?)")

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
            # every rank lies on one device: the figures cross no link
            info["fabric"] = "loopback"
            info["ranks_device"] = str(dev)
            legs["collectives"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            info["ring_attention"] = self._check_ring_attention(mesh, dev)
            legs["ring_attention"] = time.perf_counter() - t0
        info["leg_seconds"] = {name: round(s, 4) for name, s in legs.items()}
        if on_gpu:
            self._record_runtime_build()
        return info


class PluginComponent(Component):
    """Wait for the GPU resource in node capacity, then run a child pod
    consuming one card (reference: Plugin.validate + workload pod,
    validator/main.go:797-839,925-1008,1096-1116)."""

    name = "plugin"

    def __init__(self, client=None, node_name: str | None = None,
                 namespace: str | None = None,
                 resource_name: str | None = None,
                 image: str | None = None,
                 resource_wait_tries: int = RESOURCE_WAIT_TRIES, **kw):
        super().__init__(**kw)
        self.resource_wait_tries = resource_wait_tries
        self.client = client
        self.node_name = node_name or os.environ.get("NODE_NAME", "")
        self.namespace = namespace or os.environ.get(
            "GPU_OPERATOR_NAMESPACE",
            os.environ.get("OPERATOR_NAMESPACE", "gpu-operator"))
        self.resource_name = resource_name or os.environ.get(
            "GPU_RESOURCE_NAME", "nvidia.com/gpu")
        self.image = image or os.environ.get("VALIDATOR_IMAGE", "")
        self.pod_name = f"gpu-plugin-validator-{self.node_name}"

    def _client(self):
        if self.client is None:
            from tpu_operator_torch.kube.incluster import InClusterClient
            self.client = InClusterClient()
        return self.client

    def resource_advertised(self) -> bool:
        node = self._client().get("Node", self.node_name)
        cap = node.get("status", "capacity", default={}) or {}
        try:
            return int(cap.get(self.resource_name, "0")) > 0
        except ValueError:
            return False

    def child_pod(self) -> dict:
        return {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": self.pod_name,
                         "namespace": self.namespace,
                         "labels": {"app": "gpu-plugin-validator"}},
            "spec": {
                "restartPolicy": "Never",
                "nodeName": self.node_name,
                "tolerations": [
                    {"key": "nvidia.com/gpu", "operator": "Exists"}],
                "containers": [{
                    "name": "workload",
                    "image": self.image,
                    "command": ["gpu-validator", "--component", "workload",
                                "--no-status-file"],
                    "resources": {"limits": {self.resource_name: "1"}},
                }],
            },
        }

    def validate(self) -> dict:
        from tpu_operator_torch.kube.client import (AlreadyExistsError,
                                                    KubeError)
        from tpu_operator_torch.kube.objects import Obj
        try:
            client = self._client()
        except KubeError as e:
            # outside a cluster: a failed validation, not a crash
            raise ValidationFailed(f"no API server: {e}") from None
        for _ in range(self.resource_wait_tries):
            try:
                if self.resource_advertised():
                    break
            except KubeError as e:
                # transient apiserver trouble consumes a retry, never crashes
                log.warning("resource check failed: %s", e)
            time.sleep(self.retry_interval)
        else:
            raise ValidationFailed(
                f"{self.resource_name} never appeared in node capacity")
        # delete stale pod, create fresh, poll to completion
        try:
            client.delete("Pod", self.pod_name, self.namespace)
            client.create(Obj(self.child_pod()))
        except AlreadyExistsError:
            raise ValidationFailed(
                "previous validation pod still terminating") from None
        except KubeError as e:
            raise ValidationFailed(f"cannot create workload pod: {e}") \
                from None
        try:
            for _ in range(POD_WAIT_TRIES):
                try:
                    pod = client.get("Pod", self.pod_name, self.namespace)
                except KubeError as e:
                    log.warning("pod poll failed: %s", e)
                    time.sleep(self.retry_interval)
                    continue
                phase = pod.get("status", "phase")
                if phase == "Succeeded":
                    return {"resource": self.resource_name,
                            "pod": self.pod_name}
                if phase == "Failed":
                    raise ValidationFailed(f"workload pod failed: "
                                           f"{pod.get('status', 'message')}")
                time.sleep(self.retry_interval)
            raise ValidationFailed("workload pod did not complete in time")
        finally:
            try:
                client.delete("Pod", self.pod_name, self.namespace)
            except KubeError as e:
                log.warning("cleanup failed: %s", e)


class FabricComponent(Component):
    """The interconnect, attested by use: NVLink between the local cards,
    and the network between the hosts of a multi-node job.

    Reference analogue: the mofed component (validator/main.go:841-906) and
    the TPU reference's ICI/DCN check. Here:

      NVLink: every local card must reach every other — peer access for
              every ordered pair, then a ring pass that carries each card's
              index all the way around and back; a wrong or stale link
              corrupts the round trip.
      hosts:  when the job spans hosts (``WORKER_HOSTNAMES`` set), each
              peer hostname must resolve and accept a TCP connection on
              the mesh port — the reachability a multi-node rendezvous
              needs before a program can start.
    """

    name = "fabric"

    #: the multi-node rendezvous port (torch.distributed's default).
    DEFAULT_MESH_PORT = 29500

    def __init__(self, mesh_port: int | None = None,
                 expected_topology: str | None = None,
                 resolver=None, connector=None,
                 require_gpu: bool | None = None, devices=None, **kw):
        super().__init__(**kw)
        self.require_gpu = (require_gpu if require_gpu is not None
                            else _require_gpu_default())
        self.devices = devices      # None: every CUDA device
        self.mesh_port = int(mesh_port or os.environ.get(
            "MESH_PORT", self.DEFAULT_MESH_PORT))
        self.expected_topology = expected_topology or os.environ.get(
            "EXPECTED_TOPOLOGY")
        self._resolver = resolver    # injectable for unit tests
        self._connector = connector
        self._listener = None
        # how long a worker that passed keeps serving the mesh port so
        # slower peers can still complete their probe against it
        self.linger_s = float(os.environ.get("DCN_BARRIER_LINGER_S",
                                             2 * RETRY_INTERVAL_S))

    # -- NVLink ------------------------------------------------------------
    def check_nvlink(self, devices=None) -> dict:
        """Peer access between every ordered pair of ``devices`` (every
        CUDA device when None) that are cards, then a ring round trip:
        ``arange(n)``, one element on each device, carried n hops around
        the devices, must come back equal."""
        if devices is None:
            _check_platform("cuda", self.require_gpu)
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [_check_platform(d, self.require_gpu) for d in devices]
        n = len(devices)
        info: dict = {"local_devices": n,
                      "platform": devices[0].type if n else None}
        if n < 2:
            info["nvlink"] = "skipped (single device)"
            return info
        cards = [d.index for d in devices if d.type == "cuda"]
        no_peer = [(a, b) for a in cards for b in cards
                   if a != b and not torch.cuda.can_device_access_peer(a, b)]
        if no_peer:
            raise ValidationFailed(
                "no peer access between cards "
                + ", ".join(f"{a}->{b}" for a, b in no_peer))
        x = torch.arange(n, dtype=torch.int32)
        v = [x[i:i + 1].to(devices[i]) for i in range(n)]
        for _ in range(n):          # full circuit: every link exercised
            v = [v[(i - 1) % n].to(devices[i], copy=True) for i in range(n)]
        if not torch.equal(torch.cat([s.cpu() for s in v]), x):
            raise ValidationFailed(
                "NVLink ring round-trip corrupted: a card-to-card link "
                "returned wrong data")
        info["nvlink"] = f"ring round-trip ok over {n} devices"
        return info

    # -- topology cross-check ---------------------------------------------
    @staticmethod
    def parse_topology(s: str) -> int:
        dims = [int(p) for p in s.lower().split("x")]
        if not dims or any(d <= 0 for d in dims):
            raise ValueError(s)
        out = 1
        for d in dims:
            out *= d
        return out

    def check_topology(self, local_devices: int, n_workers: int) -> dict:
        if not self.expected_topology:
            return {}
        try:
            chips = self.parse_topology(self.expected_topology)
        except ValueError:
            raise ValidationFailed(
                f"malformed EXPECTED_TOPOLOGY {self.expected_topology!r}") \
                from None
        expected_local = chips // max(n_workers, 1)
        if local_devices and expected_local != local_devices:
            raise ValidationFailed(
                f"topology {self.expected_topology} over {n_workers} "
                f"worker(s) implies {expected_local} local card(s); "
                f"torch sees {local_devices}")
        return {"topology": self.expected_topology, "slice_chips": chips}

    # -- hosts -------------------------------------------------------------
    def peers(self) -> list[str]:
        hosts = os.environ.get("WORKER_HOSTNAMES", "")
        return [h.strip() for h in hosts.split(",") if h.strip()]

    def check_dcn(self, peers: list[str]) -> dict:
        import socket
        worker_id = os.environ.get("WORKER_ID")
        if worker_id is not None:
            try:
                wid = int(worker_id)
            except ValueError:
                raise ValidationFailed(
                    f"malformed WORKER_ID {worker_id!r}") from None
            if wid < 0 or wid >= len(peers):
                raise ValidationFailed(
                    f"WORKER_ID {wid} out of range for "
                    f"{len(peers)} worker hostname(s)")

        def connect(host: str) -> None:
            if self._connector is not None:
                return self._connector(host, self.mesh_port)
            with socket.create_connection((host, self.mesh_port),
                                          timeout=5):
                pass

        # On an idle healthy node nothing listens on the mesh port (the
        # rendezvous only opens it while a job runs), so each validator
        # serves the port itself while probing: peers whose validator hasn't
        # started yet refuse, --wait retries, and the check converges as a
        # cross-host barrier once every worker's listener is up. The
        # listener persists across retry attempts (closing it between
        # attempts would shrink each worker's listen window to milliseconds
        # and the barrier would never converge), and on success the worker
        # lingers for ``linger_s`` so slower peers still find the port
        # open. EADDRINUSE means a live job is already serving the port —
        # also fine.
        self._ensure_listener(backlog=max(len(peers), 8))
        unreachable = []
        for host in peers:
            try:
                if self._resolver is not None:
                    self._resolver(host, self.mesh_port)
                connect(host)
            except OSError as e:
                unreachable.append(f"{host}:{self.mesh_port} ({e})")
        if unreachable:
            raise ValidationFailed(
                "DCN peers unreachable: " + "; ".join(unreachable))
        if self._listener is not None and self.linger_s > 0:
            time.sleep(self.linger_s)
        self._close_listener()
        return {"workers": len(peers), "mesh_port": self.mesh_port}

    def _ensure_listener(self, backlog: int = 8):
        import socket
        import threading
        if self._connector is not None or self._listener is not None:
            return
        try:
            listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            listener.bind(("", self.mesh_port))
            listener.listen(backlog)
        except OSError:
            listener.close()
            return  # a live job already serves the port
        self._listener = listener

        def drain():  # complete peer handshakes so the backlog never fills
            while True:
                try:
                    conn, _ = listener.accept()
                    conn.close()
                except OSError:
                    return
        threading.Thread(target=drain, daemon=True).start()

    def _close_listener(self):
        import socket
        if self._listener is not None:
            # shutdown() wakes the drain thread's blocking accept(); a bare
            # close() would leave the kernel holding the port until that
            # accept syscall returns (i.e. forever)
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()
            self._listener = None

    def abort(self):
        # the listener deliberately persists across retry attempts (barrier
        # convergence); once the runner stops retrying it must not keep the
        # mesh port bound — a job may legitimately serve it later
        self._close_listener()

    def check_multislice_env(self) -> dict:
        """When the CR enabled multi-node jobs, the injection chain (feature
        discovery → worker-env file → node agent CDI/OCI) must have landed
        worker identity in this container — its absence means the
        rendezvous would fail at job start (reference analogue: RDMA env
        gating, object_controls.go:2632-2647)."""
        if os.environ.get("MULTINODE_ENABLED", "").lower() != "true":
            return {}
        missing = [k for k in ("WORKER_ID", "WORKER_HOSTNAMES")
                   if not os.environ.get(k)]
        if missing:
            raise ValidationFailed(
                "multi-node enabled but worker identity not injected: "
                + ", ".join(missing) + " unset — check the feature-"
                "discovery worker-env file and the container toolkit's CDI "
                "spec")
        return {"multislice": "worker identity injected"}

    def validate(self) -> dict:
        info = self.check_nvlink(self.devices)
        peers = self.peers()
        info.update(self.check_topology(info.get("local_devices", 0),
                                        max(len(peers), 1)))
        info.update(self.check_multislice_env())
        if len(peers) > 1:
            info.update(self.check_dcn(peers))
        else:
            info["dcn"] = "skipped (single-host node)"
        return info


class GateComponent(Component):
    """Block until the named status files exist — the init-container barrier
    injected into every dependent operand (reference:
    transformValidationInitContainer, object_controls.go:2895-2934)."""

    name = "gate"

    def __init__(self, gates: list[str] | None = None, **kw):
        super().__init__(**kw)
        if not gates:
            # an empty barrier is a misconfigured init container, not a pass
            raise ValueError("gate component requires a non-empty gate list")
        self.gates = gates

    def validate(self) -> dict:
        missing = [g for g in self.gates if not self.status_exists(g)]
        if missing:
            raise ValidationFailed(f"waiting for: {', '.join(missing)}")
        return {"gates": self.gates}

    def run(self) -> dict:  # gates never write their own status file
        tries = self.max_tries
        for i in range(tries):
            try:
                return self.validate()
            except ValidationFailed as e:
                if i + 1 < tries:
                    time.sleep(self.retry_interval)
                else:
                    raise ValidationFailed(f"{self.name}: {e}") from None


VALID_COMPONENTS = ("driver", "container-toolkit", "fabric", "workload",
                    "plugin", "gate")


def build_component(name: str, **kw) -> Component:
    cls = {
        "driver": DriverComponent,
        "container-toolkit": ContainerToolkitComponent,
        "fabric": FabricComponent,
        "workload": WorkloadComponent,
        "plugin": PluginComponent,
        "gate": GateComponent,
    }.get(name)
    if cls is None:
        raise ValueError(
            f"unknown component {name!r}; valid: "
            f"{', '.join(VALID_COMPONENTS)}")
    return cls(**kw)
