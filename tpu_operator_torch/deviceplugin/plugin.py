"""The GPU device plugin server.

The port of ``tpu_operator/deviceplugin/plugin.py`` (``TpuDevicePlugin`` →
``GpuDevicePlugin``). Lifecycle mirrors the standard kubelet device-plugin
dance: serve the DevicePlugin service on a unix socket under the kubelet
plugin dir, then dial ``kubelet.sock`` and Register; kubelet calls back
over our socket. ListAndWatch streams the card inventory and re-sends on
any health/count change. Allocate injects, per the configured strategy,
either the cards' device nodes, the driver's control nodes, an optional
read-only mount of the host's ``libcuda.so.1`` and
``NVIDIA_VISIBLE_DEVICES`` ("device"), or CDI device references
(``nvidia.com/gpu=<index>``, the names the NVIDIA container toolkit's CDI
spec gives) that the runtime resolves ("cdi").

Both name a card by the minor number of its device node. The NVIDIA
toolkit reads an index in its NVML order there, which is the same number
where the driver numbered the nodes in that order, as it does by default.

The reference's ``TPU_CHIPS_PER_HOST_BOUNDS``, ``TPU_ACCELERATOR_TYPE`` and
its freeze of the host's chip count serve only the ICI bounds and have no
counterpart here.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures

import grpc

from . import deviceplugin_pb2 as pb
from .discovery import HEALTHY, GpuDiscovery
from .wire import KUBELET_SOCKET, device_plugin_handler, register_with_kubelet

log = logging.getLogger("gpu-device-plugin")

RESOURCE_NAME = "nvidia.com/gpu"
#: the CDI kind of a whole card in the NVIDIA toolkit's generated spec
CDI_KIND = "nvidia.com/gpu"
#: driver nodes every CUDA container needs beside its cards' nodes, passed
#: through where they exist under the device root
CONTROL_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")
VISIBLE_DEVICES_ENV = "NVIDIA_VISIBLE_DEVICES"
DRIVER_LIB_CONTAINER_PATH = "/usr/lib/x86_64-linux-gnu/libcuda.so.1"


def _socket_name(resource_name: str) -> str:
    return resource_name.replace("/", "-").replace(".", "-") + ".sock"


class GpuDevicePlugin:
    def __init__(self, *,
                 resource_name: str = RESOURCE_NAME,
                 plugin_dir: str = "/var/lib/kubelet/device-plugins",
                 discovery: GpuDiscovery | None = None,
                 strategy: str = "device",          # "device" | "cdi"
                 driver_lib_host_path: str | None = None,
                 poll_seconds: float = 5.0):
        if strategy not in ("device", "cdi"):
            raise ValueError(f"strategy {strategy!r} not one of device|cdi")
        self.resource_name = resource_name
        self.plugin_dir = plugin_dir
        self.discovery = discovery or GpuDiscovery()
        self.strategy = strategy
        self.driver_lib_host_path = driver_lib_host_path
        self.poll_seconds = poll_seconds
        self.socket_path = os.path.join(plugin_dir,
                                        _socket_name(resource_name))
        self._server: grpc.Server | None = None
        self._stop = threading.Event()
        self._changed = threading.Event()

    def control_nodes(self) -> list[str]:
        """The driver's control nodes present under the device root."""
        root = self.discovery.dev_root
        return [os.path.join(root, n) for n in CONTROL_NODES
                if os.path.exists(os.path.join(root, n))]

    # -- DevicePlugin service ------------------------------------------------
    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(
            pre_start_required=False,
            get_preferred_allocation_available=True)

    def _device_list(self) -> list[pb.Device]:
        return [pb.Device(id=d.id, health=d.health)
                for d in self.discovery.scan()]

    def ListAndWatch(self, request, context):
        last: list[tuple[str, str]] | None = None
        while not self._stop.is_set():
            devices = self._device_list()
            key = [(d.id, d.health) for d in devices]
            if key != last:
                last = key
                log.info("advertising %d device(s): %s", len(devices),
                         ["%s/%s" % k for k in key])
                yield pb.ListAndWatchResponse(devices=devices)
            self._changed.wait(self.poll_seconds)
            self._changed.clear()

    def GetPreferredAllocation(self, request, context):
        """Prefer a contiguous index run: the reference's window over the
        sorted availability, kept as is (on a board whose cards sit on one
        NVSwitch every pick is alike, and a contiguous run is then as good
        as any)."""
        index_of = {d.id: d.index for d in self.discovery.scan()}

        def _idx(device_id: str) -> int:
            if device_id in index_of:
                return index_of[device_id]
            digits = "".join(ch for ch in device_id if ch.isdigit())
            return int(digits) if digits else 0

        resp = pb.PreferredAllocationResponse()
        for creq in request.container_requests:
            avail = sorted(creq.available_device_ids, key=_idx)
            picked = list(creq.must_include_device_ids)
            # extend the must-include set with the contiguous run that wastes
            # the fewest gaps: slide a window over the sorted availability
            need = creq.allocation_size - len(picked)
            rest = [a for a in avail if a not in picked]
            best = rest[:max(need, 0)]
            if need > 0 and len(rest) >= need:
                idx = [_idx(a) for a in rest]
                best_span = None
                for s in range(len(rest) - need + 1):
                    span = idx[s + need - 1] - idx[s]
                    if best_span is None or span < best_span:
                        best_span, best = span, rest[s:s + need]
            resp.container_responses.append(
                pb.ContainerPreferredAllocationResponse(
                    device_ids=picked + best))
        return resp

    def Allocate(self, request, context):
        devices = {d.id: d for d in self.discovery.scan()}
        resp = pb.AllocateResponse()
        for creq in request.container_requests:
            car = pb.ContainerAllocateResponse()
            indices = []
            for did in creq.device_ids:
                dev = devices.get(did)
                if dev is None or dev.health != HEALTHY:
                    context.abort(grpc.StatusCode.INVALID_ARGUMENT,
                                  f"unknown or unhealthy device {did!r}")
                # a slice-aware unit (an NVLink group) expands into its
                # member cards
                indices.extend(dev.member_indices)
                if self.strategy == "cdi":
                    for index in dev.member_indices:
                        car.cdi_devices.append(pb.CDIDevice(
                            name=f"{CDI_KIND}={index}"))
                else:
                    for path in dev.member_paths:
                        car.devices.append(pb.DeviceSpec(
                            container_path=path, host_path=path,
                            permissions="rw"))
            if self.strategy == "device":
                for path in self.control_nodes():
                    car.devices.append(pb.DeviceSpec(
                        container_path=path, host_path=path,
                        permissions="rw"))
            indices.sort()
            car.envs[VISIBLE_DEVICES_ENV] = ",".join(map(str, indices))
            if self.strategy == "device" and self.driver_lib_host_path:
                car.mounts.append(pb.Mount(
                    container_path=DRIVER_LIB_CONTAINER_PATH,
                    host_path=self.driver_lib_host_path, read_only=True))
            resp.container_responses.append(car)
        return resp

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> None:
        """Bind and serve the plugin socket (does not register)."""
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._stop.clear()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        self._server.add_generic_rpc_handlers((device_plugin_handler(self),))
        self._server.add_insecure_port(f"unix://{self.socket_path}")
        self._server.start()
        log.info("serving %s on %s", self.resource_name, self.socket_path)

    def register(self, timeout: float = 10.0) -> None:
        register_with_kubelet(
            os.path.join(self.plugin_dir, KUBELET_SOCKET),
            endpoint=os.path.basename(self.socket_path),
            resource_name=self.resource_name, timeout=timeout)
        log.info("registered %s with kubelet", self.resource_name)

    def _register_with_retry(self) -> None:
        """Retry until kubelet accepts the registration — the plugin may come
        up before kubelet, and kubelet restarts leave a window where the
        socket exists but the Registration service is not serving yet."""
        while not self._stop.is_set():
            try:
                self.register()
                return
            except grpc.RpcError as e:
                log.warning("kubelet registration failed (%s); retrying",
                            e.code() if hasattr(e, "code") else e)
            except (grpc.FutureTimeoutError, OSError) as e:
                log.warning("kubelet not reachable (%s); retrying", e)
            self._stop.wait(self.poll_seconds)

    def notify_changed(self) -> None:
        self._changed.set()

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        self._changed.set()
        if self._server is not None:
            self._server.stop(grace).wait()
            self._server = None
        if os.path.exists(self.socket_path):
            try:
                os.unlink(self.socket_path)
            except OSError:
                pass

    def run_forever(self) -> None:
        """start + register, then watch for kubelet restarts (plugin-dir
        socket recreation) and re-register — the standard plugin resilience
        loop."""
        self.start()
        self._register_with_retry()
        kubelet_sock = os.path.join(self.plugin_dir, KUBELET_SOCKET)
        try:
            ino = os.stat(kubelet_sock).st_ino
        except OSError:
            ino = None
        try:
            while not self._stop.wait(self.poll_seconds):
                try:
                    now = os.stat(kubelet_sock).st_ino
                except OSError:
                    continue
                if ino is not None and now != ino:
                    log.warning("kubelet restart detected; re-registering")
                    self._register_with_retry()
                ino = now
        finally:
            self.stop()
