"""GPU device plugin: kubelet device-plugin API (v1beta1) server.

The port of ``tpu_operator/deviceplugin``: it discovers ``/dev/nvidiaN``
device nodes (``discovery``), advertises them as the ``nvidia.com/gpu``
extended resource and injects device nodes, the driver library and
``NVIDIA_VISIBLE_DEVICES``, or CDI device references, into allocated
containers (``plugin``).

``GpuDevicePlugin`` is imported on first access, not with the package: the
health probes and feature discovery need ``discovery`` on hosts without
gRPC, and ``plugin`` imports gRPC and protobuf.
"""

from .discovery import GpuDevice, GpuDiscovery

__all__ = ["GpuDevice", "GpuDiscovery", "GpuDevicePlugin"]


def __getattr__(name):
    if name == "GpuDevicePlugin":
        from .plugin import GpuDevicePlugin
        return GpuDevicePlugin
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
