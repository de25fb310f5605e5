"""gRPC wiring for the kubelet device-plugin API without generated stubs.

A copy of ``tpu_operator/deviceplugin/wire.py``.

grpc_tools is not required, so service stubs are wired with grpc's
generic method handlers against the protoc-generated message classes
(deviceplugin_pb2). Method paths must match the kubelet contract:
``/v1beta1.Registration/Register`` and ``/v1beta1.DevicePlugin/<Method>``.
"""

from __future__ import annotations

import grpc

from . import deviceplugin_pb2 as pb

API_VERSION = "v1beta1"
REGISTRATION_SERVICE = "v1beta1.Registration"
DEVICE_PLUGIN_SERVICE = "v1beta1.DevicePlugin"
KUBELET_SOCKET = "kubelet.sock"


def _ser(msg):
    return msg.SerializeToString()


def device_plugin_handler(servicer) -> grpc.GenericRpcHandler:
    """Generic handler exposing ``servicer``'s five DevicePlugin methods."""
    rpcs = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=pb.Empty.FromString,
            response_serializer=_ser),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=pb.Empty.FromString,
            response_serializer=_ser),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=pb.PreferredAllocationRequest.FromString,
            response_serializer=_ser),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=pb.AllocateRequest.FromString,
            response_serializer=_ser),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=pb.PreStartContainerRequest.FromString,
            response_serializer=_ser),
    }
    return grpc.method_handlers_generic_handler(DEVICE_PLUGIN_SERVICE, rpcs)


def registration_handler(register_fn) -> grpc.GenericRpcHandler:
    """Generic handler for the kubelet-side Registration service (used by the
    in-process fake kubelet in tests; the real kubelet implements this)."""
    rpcs = {
        "Register": grpc.unary_unary_rpc_method_handler(
            register_fn,
            request_deserializer=pb.RegisterRequest.FromString,
            response_serializer=_ser),
    }
    return grpc.method_handlers_generic_handler(REGISTRATION_SERVICE, rpcs)


def register_with_kubelet(kubelet_socket: str, endpoint: str,
                          resource_name: str, *,
                          preferred_allocation: bool = True,
                          pre_start_required: bool = False,
                          timeout: float = 10.0) -> None:
    """Call /v1beta1.Registration/Register on the kubelet's socket."""
    with grpc.insecure_channel(f"unix://{kubelet_socket}") as ch:
        grpc.channel_ready_future(ch).result(timeout=timeout)
        register = ch.unary_unary(
            f"/{REGISTRATION_SERVICE}/Register",
            request_serializer=_ser,
            response_deserializer=pb.Empty.FromString)
        register(pb.RegisterRequest(
            version=API_VERSION,
            endpoint=endpoint,
            resource_name=resource_name,
            options=pb.DevicePluginOptions(
                pre_start_required=pre_start_required,
                get_preferred_allocation_available=preferred_allocation)),
            timeout=timeout)


class DevicePluginStub:
    """Client stub for a DevicePlugin server (tests / validator plugin
    component use this to talk to our own plugin over its socket)."""

    def __init__(self, socket_path: str):
        self._ch = grpc.insecure_channel(f"unix://{socket_path}")

    def close(self):
        self._ch.close()

    def _uu(self, method, resp_cls):
        return self._ch.unary_unary(
            f"/{DEVICE_PLUGIN_SERVICE}/{method}",
            request_serializer=_ser,
            response_deserializer=resp_cls.FromString)

    def get_options(self, timeout=5.0) -> pb.DevicePluginOptions:
        return self._uu("GetDevicePluginOptions",
                        pb.DevicePluginOptions)(pb.Empty(), timeout=timeout)

    def list_and_watch(self, timeout=None):
        call = self._ch.unary_stream(
            f"/{DEVICE_PLUGIN_SERVICE}/ListAndWatch",
            request_serializer=_ser,
            response_deserializer=pb.ListAndWatchResponse.FromString)
        return call(pb.Empty(), timeout=timeout)

    def allocate(self, device_ids_per_container: list[list[str]],
                 timeout=5.0) -> pb.AllocateResponse:
        req = pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(device_ids=ids)
            for ids in device_ids_per_container])
        return self._uu("Allocate", pb.AllocateResponse)(req, timeout=timeout)

    def get_preferred_allocation(
            self, available: list[str], must_include: list[str],
            size: int, timeout=5.0) -> pb.PreferredAllocationResponse:
        req = pb.PreferredAllocationRequest(container_requests=[
            pb.ContainerPreferredAllocationRequest(
                available_device_ids=available,
                must_include_device_ids=must_include,
                allocation_size=size)])
        return self._uu("GetPreferredAllocation",
                        pb.PreferredAllocationResponse)(req, timeout=timeout)
