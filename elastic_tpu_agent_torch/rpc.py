"""Hand-wired gRPC plumbing for the kubelet's device-plugin API.

The device-plugin half of ``elastic_tpu_agent/rpc.py``: with no generated
``*_pb2_grpc.py`` stubs, the kubelet's method paths
(``/v1beta1.Registration/Register``, ``/v1beta1.DevicePlugin/*``) are bound
explicitly against grpcio's generic handler API. The pod-resources client
waits for the port's locator.

This is the one module of the agent side that imports ``grpc`` at module
level; the plugins' allocation logic (``plugins/gpushare.py``) does not, so
that it runs where grpcio and protobuf are not installed.
"""

from __future__ import annotations

from typing import Callable, Iterable

import grpc

from .common import DEVICE_PLUGIN_VERSION
from .gen import deviceplugin_pb2 as dp

# The reference's 16 MiB cap on one message (locator.go:34). A
# ListAndWatch response of the memory resource grows with the cards'
# memory: one unit a MiB.
MAX_MSG_BYTES = 16 * 1024 * 1024

_CHANNEL_OPTS = [
    ("grpc.max_receive_message_length", MAX_MSG_BYTES),
    ("grpc.max_send_message_length", MAX_MSG_BYTES),
]


def unix_target(path: str) -> str:
    return f"unix:{path}"


def dial(path: str, timeout_s: float = 5.0) -> grpc.Channel:
    """Dial a unix socket and block until connected (the reference's
    dial-probe, base.go:185-196); raises on timeout."""
    ch = grpc.insecure_channel(unix_target(path), options=_CHANNEL_OPTS)
    grpc.channel_ready_future(ch).result(timeout=timeout_s)
    return ch


# -- DevicePlugin service -------------------------------------------------------


def add_device_plugin_servicer(server: grpc.Server, servicer) -> None:
    """Serve ``servicer``'s five kubelet RPCs (``plugins/gpushare.py``'s
    plugins implement them; the agent's ``DevicePluginServicer`` base is
    not copied, since subclassing this module would bring grpc into the
    allocation logic)."""
    handlers = {
        "GetDevicePluginOptions": grpc.unary_unary_rpc_method_handler(
            servicer.GetDevicePluginOptions,
            request_deserializer=dp.Empty.FromString,
            response_serializer=dp.DevicePluginOptions.SerializeToString,
        ),
        "ListAndWatch": grpc.unary_stream_rpc_method_handler(
            servicer.ListAndWatch,
            request_deserializer=dp.Empty.FromString,
            response_serializer=dp.ListAndWatchResponse.SerializeToString,
        ),
        "GetPreferredAllocation": grpc.unary_unary_rpc_method_handler(
            servicer.GetPreferredAllocation,
            request_deserializer=dp.PreferredAllocationRequest.FromString,
            response_serializer=dp.PreferredAllocationResponse.SerializeToString,
        ),
        "Allocate": grpc.unary_unary_rpc_method_handler(
            servicer.Allocate,
            request_deserializer=dp.AllocateRequest.FromString,
            response_serializer=dp.AllocateResponse.SerializeToString,
        ),
        "PreStartContainer": grpc.unary_unary_rpc_method_handler(
            servicer.PreStartContainer,
            request_deserializer=dp.PreStartContainerRequest.FromString,
            response_serializer=dp.PreStartContainerResponse.SerializeToString,
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("v1beta1.DevicePlugin", handlers),)
    )


class DevicePluginClient:
    """Client for a device-plugin server (tests play the kubelet's part
    with it)."""

    def __init__(self, channel: grpc.Channel) -> None:
        p = "/v1beta1.DevicePlugin/"
        self._options = channel.unary_unary(
            p + "GetDevicePluginOptions",
            request_serializer=dp.Empty.SerializeToString,
            response_deserializer=dp.DevicePluginOptions.FromString,
        )
        self._law = channel.unary_stream(
            p + "ListAndWatch",
            request_serializer=dp.Empty.SerializeToString,
            response_deserializer=dp.ListAndWatchResponse.FromString,
        )
        self._alloc = channel.unary_unary(
            p + "Allocate",
            request_serializer=dp.AllocateRequest.SerializeToString,
            response_deserializer=dp.AllocateResponse.FromString,
        )
        self._prestart = channel.unary_unary(
            p + "PreStartContainer",
            request_serializer=dp.PreStartContainerRequest.SerializeToString,
            response_deserializer=dp.PreStartContainerResponse.FromString,
        )
        self._preferred = channel.unary_unary(
            p + "GetPreferredAllocation",
            request_serializer=dp.PreferredAllocationRequest.SerializeToString,
            response_deserializer=dp.PreferredAllocationResponse.FromString,
        )

    def get_options(self) -> dp.DevicePluginOptions:
        return self._options(dp.Empty())

    def list_and_watch(self) -> Iterable[dp.ListAndWatchResponse]:
        return self._law(dp.Empty())

    def allocate(self, device_ids: Iterable[str]) -> dp.AllocateResponse:
        return self._alloc(
            dp.AllocateRequest(
                container_requests=[
                    dp.ContainerAllocateRequest(devicesIDs=list(device_ids))
                ]
            )
        )

    def pre_start_container(self, device_ids: Iterable[str]) -> dp.PreStartContainerResponse:
        return self._prestart(
            dp.PreStartContainerRequest(devicesIDs=list(device_ids))
        )

    def get_preferred_allocation(
        self, available: Iterable[str], must_include: Iterable[str], size: int
    ) -> dp.PreferredAllocationResponse:
        return self._preferred(
            dp.PreferredAllocationRequest(
                container_requests=[
                    dp.ContainerPreferredAllocationRequest(
                        available_deviceIDs=list(available),
                        must_include_deviceIDs=list(must_include),
                        allocation_size=size,
                    )
                ]
            )
        )


# -- Registration service ------------------------------------------------------


class RegistrationClient:
    """Register a plugin endpoint with kubelet (reference: base.go:141-160)."""

    def __init__(self, kubelet_socket: str) -> None:
        self._socket = kubelet_socket

    def register(
        self,
        endpoint: str,
        resource_name: str,
        pre_start_required: bool = True,
        timeout_s: float = 10.0,
    ) -> None:
        ch = dial(self._socket, timeout_s)
        try:
            method = ch.unary_unary(
                "/v1beta1.Registration/Register",
                request_serializer=dp.RegisterRequest.SerializeToString,
                response_deserializer=dp.Empty.FromString,
            )
            method(
                dp.RegisterRequest(
                    version=DEVICE_PLUGIN_VERSION,
                    endpoint=endpoint,
                    resource_name=resource_name,
                    options=dp.DevicePluginOptions(
                        pre_start_required=pre_start_required
                    ),
                ),
                timeout=timeout_s,
            )
        finally:
            ch.close()


def add_registration_servicer(
    server: grpc.Server, register_fn: Callable[[dp.RegisterRequest], None]
) -> None:
    """Server side of Registration: the kubelet serves it, the agent never
    does; tests do."""

    def _register(request, context):  # noqa: ARG001
        register_fn(request)
        return dp.Empty()

    handlers = {
        "Register": grpc.unary_unary_rpc_method_handler(
            _register,
            request_deserializer=dp.RegisterRequest.FromString,
            response_serializer=dp.Empty.SerializeToString,
        )
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler("v1beta1.Registration", handlers),)
    )
