"""Hand-wired gRPC plumbing for the kubelet's device-plugin and
pod-resources APIs.

The port's copy of ``elastic_tpu_agent/rpc.py``: with no generated
``*_pb2_grpc.py`` stubs, the kubelet's method paths
(``/v1beta1.Registration/Register``, ``/v1beta1.DevicePlugin/*``,
``/v1.PodResourcesLister/*`` and ``/v1alpha1.PodResourcesLister/List``) are
bound explicitly against grpcio's generic handler API. The pod-resources
servers are the kubelet's; the agent never serves them, and the port's
fake kubelet (``tests/torch_fake_kubelet.py``, the fleet simulator's)
serves them through :func:`add_pod_resources_servicer` and
:func:`add_pod_resources_v1_servicer`.

This is the one module of the agent side that imports ``grpc`` at module
level; the plugins' allocation logic (``plugins/gpushare.py``) does not, so
that it runs where grpcio and protobuf are not installed.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Optional

import grpc

from . import faults
from .common import DEVICE_PLUGIN_VERSION, POD_RESOURCES_SOCKET
from .gen import deviceplugin_pb2 as dp
from .gen import podresources_pb2 as pr
from .gen import podresources_v1_pb2 as prv1

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


# -- PodResourcesLister service ------------------------------------------------


class PodResourcesClient:
    """List() of pod->container->devices (reference: podresources/client.go
    + locator.go:32-41). Lazily re-dials on failure.

    Speaks BOTH kubelet API versions: probes ``v1`` first (served since
    k8s 1.20, adds GetAllocatableResources) and falls back to ``v1alpha1``
    when the kubelet answers UNIMPLEMENTED — the reference spoke only
    v1alpha1 (pkg/podresources/v1alpha1/api.proto). The negotiated version
    sticks for the life of the channel; a reset() re-probes, so a kubelet
    upgrade under us is picked up on reconnect. The two Lists are wire- and
    field-name-compatible for everything the locator touches
    (pod_resources/name/namespace/containers/devices/resource_name/
    device_ids), so callers never see the difference.
    """

    def __init__(self, socket_path: str = POD_RESOURCES_SOCKET) -> None:
        self._socket = socket_path
        self._lock = threading.Lock()  # one client is shared by multiple
        self._channel: Optional[grpc.Channel] = None  # locators + prefetch
        # immutable per-negotiation binding: (list_fn, request_cls,
        # allocatable_fn_or_None, version) — swapped atomically so a caller
        # can never pair a stale callable with the other version's request
        self._bound: Optional[tuple] = None  # threads

    @property
    def api_version(self) -> Optional[str]:
        bound = self._bound
        return bound[3] if bound else None

    @staticmethod
    def _bind_v1(channel) -> tuple:
        list_fn = channel.unary_unary(
            "/v1.PodResourcesLister/List",
            request_serializer=prv1.ListPodResourcesRequest.SerializeToString,
            response_deserializer=prv1.ListPodResourcesResponse.FromString,
        )
        allocatable = channel.unary_unary(
            "/v1.PodResourcesLister/GetAllocatableResources",
            request_serializer=(
                prv1.AllocatableResourcesRequest.SerializeToString
            ),
            response_deserializer=(
                prv1.AllocatableResourcesResponse.FromString
            ),
        )
        return (list_fn, prv1.ListPodResourcesRequest, allocatable, "v1")

    @staticmethod
    def _bind_v1alpha1(channel) -> tuple:
        list_fn = channel.unary_unary(
            "/v1alpha1.PodResourcesLister/List",
            request_serializer=pr.ListPodResourcesRequest.SerializeToString,
            response_deserializer=pr.ListPodResourcesResponse.FromString,
        )
        return (list_fn, pr.ListPodResourcesRequest, None, "v1alpha1")

    # Codes that mean "the kubelet (or the wire) is broken right now", not
    # "this RPC isn't served": negotiation must re-raise these and retry
    # later instead of concluding anything about the API version.
    _TRANSPORT_CODES = frozenset({
        grpc.StatusCode.UNAVAILABLE,
        grpc.StatusCode.DEADLINE_EXCEEDED,
        grpc.StatusCode.CANCELLED,
    })

    def _ensure(self, timeout_s: float) -> tuple:
        """Return the negotiated binding tuple, dialing + version-probing
        if needed (thread-safe). The probe is GetAllocatableResources — a
        tiny response, unlike a full-node List — which a v1alpha1-only
        kubelet rejects with UNIMPLEMENTED.

        k8s 1.21-1.22 wrinkle: those kubelets serve v1 List but answer the
        probe with a NON-UNIMPLEMENTED error when the
        KubeletPodResourcesGetAllocatable gate is off. Treating that as
        fatal would strand the locator on a kubelet whose List works fine,
        so on any non-transport probe failure the v1 List itself is probed
        to separate "v1 with allocatable disabled" (bind v1, allocatable
        marked unavailable) from "no v1 at all" (fall back to v1alpha1).
        """
        with self._lock:
            if self._bound is None:
                channel = grpc.insecure_channel(
                    unix_target(self._socket), options=_CHANNEL_OPTS
                )
                grpc.channel_ready_future(channel).result(timeout=timeout_s)
                self._channel = channel
                bound = self._bind_v1(channel)
                try:
                    bound[2](
                        prv1.AllocatableResourcesRequest(), timeout=timeout_s
                    )
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                        bound = self._bind_v1alpha1(channel)
                    elif e.code() in self._TRANSPORT_CODES:
                        raise
                    else:
                        try:
                            bound[0](
                                prv1.ListPodResourcesRequest(),
                                timeout=timeout_s,
                            )
                            # v1 List works; only allocatable is gated off
                            bound = (bound[0], bound[1], None, "v1")
                        except grpc.RpcError as e2:
                            if (
                                e2.code()
                                == grpc.StatusCode.UNIMPLEMENTED
                            ):
                                bound = self._bind_v1alpha1(channel)
                            else:
                                raise
                self._bound = bound
            return self._bound

    def reset(self) -> None:
        """Drop the channel so the next call re-dials (and re-probes the
        API version — a kubelet upgrade under us is picked up here). The
        old channel is closed after a grace period, NOT immediately: other
        threads (locator prefetch + inline locate share this client) may
        have RPCs in flight on it, and close() would cancel them."""
        with self._lock:
            old = self._channel
            self._channel = None
            self._bound = None
        if old is not None:
            timer = threading.Timer(5.0, old.close)
            timer.daemon = True
            timer.start()

    def list(self, timeout_s: float = 5.0):
        faults.fire("podresources.list")
        try:
            list_fn, req_cls, _, _ = self._ensure(timeout_s)
            return list_fn(req_cls(), timeout=timeout_s)
        except grpc.RpcError:
            self.reset()  # re-dial next call (reference: locator.go:47-53)
            raise

    def get_allocatable_resources(
        self, timeout_s: float = 5.0
    ) -> Optional[prv1.AllocatableResourcesResponse]:
        """Node allocatable devices (v1 only). Returns None when the
        kubelet only speaks v1alpha1 — callers treat that as 'unknown',
        not 'empty'."""
        try:
            _, _, allocatable_fn, version = self._ensure(timeout_s)
            if allocatable_fn is None:
                return None  # negotiated v1alpha1: genuinely unavailable
            return allocatable_fn(
                prv1.AllocatableResourcesRequest(), timeout=timeout_s
            )
        except grpc.RpcError:
            self.reset()
            raise

    def close(self) -> None:
        self.reset()


def add_pod_resources_servicer(
    server: grpc.Server,
    list_fn: Callable[[], pr.ListPodResourcesResponse],
) -> None:
    """Server side of v1alpha1 pod-resources: the kubelet serves it in
    production, the fake kubelet in tests and the fleet simulator."""

    def _list(request, context):  # noqa: ARG001
        return list_fn()

    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            _list,
            request_deserializer=pr.ListPodResourcesRequest.FromString,
            response_serializer=pr.ListPodResourcesResponse.SerializeToString,
        )
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(
            "v1alpha1.PodResourcesLister", handlers),)
    )


def add_pod_resources_v1_servicer(
    server: grpc.Server,
    list_fn: Callable[[], "prv1.ListPodResourcesResponse"],
    allocatable_fn: Optional[
        Callable[[], "prv1.AllocatableResourcesResponse"]
    ] = None,
) -> None:
    """v1 pod-resources server (kubelet >= 1.20 shape): List and
    GetAllocatableResources, so that the client's version negotiation is
    testable against both shapes."""

    def _list(request, context):  # noqa: ARG001
        return list_fn()

    def _allocatable(request, context):  # noqa: ARG001
        # Real v1 kubelets always implement this RPC (the client uses it as
        # its version probe): an unconfigured fake answers empty, never
        # UNIMPLEMENTED, which would misread as a v1alpha1-only kubelet.
        if allocatable_fn is None:
            return prv1.AllocatableResourcesResponse()
        return allocatable_fn()

    handlers = {
        "List": grpc.unary_unary_rpc_method_handler(
            _list,
            request_deserializer=prv1.ListPodResourcesRequest.FromString,
            response_serializer=(
                prv1.ListPodResourcesResponse.SerializeToString
            ),
        ),
        "GetAllocatableResources": grpc.unary_unary_rpc_method_handler(
            _allocatable,
            request_deserializer=(
                prv1.AllocatableResourcesRequest.FromString
            ),
            response_serializer=(
                prv1.AllocatableResourcesResponse.SerializeToString
            ),
        ),
    }
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(
            "v1.PodResourcesLister", handlers),)
    )
