"""The port's fake kubelet: registration and pod-resources servers and the
kubelet's half of the allocation flow, over real gRPC.

A copy of ``tests/fake_kubelet.py``'s ``FakeKubelet`` built on the port's
``rpc`` and ``gen`` (``deviceplugin_pb2``, ``podresources_pb2``,
``podresources_v1_pb2``), so that what loads it (the port's fleet
simulator, ``elastic_tpu_agent_torch/sim/fleet.py``) loads nothing of the
JAX package. It serves the two kubelet sockets the agent talks to, records
plugin registrations, and plays the kubelet's part in the allocation flow
(Allocate -> record the assignment in pod-resources -> PreStartContainer).
"""

from __future__ import annotations

import os
import threading
import time
from concurrent import futures
from typing import Dict, List, Optional, Tuple

import grpc

from elastic_tpu_agent_torch import rpc
from elastic_tpu_agent_torch.common import KUBELET_SOCKET_NAME
from elastic_tpu_agent_torch.gen import deviceplugin_pb2 as dp
from elastic_tpu_agent_torch.gen import podresources_pb2 as pr
from elastic_tpu_agent_torch.gen import podresources_v1_pb2 as prv1


class FakeKubelet:
    def __init__(self, device_plugin_dir: str, pod_resources_socket: str) -> None:
        self.device_plugin_dir = device_plugin_dir
        self.pod_resources_socket = pod_resources_socket
        os.makedirs(device_plugin_dir, exist_ok=True)
        os.makedirs(os.path.dirname(pod_resources_socket), exist_ok=True)
        self.registrations: List[dp.RegisterRequest] = []
        self.register_event = threading.Event()
        # (ns, pod, container) -> {resource: [device_ids]}
        self._assignments: Dict[Tuple[str, str, str], Dict[str, List[str]]] = {}
        self._lock = threading.Lock()
        self._reg_server: Optional[grpc.Server] = None
        self._pr_server: Optional[grpc.Server] = None
        self.split_device_entries = False  # True -> k8s >=1.21 shape
        # which pod-resources APIs this "kubelet" speaks (real ones serve
        # both since 1.20; ("v1alpha1",) simulates an old kubelet)
        self.api_versions = ("v1", "v1alpha1")
        # resource -> [device ids] advertised via v1 GetAllocatableResources
        self.allocatable: Dict[str, List[str]] = {}
        # simulate k8s 1.21-1.22 with KubeletPodResourcesGetAllocatable
        # off: v1 List served, GetAllocatableResources errors (UNKNOWN,
        # like the real kubelet's plain-error answer)
        self.allocatable_disabled = False

    # -- lifecycle ------------------------------------------------------------

    @property
    def kubelet_socket(self) -> str:
        return os.path.join(self.device_plugin_dir, KUBELET_SOCKET_NAME)

    def start(self) -> None:
        self._reg_server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        rpc.add_registration_servicer(self._reg_server, self._on_register)
        self._reg_server.add_insecure_port(rpc.unix_target(self.kubelet_socket))
        self._reg_server.start()

        self._pr_server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        # Real kubelets >=1.20 serve BOTH versions on the one socket; the
        # api_versions knob narrows the fake to one shape so client
        # version negotiation is testable against old and new kubelets.
        if "v1alpha1" in self.api_versions:
            rpc.add_pod_resources_servicer(
                self._pr_server, self._list_pod_resources
            )
        if "v1" in self.api_versions:
            rpc.add_pod_resources_v1_servicer(
                self._pr_server,
                self._list_pod_resources_v1,
                self._allocatable_v1,
            )
        self._pr_server.add_insecure_port(
            rpc.unix_target(self.pod_resources_socket)
        )
        self._pr_server.start()

    def stop(self) -> None:
        for server in (self._reg_server, self._pr_server):
            if server is not None:
                server.stop(grace=0.2)
        self._reg_server = self._pr_server = None

    def restart_registration(self) -> None:
        """Simulate a kubelet restart: socket torn down and re-created."""
        if self._reg_server is not None:
            self._reg_server.stop(grace=0.2)
        if os.path.exists(self.kubelet_socket):
            os.unlink(self.kubelet_socket)
        self.register_event.clear()
        self._reg_server = grpc.server(futures.ThreadPoolExecutor(max_workers=4))
        rpc.add_registration_servicer(self._reg_server, self._on_register)
        self._reg_server.add_insecure_port(rpc.unix_target(self.kubelet_socket))
        self._reg_server.start()

    # -- registration side ----------------------------------------------------

    def _on_register(self, request: dp.RegisterRequest) -> None:
        self.registrations.append(request)
        self.register_event.set()

    def wait_registrations(self, n: int, timeout: float = 10.0) -> bool:
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            if len(self.registrations) >= n:
                return True
            time.sleep(0.05)
        return len(self.registrations) >= n

    # -- pod-resources side ---------------------------------------------------

    def assign(
        self, namespace: str, pod: str, container: str, resource: str, ids: List[str]
    ) -> None:
        with self._lock:
            self._assignments.setdefault((namespace, pod, container), {})[
                resource
            ] = list(ids)

    def unassign_pod(self, namespace: str, pod: str) -> None:
        with self._lock:
            for key in [k for k in self._assignments if k[:2] == (namespace, pod)]:
                del self._assignments[key]

    def _list_pod_resources(self) -> pr.ListPodResourcesResponse:
        with self._lock:
            pods: Dict[Tuple[str, str], Dict[str, Dict[str, List[str]]]] = {}
            for (ns, pod, container), by_res in self._assignments.items():
                pods.setdefault((ns, pod), {})[container] = by_res
        out = []
        for (ns, pod), containers in pods.items():
            centries = []
            for cname, by_res in containers.items():
                devs = []
                for resource, ids in by_res.items():
                    if self.split_device_entries:
                        devs.extend(
                            pr.ContainerDevices(
                                resource_name=resource, device_ids=[i]
                            )
                            for i in ids
                        )
                    else:
                        devs.append(
                            pr.ContainerDevices(
                                resource_name=resource, device_ids=ids
                            )
                        )
                centries.append(
                    pr.ContainerResources(name=cname, devices=devs)
                )
            out.append(
                pr.PodResources(name=pod, namespace=ns, containers=centries)
            )
        return pr.ListPodResourcesResponse(pod_resources=out)

    def _list_pod_resources_v1(self) -> prv1.ListPodResourcesResponse:
        """Same state as the v1alpha1 List, in the v1 wire shape."""
        alpha = self._list_pod_resources()
        return prv1.ListPodResourcesResponse(
            pod_resources=[
                prv1.PodResources(
                    name=p.name,
                    namespace=p.namespace,
                    containers=[
                        prv1.ContainerResources(
                            name=c.name,
                            devices=[
                                prv1.ContainerDevices(
                                    resource_name=d.resource_name,
                                    device_ids=list(d.device_ids),
                                )
                                for d in c.devices
                            ],
                        )
                        for c in p.containers
                    ],
                )
                for p in alpha.pod_resources
            ]
        )

    def _allocatable_v1(self) -> prv1.AllocatableResourcesResponse:
        if self.allocatable_disabled:
            raise RuntimeError(
                "Pod Resources API GetAllocatableResources disabled"
            )
        with self._lock:
            items = sorted(self.allocatable.items())
        return prv1.AllocatableResourcesResponse(
            devices=[
                prv1.ContainerDevices(resource_name=res, device_ids=ids)
                for res, ids in items
            ]
        )

    # -- playing kubelet against a plugin server ------------------------------

    def plugin_client(self, endpoint: str) -> rpc.DevicePluginClient:
        path = os.path.join(self.device_plugin_dir, endpoint)
        return rpc.DevicePluginClient(rpc.dial(path))

    def kubelet_allocate_flow(
        self,
        endpoint: str,
        namespace: str,
        pod: str,
        container: str,
        resource: str,
        ids: List[str],
    ) -> dp.AllocateResponse:
        """The §3.2 hot path as kubelet drives it: Allocate, record the
        assignment in pod-resources, then PreStartContainer."""
        client = self.plugin_client(endpoint)
        resp = client.allocate(ids)
        self.assign(namespace, pod, container, resource, ids)
        client.pre_start_container(ids)
        return resp
