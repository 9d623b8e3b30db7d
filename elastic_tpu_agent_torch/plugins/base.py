"""Device-plugin server lifecycle: serve, probe, register, re-register.

Counterpart of ``elastic_tpu_agent/plugins/base.py``, itself the
reference's ``pkg/plugins/base.go``: one gRPC server per extended resource
on a unix socket under the kubelet's device-plugins dir; after serving,
dial-probe the socket, register with kubelet.sock, then watch for kubelet
restarts (the socket re-created) and run the whole loop again. Any error:
back off and retry.

``grpc`` and the port's ``rpc`` module are imported where a server starts,
not when this module is imported: ``PluginConfig`` and the plugins'
allocation logic run where grpcio and protobuf are not installed.

What the agent's config carries besides, and this copy does not: the
slice registry seam and the ``dp.run`` failpoint; they come with the
slices. The config carries the lag tracker, which the
agent's does not: the port's GC reports deletion-to-reclaim lag. The
restart backoff is a constant, as nothing sets it; the
gRPC pool size is the manager's (``--dp-pool-size``). The manager builds
the plugin bundle directly: the port has one plugin kind, so there is no
``plugin_factory``.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures
from dataclasses import dataclass, field
from typing import Callable, Optional

from ..common import (
    DEVICE_PLUGIN_DIR,
    KUBELET_SOCKET_NAME,
    POD_RESOURCES_SOCKET,
    FileWatcher,
)
from ..kube.locator import LocateError  # noqa: F401 - the plugins' error

logger = logging.getLogger(__name__)

# seconds between a failed serve/register (or a kubelet restart) and the
# next attempt
RESTART_BACKOFF_S = 1.0
# gRPC worker threads per resource server by default: kubelet sends
# concurrent Allocate/PreStartContainer pairs, one per container
GRPC_POOL_SIZE = 8


@dataclass
class PluginConfig:
    """Wiring of the plugin layer (reference GPUPluginConfig,
    base.go:32-43). ``operator``, ``sitter``, ``storage`` and
    ``locator_factory`` are injected and read by duck typing, as the
    agent's are: a ``device/`` operator; a sitter with ``get_pod`` and
    ``get_pod_from_api``; a storage with ``load``/``mutate``/``items``/
    ``delete`` and the intent journal; ``locator_factory(resource)`` giving
    an object whose ``locate(device)`` returns the owning container."""

    node_name: str = ""
    device_plugin_dir: str = DEVICE_PLUGIN_DIR
    pod_resources_socket: str = POD_RESOURCES_SOCKET
    grpc_pool_size: int = GRPC_POOL_SIZE
    operator: object = None
    sitter: object = None
    storage: object = None
    locator_factory: Optional[Callable[[str], object]] = None
    # observability seams, all optional and fire-and-forget: AgentMetrics
    # (metrics.py), the ElasticTPU CRD recorder (crd_recorder.py), the k8s
    # Event recorder (kube/events.py), the lifecycle Timeline
    # (timeline.py) and the detection-lag tracker (latency.py) that GC
    # reports its reclaims to
    metrics: object = None
    crd_recorder: object = None
    events: object = None
    timeline: object = None
    lag_tracker: object = None
    # the utilization sampler (sampler.py): the health poll folds in the
    # cards whose telemetry it flags
    sampler: object = None
    extra: dict = field(default_factory=dict)


class DevicePluginServer:
    """Registration lifecycle for ONE extended resource.

    States per iteration: serve socket -> probe -> register -> watch.
    A kubelet restart (kubelet.sock re-created) or any serve/register error
    tears the server down and re-enters the loop after a short backoff.
    """

    def __init__(self, servicer, resource_name: str, endpoint: str,
                 config: PluginConfig) -> None:
        self._servicer = servicer
        self._resource = resource_name
        self._endpoint = endpoint  # socket file name
        self._config = config
        self._server = None

    @property
    def resource_name(self) -> str:
        return self._resource

    @property
    def socket_path(self) -> str:
        return os.path.join(self._config.device_plugin_dir, self._endpoint)

    @property
    def kubelet_socket(self) -> str:
        return os.path.join(self._config.device_plugin_dir,
                            KUBELET_SOCKET_NAME)

    def _serve(self) -> None:
        import grpc

        from .. import rpc

        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)  # stale socket from a previous run
        # named threads: a stack dump of a wedged bind burst says which
        # resource's pool it sits in
        server = grpc.server(futures.ThreadPoolExecutor(
            max_workers=self._config.grpc_pool_size,
            thread_name_prefix=f"dp-grpc-{self._resource}",
        ))
        rpc.add_device_plugin_servicer(server, self._servicer)
        server.add_insecure_port(rpc.unix_target(self.socket_path))
        server.start()
        self._server = server

    def _stop_server(self) -> None:
        if self._server is not None:
            self._server.stop(grace=0.5)
            self._server = None

    def _probe(self, timeout_s: float = 5.0) -> None:
        from .. import rpc

        rpc.dial(self.socket_path, timeout_s).close()

    def _register(self) -> None:
        from .. import rpc

        rpc.RegistrationClient(self.kubelet_socket).register(
            endpoint=self._endpoint,
            resource_name=self._resource,
            pre_start_required=True,
        )
        logger.info(
            "registered %s via %s with kubelet", self._resource, self._endpoint
        )

    def run(self, stop: threading.Event) -> None:
        """Blocking serve/register/watch loop until ``stop`` is set; the
        server is stopped on every exit, so a supervisor re-entering run()
        never serves a second one on the re-created socket.

        ``grpc`` is imported first, outside the retry loop: without it no
        server can ever run, so the import error ends run() and the
        supervisor counts a crash of this critical subsystem."""
        import grpc  # noqa: F401

        from .. import rpc  # noqa: F401

        try:
            self._run_loop(stop)
        finally:
            self._stop_server()

    def _run_loop(self, stop: threading.Event) -> None:
        while not stop.is_set():
            try:
                self._serve()
                self._probe()
                # snapshot the kubelet socket BEFORE registering: a kubelet
                # restart racing the Register call must still be seen
                watcher = FileWatcher(self.kubelet_socket)
                self._register()
            except Exception as e:  # noqa: BLE001 - retried after a backoff
                logger.warning(
                    "%s: serve/register failed (%s); retrying", self._resource, e
                )
                self._stop_server()
                stop.wait(RESTART_BACKOFF_S)
                continue
            restarted = False
            while not stop.is_set():
                if watcher.changed():
                    logger.info(
                        "%s: kubelet socket changed; re-registering",
                        self._resource,
                    )
                    restarted = True
                    break
                stop.wait(1.0)
            self._stop_server()
            if restarted:
                stop.wait(RESTART_BACKOFF_S)

    def start(self, stop: threading.Event) -> None:
        threading.Thread(
            target=self.run, args=(stop,), daemon=True,
            name=f"dp-server-{self._resource}",
        ).start()

