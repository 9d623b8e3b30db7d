"""A stand-in for containerd's side of the NRI socket, on the port's
transport (``elastic_tpu_agent_torch/nri/mux.py`` and ``ttrpc.py``): the
shape of ``tests/test_nri.py``'s ``FakeNRIRuntime``, which runs on the
agent's. It listens on a unix socket, accepts a plugin's connection, serves
the Runtime service on conn 2 (RegisterPlugin, UpdateContainers, whose
requests it logs) and calls the Plugin service on conn 1 (Configure,
Synchronize, CreateContainer, StateChange, Shutdown).

It imports nothing of the JAX package, so ``chip_smoke.py`` loads it from
this directory as it loads ``fake_apiserver.py``. Keep its socket path
short (``tempfile.mkdtemp(dir="/tmp")``): AF_UNIX paths end at 107 bytes.
"""

import os
import socket
import threading
import time

from elastic_tpu_agent_torch.gen import nri_pb2 as pb
from elastic_tpu_agent_torch.nri import mux as port_mux
from elastic_tpu_agent_torch.nri import ttrpc as port_ttrpc
from elastic_tpu_agent_torch.nri.plugin import PLUGIN_SERVICE, RUNTIME_SERVICE


class NRIRuntime:
    """containerd's side of one NRI socket. ``restart()`` closes the
    session and the socket and listens again on the same path, as a
    containerd restart does."""

    def __init__(self, socket_path, mux=port_mux, ttrpc=port_ttrpc,
                 accept_timeout_s=5.0):
        self.socket_path = socket_path
        self.mux_mod = mux
        self.ttrpc = ttrpc
        self.accept_timeout_s = accept_timeout_s
        self.registered = threading.Event()
        self.register_request = None
        self.registered_at = None
        self.update_requests = []        # UpdateContainersRequest log
        self.update_times = []
        self.fail_evictions = set()      # container ids to report failed
        self.mux = None
        self.client = None
        self._listen()

    def _listen(self):
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen(2)
        self._listener.settimeout(self.accept_timeout_s)

    def accept(self):
        """Take the plugin's connection and open both conns (before the
        mux's reader starts)."""
        conn, _ = self._listener.accept()
        conn.settimeout(None)
        self.registered.clear()
        self.mux = self.mux_mod.Mux(conn)
        plugin_ch = self.mux.open(self.mux_mod.PLUGIN_SERVICE_CONN)
        runtime_ch = self.mux.open(self.mux_mod.RUNTIME_SERVICE_CONN)
        server = self.ttrpc.Server(runtime_ch)
        server.register(RUNTIME_SERVICE, "RegisterPlugin",
                        pb.RegisterPluginRequest, self._on_register)
        server.register(RUNTIME_SERVICE, "UpdateContainers",
                        pb.UpdateContainersRequest,
                        self._on_update_containers)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        self.mux.start()
        self.client = self.ttrpc.Client(plugin_ch)

    def restart(self):
        """Close the session and the socket, listen again."""
        if self.mux is not None:
            self.mux.close()
        self._listener.close()
        self._listen()

    def _on_register(self, req):
        self.register_request = req
        self.registered_at = time.perf_counter()
        self.registered.set()
        return pb.Empty()

    def _on_update_containers(self, req):
        self.update_times.append(time.perf_counter())
        self.update_requests.append(req)
        return pb.UpdateContainersResponse(failed=[
            pb.ContainerUpdate(container_id=cid)
            for cid in sorted(self.fail_evictions)])

    def wait_updates(self, n, timeout_s):
        """Whether ``n`` UpdateContainers requests arrived in time."""
        deadline = time.monotonic() + timeout_s
        while len(self.update_requests) < n:
            if time.monotonic() > deadline:
                return False
            time.sleep(0.005)
        return True

    def evicted_ids(self):
        return [e.container_id for r in self.update_requests
                for e in r.evict]

    def configure(self, runtime_name="fake-containerd", version="v9"):
        return self.client.call(
            PLUGIN_SERVICE, "Configure",
            pb.ConfigureRequest(runtime_name=runtime_name,
                                runtime_version=version),
            pb.ConfigureResponse)

    def synchronize(self, pods=(), containers=()):
        return self.client.call(
            PLUGIN_SERVICE, "Synchronize",
            pb.SynchronizeRequest(pods=pods, containers=containers),
            pb.SynchronizeResponse)

    def create_container(self, env, pod_name="train", namespace="ml",
                         container_id="ctr-1"):
        return self.client.call(
            PLUGIN_SERVICE, "CreateContainer",
            pb.CreateContainerRequest(
                pod=pb.PodSandbox(id="sandbox-1", name=pod_name,
                                  namespace=namespace),
                container=pb.Container(id=container_id,
                                       pod_sandbox_id="sandbox-1",
                                       name="main", env=list(env))),
            pb.CreateContainerResponse)

    def state_change(self, event, container_id):
        return self.client.call(
            PLUGIN_SERVICE, "StateChange",
            pb.StateChangeEvent(event=event,
                                container=pb.Container(id=container_id)),
            pb.Empty)

    def shutdown_plugin(self):
        return self.client.call(PLUGIN_SERVICE, "Shutdown", pb.Empty(),
                                pb.Empty)

    def close(self):
        if self.mux is not None:
            self.mux.close()
        self._listener.close()
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
