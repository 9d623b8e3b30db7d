"""The container injection of a CUDA allocation: what the NRI plugin adds
at container create.

Counterpart of ``elastic_tpu_agent/nri/plugin.py``'s ``hash_from_env`` and
``adjustment_from_spec``. containerd does not read OCI hooks.d, so the
agent answers NRI's CreateContainer with a ContainerAdjustment carrying
what the allocation spec (``plugins/gpushare.py``) records:

- one character device a bound card at its host name ``/dev/nvidia<minor>``
  (the driver opens the minor the kernel reports, so the agent's dense
  ``/dev/accel<p>`` renumbering is not carried over), with major:minor
  from ``stat`` of the host node;
- the control nodes a CUDA process opens (``/dev/nvidiactl``,
  ``/dev/nvidia-uvm``, ``/dev/nvidia-uvm-tools``): those the spec's
  ``control_paths`` names, which the operator found as character devices
  at discovery;
- the spec's env, ``CUDA_VISIBLE_DEVICES`` and the quota included;
- a read-only bind mount of the spec file;
- with ``driver_libs``, a read-only bind mount of each host driver
  library (``libcuda.so.1`` and its kin) at its own path: a container
  started without nvidia-container-toolkit needs the user-space driver
  that matches the host's kernel module (the agent's ``--nri-libtpu``).

:func:`plain_adjustment` builds it as plain data and imports no protobuf;
:func:`adjustment_from_spec` turns it into the ``nri_pb2`` message.

:class:`NRIPlugin` is the server, the counterpart of the agent's: it dials
the runtime's socket, multiplexes two ttrpc connections over it
(``mux.py``, ``ttrpc.py``; conn 1: the runtime calls the Plugin service on
us, conn 2: we call the Runtime service), registers, and answers
Configure (CREATE_CONTAINER and REMOVE_CONTAINER), Synchronize (the
tracking rebuilt from the runtime's snapshot), CreateContainer (the
adjustment; an unreadable spec fails the create) and StateChange (a
removal prunes the tracking). :meth:`NRIPlugin.evict_for_chips` asks the
runtime (UpdateContainers) to evict every container injected with a card
that went bad; the failed cards stay sticky until
:meth:`NRIPlugin.clear_failed_chips`, so evictions that could not be sent
retry after the next Synchronize, and a container created on a failed
card is evicted at once. Evictions run off the serve thread: the runtime
waits for the reply that triggered them. ``run`` reconnects with a
backoff of 1-30 s. The server imports protobuf when it starts; nothing
here does at import.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import threading
from typing import Callable, Dict, List, Optional, Sequence

from ..common import EnvAllocationHash, EnvAllocationHashCompat
from ..device.operator import is_char_device

logger = logging.getLogger(__name__)

DEFAULT_NRI_SOCKET = "/var/run/nri/nri.sock"

PLUGIN_SERVICE = "nri.pb.v1alpha1.Plugin"
RUNTIME_SERVICE = "nri.pb.v1alpha1.Runtime"


def event_mask(*events: int) -> int:
    """ConfigureResponse.events: bit ``event - 1`` for each Event enum
    value (upstream pkg/api)."""
    mask = 0
    for e in events:
        mask |= 1 << (e - 1)
    return mask


# Where the spec file lands inside the container.
SPEC_MOUNT_DEST = "/run/elastic-tpu/spec.json"
HASH_ANNOTATION = "elastic-tpu.elasticgpu.io/hash"
DEVICE_FILE_MODE = 0o660

_BIND_OPTS = ["bind", "ro", "nosuid", "nodev"]


def hash_from_env(env: List[str]) -> Optional[str]:
    """The allocation hash in a container's env (``TPU=<hash>``, or the
    reference's ``GPU=<hash>``)."""
    for key in (EnvAllocationHash + "=", EnvAllocationHashCompat + "="):
        for entry in env:
            if entry.startswith(key):
                value = entry[len(key):]
                if value:
                    return value
    return None


def plain_adjustment(
    spec: Dict,
    stat_fn: Callable = os.stat,
    dev_root: str = "/dev",
    spec_path: str = "",
) -> Dict:
    """The adjustment for one spec, as plain data: ``annotations``,
    ``devices`` (dicts of path, type, major, minor, file_mode), ``env``
    ((key, value) pairs, sorted) and ``mounts``.

    ``dev_root`` maps the host's /dev into this process's view (the agent
    sees it at /host/dev in its DaemonSet): the nodes are stat'ed there and
    named by their host paths. A card node that does not stat as a
    character device fails the adjustment; a control node that does not
    (gone since discovery) is left out."""

    def view(host_path: str) -> str:
        if dev_root != "/dev" and host_path.startswith("/dev/"):
            return os.path.join(dev_root, host_path[len("/dev/"):])
        return host_path

    def device(path: str, st) -> Dict:
        return dict(path=path, type="c", major=os.major(st.st_rdev),
                    minor=os.minor(st.st_rdev), file_mode=DEVICE_FILE_MODE)

    devices = []
    for path in spec.get("device_paths", []):
        st = stat_fn(view(path))
        if not is_char_device(st):
            raise ValueError(f"card node {path} is not a character device")
        devices.append(device(path, st))
    for path in spec.get("control_paths", []):
        try:
            st = stat_fn(view(path))
        except FileNotFoundError:
            continue
        if is_char_device(st):
            devices.append(device(path, st))
    env = spec.get("env", {})
    mounts = []
    if spec_path:
        mounts.append(dict(destination=SPEC_MOUNT_DEST, type="bind",
                           source=spec_path, options=list(_BIND_OPTS)))
    return dict(
        annotations={HASH_ANNOTATION: spec.get("hash", "")},
        devices=devices,
        env=[(k, env[k]) for k in sorted(env)],
        mounts=mounts,
    )


def adjustment_from_spec(
    spec: Dict,
    stat_fn: Callable = os.stat,
    dev_root: str = "/dev",
    spec_path: str = "",
    driver_libs: Sequence[str] = (),
):
    """:func:`plain_adjustment` as an ``nri_pb2.ContainerAdjustment``,
    with the ``driver_libs`` mounts after the spec's."""
    from ..gen import nri_pb2 as pb

    plain = plain_adjustment(spec, stat_fn=stat_fn, dev_root=dev_root,
                             spec_path=spec_path)
    plain["mounts"] += [dict(destination=lib, type="bind", source=lib,
                             options=list(_BIND_OPTS)) for lib in driver_libs]
    adjust = pb.ContainerAdjustment()
    adjust.annotations.update(plain["annotations"])
    for d in plain["devices"]:
        adjust.linux.devices.append(pb.LinuxDevice(
            path=d["path"], type=d["type"], major=d["major"],
            minor=d["minor"],
            file_mode=pb.OptionalFileMode(value=d["file_mode"])))
    for key, value in plain["env"]:
        adjust.env.append(pb.KeyValue(key=key, value=value))
    for m in plain["mounts"]:
        adjust.mounts.append(pb.Mount(**m))
    return adjust


class NRIPlugin:
    """External NRI plugin: dial, register, serve CreateContainer, evict
    on card failure (module docstring). ``run(stop)`` holds the whole
    lifetime, reconnecting with backoff: a containerd restart must not
    strand the injection path."""

    RECONNECT_MIN_S = 1.0
    RECONNECT_MAX_S = 30.0
    EVICT_RPC_TIMEOUT_S = 10.0

    def __init__(
        self,
        socket_path: str = DEFAULT_NRI_SOCKET,
        alloc_spec_dir: str = "/host/var/lib/elastic-tpu/alloc",
        host_alloc_dir: str = "",
        plugin_name: str = "elastic-gpu",
        plugin_idx: str = "10",
        dev_root: str = "/dev",
        driver_libs: Sequence[str] = (),
        stat_fn: Callable = os.stat,
        metrics=None,
    ) -> None:
        self._socket_path = socket_path
        self._alloc_dir = alloc_spec_dir
        # Specs are read through the agent's mount view (alloc_spec_dir,
        # /host/var/lib/... in the DaemonSet), but runc resolves the
        # adjustment's Mount.source in the host's mount namespace: it must
        # be the host-side path.
        self._host_alloc_dir = host_alloc_dir or alloc_spec_dir
        self._name = plugin_name
        self._idx = plugin_idx
        self._dev_root = dev_root
        self._driver_libs = list(driver_libs)
        self._stat = stat_fn
        self._metrics = metrics
        self._mux = None
        self._server = None
        self._runtime = None
        self._mux_lock = threading.Lock()
        self._stopping = False
        # container id -> the card indexes injected at its create; pruned
        # on removal and rebuilt from every Synchronize, so containers of
        # an earlier session stay evictable
        self._bound_chips: Dict[str, set] = {}
        # card -> health reason, sticky until clear_failed_chips()
        self._failed_chips: Dict[int, str] = {}
        self._evicted: set = set()
        self._bound_lock = threading.Lock()
        # one flush pass at a time: two concurrent passes would both pick
        # a victim before either records it evicted
        self._flush_lock = threading.Lock()
        self.configured = threading.Event()
        self.synchronized = threading.Event()
        self.injected_count = 0

    def _load_spec(self, alloc_hash: str) -> Dict:
        # basename() defuses a hostile hash like "../x" before it becomes
        # a path component
        path = os.path.join(self._alloc_dir,
                            f"{os.path.basename(alloc_hash)}.json")
        with open(path) as f:
            return json.load(f)

    def _in_background(self, name: str) -> None:
        """A flush pass off the serve thread: the runtime is waiting for
        the reply of the call that asked for it."""
        threading.Thread(target=self._flush_evictions, daemon=True,
                         name=name).start()

    # -- Plugin service handlers ----------------------------------------------

    def _on_configure(self, req):
        from ..gen import nri_pb2 as pb

        logger.info("NRI: configured by %s %s", req.runtime_name,
                    req.runtime_version)
        self.configured.set()
        return pb.ConfigureResponse(
            events=event_mask(pb.CREATE_CONTAINER, pb.REMOVE_CONTAINER))

    def _on_synchronize(self, req):
        from ..gen import nri_pb2 as pb

        # The runtime's snapshot is authoritative: containers created
        # under an earlier session stay evictable, removals missed while
        # disconnected stop lingering.
        bound: Dict[str, set] = {}
        for c in req.containers:
            alloc_hash = hash_from_env(list(c.env))
            if alloc_hash is None:
                continue
            try:
                spec = self._load_spec(alloc_hash)
            except (OSError, ValueError):
                logger.warning(
                    "NRI: running GPU container %s/%s has no alloc spec "
                    "(hash %s)", c.pod_sandbox_id[:8], c.name, alloc_hash)
                continue
            bound[c.id] = set(spec.get("chip_indexes", []))
        with self._bound_lock:
            self._bound_chips = bound
            self._evicted &= set(bound)
            retry_needed = bool(self._failed_chips)
        if bound:
            logger.info("NRI: tracking %d running GPU container(s)",
                        len(bound))
        self.synchronized.set()
        if retry_needed:
            self._in_background("nri-evict-retry")
        return pb.SynchronizeResponse(more=req.more)

    def _on_create_container(self, req):
        from ..gen import nri_pb2 as pb

        alloc_hash = hash_from_env(list(req.container.env))
        if alloc_hash is None:
            return pb.CreateContainerResponse()  # not ours
        try:
            spec = self._load_spec(alloc_hash)
        except (OSError, ValueError) as e:
            # fail the create rather than start a GPU pod deviceless; the
            # kubelet retries, and the error names the spec
            raise RuntimeError(
                f"allocation spec for hash {alloc_hash!r} unreadable: {e}")
        adjust = adjustment_from_spec(
            spec, stat_fn=self._stat, dev_root=self._dev_root,
            spec_path=os.path.join(self._host_alloc_dir,
                                   f"{os.path.basename(alloc_hash)}.json"),
            driver_libs=self._driver_libs)
        self.injected_count += 1
        chips = set(spec.get("chip_indexes", []))
        with self._bound_lock:
            self._bound_chips[req.container.id] = chips
            born_dead = bool(chips & set(self._failed_chips))
        if born_dead:
            # the card failed between Allocate and this create
            self._in_background("nri-evict-born-dead")
        if self._metrics is not None:
            self._metrics.nri_injections.inc()
        logger.info("NRI: injected %d device(s) for %s/%s (hash %s)",
                    len(adjust.linux.devices), req.pod.namespace,
                    req.pod.name, alloc_hash)
        return pb.CreateContainerResponse(adjust=adjust)

    def _on_shutdown(self, req):  # noqa: ARG002
        from ..gen import nri_pb2 as pb

        logger.info("NRI: runtime requested shutdown")
        # the session ends once this reply is written; run() reconnects
        if self._server is not None:
            self._server.stop_after_reply()
        return pb.Empty()

    def _on_noop_update(self, req):  # noqa: ARG002
        from ..gen import nri_pb2 as pb

        return pb.UpdateContainerResponse()

    def _on_noop_stop(self, req):  # noqa: ARG002
        from ..gen import nri_pb2 as pb

        return pb.StopContainerResponse()

    def _on_state_change(self, req):
        from ..gen import nri_pb2 as pb

        if req.event == pb.REMOVE_CONTAINER and req.container.id:
            with self._bound_lock:
                self._bound_chips.pop(req.container.id, None)
                self._evicted.discard(req.container.id)
        return pb.Empty()

    # -- card-failure eviction ------------------------------------------------

    def evict_for_chips(self, chips: set, reasons=None) -> int:
        """Record ``chips`` as failed and evict every tracked container
        injected with one of them (the kubelet restarts the pod, and the
        dead card is no longer advertised). Returns the evictions the
        runtime accepted in this call; those it could not take now retry
        after the next Synchronize. A device bound at create cannot be
        swapped in place, so eviction is the only recovery the runtime
        offers; the agent's ``--nri-evict-on-chip-failure`` turns it on."""
        reasons = reasons or {}
        with self._bound_lock:
            for c in chips:
                self._failed_chips[c] = reasons.get(c, "card unhealthy")
        return self._flush_evictions()

    def clear_failed_chips(self, chips: set) -> None:
        """A card recovered: containers created on it stay."""
        with self._bound_lock:
            for c in chips:
                self._failed_chips.pop(c, None)

    def _flush_evictions(self) -> int:
        with self._flush_lock:
            return self._flush_evictions_locked()

    def _flush_evictions_locked(self) -> int:
        from ..gen import nri_pb2 as pb
        from . import ttrpc

        with self._bound_lock:
            failed = dict(self._failed_chips)
            victims = {cid: sorted(set(bound) & set(failed))
                       for cid, bound in self._bound_chips.items()
                       if set(bound) & set(failed)
                       and cid not in self._evicted}
        if not victims:
            return 0
        with self._mux_lock:
            client = self._runtime
        if client is None:
            logger.warning("NRI: no live session; %d eviction(s) pending "
                           "until reconnect", len(victims))
            return 0
        evictions = [
            pb.ContainerEviction(
                container_id=cid,
                reason=("GPU card(s) "
                        + ",".join(f"{c} ({failed[c]})" for c in hit)
                        + " failed; device is unrecoverable in-place"))
            for cid, hit in sorted(victims.items())]
        try:
            resp = client.call(
                RUNTIME_SERVICE, "UpdateContainers",
                pb.UpdateContainersRequest(evict=evictions),
                pb.UpdateContainersResponse,
                timeout_s=self.EVICT_RPC_TIMEOUT_S)
        except (ttrpc.TtrpcError, ttrpc.ChannelClosed,
                ttrpc.ChannelTimeout) as e:
            logger.warning("NRI: eviction request failed (%s); will retry "
                           "after the next session sync", e)
            return 0
        failed_ids = {u.container_id for u in resp.failed}
        ok = 0
        with self._bound_lock:
            for ev in evictions:
                if ev.container_id in failed_ids:
                    logger.warning("NRI: eviction of %s failed",
                                   ev.container_id)
                else:
                    self._evicted.add(ev.container_id)
                    ok += 1
                    logger.info("NRI: evicted %s (%s)", ev.container_id,
                                ev.reason)
        return ok

    # -- connection lifecycle -------------------------------------------------

    def _register_handlers(self, server) -> None:
        from ..gen import nri_pb2 as pb

        for method, request_cls, handler in (
                ("Configure", pb.ConfigureRequest, self._on_configure),
                ("Synchronize", pb.SynchronizeRequest, self._on_synchronize),
                ("CreateContainer", pb.CreateContainerRequest,
                 self._on_create_container),
                ("Shutdown", pb.Empty, self._on_shutdown),
                ("UpdateContainer", pb.UpdateContainerRequest,
                 self._on_noop_update),
                ("StopContainer", pb.StopContainerRequest,
                 self._on_noop_stop),
                ("StateChange", pb.StateChangeEvent, self._on_state_change)):
            server.register(PLUGIN_SERVICE, method, request_cls, handler)

    def serve_once(self) -> None:
        """One connection's lifetime: dial, register, serve until close."""
        from ..gen import nri_pb2 as pb
        from . import mux as nri_mux
        from . import ttrpc

        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.connect(self._socket_path)
        except OSError:
            sock.close()
            raise
        mux = nri_mux.Mux(sock)
        # both logical conns open before the reader starts: frames for an
        # unopened conn are dropped
        plugin_ch = mux.open(nri_mux.PLUGIN_SERVICE_CONN)
        runtime_ch = mux.open(nri_mux.RUNTIME_SERVICE_CONN)
        with self._mux_lock:
            self._mux = mux
        mux.start()
        server = ttrpc.Server(plugin_ch)
        self._server = server
        self._register_handlers(server)
        serve_thread = threading.Thread(
            target=server.serve_forever, name="nri-plugin-serve", daemon=True)
        serve_thread.start()
        try:
            client = ttrpc.Client(runtime_ch)
            client.call(RUNTIME_SERVICE, "RegisterPlugin",
                        pb.RegisterPluginRequest(plugin_name=self._name,
                                                 plugin_idx=self._idx),
                        pb.Empty)
            logger.info("NRI: registered as %s-%s on %s", self._idx,
                        self._name, self._socket_path)
            with self._mux_lock:
                self._runtime = client  # a live session: evictions go out
            serve_thread.join()
        except ttrpc.ChannelClosed:
            pass  # the runtime went away mid-handshake; run() retries
        finally:
            # every exit closes the mux (a rejected registration too), or
            # each reconnect would leak the socket and two threads
            mux.close()
            serve_thread.join(timeout=5.0)
            with self._mux_lock:
                self._mux = None
                self._server = None
                self._runtime = None

    def _close_mux(self) -> None:
        with self._mux_lock:
            if self._mux is not None:
                self._mux.close()

    def run(self, stop: threading.Event) -> None:
        """Serve, reconnecting with exponential backoff, until ``stop``."""
        backoff = self.RECONNECT_MIN_S
        while not stop.is_set() and not self._stopping:
            try:
                self.serve_once()
                backoff = self.RECONNECT_MIN_S  # had a real session
            except OSError as e:
                logger.warning("NRI: connect to %s failed: %s (retry in "
                               "%.0fs)", self._socket_path, e, backoff)
            except Exception:  # noqa: BLE001 - never kill the agent
                logger.exception("NRI: session failed")
            if stop.wait(backoff):
                return
            backoff = min(backoff * 2, self.RECONNECT_MAX_S)

    def start(self, stop: threading.Event) -> threading.Thread:
        t = threading.Thread(target=self.run, args=(stop,), daemon=True,
                             name="nri-plugin")
        t.start()
        return t

    def stop(self) -> None:
        self._stopping = True
        self._close_mux()
