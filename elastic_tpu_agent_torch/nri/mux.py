"""NRI connection multiplexer.

The port's copy of ``elastic_tpu_agent/nri/mux.py``. containerd's NRI
socket carries TWO logical ttrpc connections over one unix socket
(github.com/containerd/nri pkg/net/multiplex wire format):

  8-byte frame header, big-endian:
      uint32  connection id
      uint32  payload length
  followed by ``length`` payload bytes belonging to that logical stream.

Connection ids (pkg/api):
  1  Plugin service:  the runtime is the ttrpc client, the plugin the server
  2  Runtime service: the plugin is the ttrpc client, the runtime the server
"""

from __future__ import annotations

import struct
import threading
from typing import Dict, Optional

from .ttrpc import Channel, ChannelClosed, ChannelTimeout, SocketChannel

_FRAME = struct.Struct(">II")

PLUGIN_SERVICE_CONN = 1
RUNTIME_SERVICE_CONN = 2

# Same bound the mux applies upstream; a frame larger than this means the
# two ends disagree about the protocol.
_MAX_FRAME = 1 << 24


class MuxChannel(Channel):
    """One logical byte stream inside a Mux."""

    def __init__(self, mux: "Mux", conn_id: int):
        self._mux = mux
        self._id = conn_id
        self._buf = bytearray()
        self._cond = threading.Condition()
        self._closed = False

    # -- reader-thread side --

    def _feed(self, data: bytes) -> None:
        with self._cond:
            self._buf.extend(data)
            self._cond.notify_all()

    def _shutdown(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- Channel interface --

    def sendall(self, data: bytes) -> None:
        self._mux._send(self._id, data)

    def recv_exact(self, n: int, timeout: Optional[float] = None) -> bytes:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        with self._cond:
            while len(self._buf) < n:
                if self._closed:
                    raise ChannelClosed("mux closed")
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise ChannelTimeout(
                            f"mux recv timed out after {timeout}s"
                        )
                    self._cond.wait(timeout=remaining)
            out = bytes(self._buf[:n])
            del self._buf[:n]
            return out

    def close(self) -> None:
        self._mux.close()


class Mux:
    """Demultiplexes a socket into MuxChannels; one reader thread."""

    def __init__(self, sock):
        self._ch = SocketChannel(sock)
        self._conns: Dict[int, MuxChannel] = {}
        self._wlock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(
            target=self._read_loop, name="nri-mux-reader", daemon=True
        )

    def open(self, conn_id: int) -> MuxChannel:
        if conn_id not in self._conns:
            self._conns[conn_id] = MuxChannel(self, conn_id)
        return self._conns[conn_id]

    def start(self) -> None:
        self._reader.start()

    def _read_loop(self) -> None:
        try:
            while True:
                hdr = self._ch.recv_exact(_FRAME.size)
                conn_id, length = _FRAME.unpack(hdr)
                if length > _MAX_FRAME:
                    raise ChannelClosed(f"oversized mux frame ({length})")
                payload = self._ch.recv_exact(length) if length else b""
                conn = self._conns.get(conn_id)
                if conn is not None:
                    conn._feed(payload)
                # frames for unopened conns are dropped (same as upstream)
        except ChannelClosed:
            pass
        finally:
            self.close()

    def _send(self, conn_id: int, data: bytes) -> None:
        with self._wlock:
            self._ch.sendall(_FRAME.pack(conn_id, len(data)) + data)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._ch.close()
        for conn in self._conns.values():
            conn._shutdown()

    @property
    def closed(self) -> bool:
        return self._closed
