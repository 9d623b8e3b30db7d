"""Minimal ttrpc (containerd's lightweight RPC): the unary subset NRI uses.

The port's copy of ``elastic_tpu_agent/nri/ttrpc.py``; its frames are
byte for byte the agent's. Wire format (github.com/containerd/ttrpc, what
containerd speaks on the NRI socket):

  10-byte message header, big-endian:
      uint32  payload length
      uint32  stream id        (client streams are odd, starting at 1)
      uint8   type             (1 = request, 2 = response)
      uint8   flags            (0 for unary)
  followed by ``length`` bytes of payload: a serialized ``ttrpc.Request``
  or ``ttrpc.Response`` message (``gen/ttrpc_pb2.py``).

Both ends of an NRI connection are unary only, so streaming message types
are not implemented; a request that cannot be parsed is answered with a
failed Response, as the containerd server answers protocol errors it can
attribute to a stream.
"""

from __future__ import annotations

import logging
import socket
import struct
import threading
from typing import Callable, Dict, Optional, Tuple

from ..gen import ttrpc_pb2

logger = logging.getLogger(__name__)

_HEADER = struct.Struct(">IIBB")

MESSAGE_TYPE_REQUEST = 0x1
MESSAGE_TYPE_RESPONSE = 0x2

# containerd's default; frames beyond it are a protocol error.
MAX_MESSAGE_SIZE = 4 << 20

# google.rpc codes used on this path.
CODE_OK = 0
CODE_UNKNOWN = 2
CODE_UNIMPLEMENTED = 12


class TtrpcError(Exception):
    """Remote returned a non-OK status."""

    def __init__(self, code: int, message: str):
        super().__init__(f"ttrpc status {code}: {message}")
        self.code = code
        self.message = message


class ChannelClosed(Exception):
    """The underlying byte stream ended."""


class ChannelTimeout(Exception):
    """A bounded read ran out of time (the channel itself is still up)."""


class Channel:
    """Byte-stream interface ttrpc runs over (a socket or one mux conn)."""

    def sendall(self, data: bytes) -> None:
        raise NotImplementedError

    def recv_exact(self, n: int, timeout: Optional[float] = None) -> bytes:
        """Return exactly n bytes; raise ChannelClosed on EOF or
        ChannelTimeout when a non-None timeout elapses first."""
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


class SocketChannel(Channel):
    """Channel over a plain (unix) socket."""

    def __init__(self, sock):
        self._sock = sock

    def sendall(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except OSError as e:
            raise ChannelClosed(str(e))

    def recv_exact(self, n: int, timeout: Optional[float] = None) -> bytes:
        import time as _time

        deadline = None if timeout is None else _time.monotonic() + timeout
        buf = b""
        while len(buf) < n:
            if deadline is not None:
                remaining = deadline - _time.monotonic()
                if remaining <= 0:
                    self._sock.settimeout(None)
                    raise ChannelTimeout(f"recv timed out after {timeout}s")
                self._sock.settimeout(remaining)
            try:
                chunk = self._sock.recv(n - len(buf))
            except socket.timeout:
                self._sock.settimeout(None)
                raise ChannelTimeout(f"recv timed out after {timeout}s")
            except OSError as e:
                raise ChannelClosed(str(e))
            finally:
                if deadline is not None:
                    try:
                        self._sock.settimeout(None)
                    except OSError:
                        pass
            if not chunk:
                raise ChannelClosed("socket closed")
            buf += chunk
        return buf

    def close(self) -> None:
        # shutdown() before close(): a close alone neither wakes a reader
        # thread blocked in recv (it holds a kernel reference to the file,
        # deferring release) nor sends FIN to the peer — both ends of the
        # NRI socket would hang forever instead of reconnecting.
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass


def write_frame(ch: Channel, stream_id: int, mtype: int, payload: bytes) -> None:
    ch.sendall(_HEADER.pack(len(payload), stream_id, mtype, 0) + payload)


def read_frame(
    ch: Channel, timeout: Optional[float] = None
) -> Tuple[int, int, int, bytes]:
    """-> (stream_id, type, flags, payload)"""
    hdr = ch.recv_exact(_HEADER.size, timeout=timeout)
    length, stream_id, mtype, flags = _HEADER.unpack(hdr)
    if length > MAX_MESSAGE_SIZE:
        raise ChannelClosed(f"oversized ttrpc frame ({length} bytes)")
    payload = ch.recv_exact(length, timeout=timeout) if length else b""
    return stream_id, mtype, flags, payload


class Client:
    """Unary ttrpc client. One in-flight call at a time per caller thread;
    responses are matched by stream id so interleaving is still safe."""

    def __init__(self, channel: Channel):
        self._ch = channel
        self._next_stream = 1
        self._lock = threading.Lock()

    def call(self, service: str, method: str, request, response_cls,
             timeout_s: Optional[float] = None):
        """Unary call; a non-None ``timeout_s`` bounds the wait for the
        response (raising ChannelTimeout) so callers on latency-critical
        threads can't wedge on a stalled runtime. A late response for
        the abandoned stream id is skipped by a later call's sid match."""
        import time as _time

        req = ttrpc_pb2.Request(
            service=service,
            method=method,
            payload=request.SerializeToString(),
            timeout_nano=(
                int(timeout_s * 1e9) if timeout_s is not None else 0
            ),
        )
        with self._lock:
            stream_id = self._next_stream
            self._next_stream += 2  # client streams stay odd
            write_frame(
                self._ch, stream_id, MESSAGE_TYPE_REQUEST,
                req.SerializeToString(),
            )
            deadline = (
                None if timeout_s is None
                else _time.monotonic() + timeout_s
            )
            while True:
                remaining = None
                if deadline is not None:
                    remaining = deadline - _time.monotonic()
                    if remaining <= 0:
                        raise ChannelTimeout(
                            f"{service}/{method} timed out after "
                            f"{timeout_s}s"
                        )
                try:
                    sid, mtype, _flags, payload = read_frame(
                        self._ch, timeout=remaining
                    )
                except ChannelTimeout:
                    # A timeout may strike MID-FRAME (header consumed,
                    # payload pending): the stream is no longer aligned
                    # and reusing it would parse payload bytes as a
                    # header. Poison the channel — the owner's reconnect
                    # loop builds a fresh session.
                    self._ch.close()
                    raise
                if mtype != MESSAGE_TYPE_RESPONSE or sid != stream_id:
                    logger.warning(
                        "ttrpc client: unexpected frame sid=%d type=%d", sid,
                        mtype,
                    )
                    continue
                resp = ttrpc_pb2.Response.FromString(payload)
                if resp.status.code != CODE_OK:
                    raise TtrpcError(resp.status.code, resp.status.message)
                out = response_cls()
                out.ParseFromString(resp.payload)
                return out


# handler: (request_bytes) -> response_message
Handler = Callable[[bytes], "object"]


class Server:
    """Unary ttrpc server dispatching to registered method handlers."""

    def __init__(self, channel: Channel):
        self._ch = channel
        self._handlers: Dict[Tuple[str, str], Tuple[Handler, type]] = {}
        self._wlock = threading.Lock()
        self._stop_after_reply = False

    def register(self, service: str, method: str, request_cls,
                 handler: Callable) -> None:
        """handler(request_msg) -> response protobuf message."""
        self._handlers[(service, method)] = (handler, request_cls)

    def stop_after_reply(self) -> None:
        """Make serve_forever return once the in-flight response is written
        — lets a Shutdown handler end the session without racing its own
        response frame out of the connection."""
        self._stop_after_reply = True

    def serve_forever(self) -> None:
        """Blocking dispatch loop; returns when the channel closes."""
        while True:
            try:
                sid, mtype, _flags, payload = read_frame(self._ch)
            except ChannelClosed:
                return
            if mtype != MESSAGE_TYPE_REQUEST:
                logger.warning("ttrpc server: dropping frame type=%d", mtype)
                continue
            try:
                req = ttrpc_pb2.Request.FromString(payload)
            except Exception:
                self._respond_error(sid, CODE_UNKNOWN, "malformed request")
                continue
            key = (req.service, req.method)
            entry = self._handlers.get(key)
            if entry is None:
                self._respond_error(
                    sid, CODE_UNIMPLEMENTED,
                    f"{req.service}/{req.method} not implemented",
                )
                continue
            handler, request_cls = entry
            try:
                msg = request_cls()
                msg.ParseFromString(req.payload)
                result = handler(msg)
                resp = ttrpc_pb2.Response(
                    status=ttrpc_pb2.Status(code=CODE_OK),
                    payload=result.SerializeToString(),
                )
            except Exception as e:  # handler fault -> status, keep serving
                logger.exception("ttrpc handler %s/%s failed", *key)
                resp = ttrpc_pb2.Response(
                    status=ttrpc_pb2.Status(code=CODE_UNKNOWN, message=str(e))
                )
            try:
                with self._wlock:
                    write_frame(
                        self._ch, sid, MESSAGE_TYPE_RESPONSE,
                        resp.SerializeToString(),
                    )
            except ChannelClosed:
                return  # peer went away mid-response; session over
            if self._stop_after_reply:
                return

    def _respond_error(self, sid: int, code: int, message: str) -> None:
        resp = ttrpc_pb2.Response(
            status=ttrpc_pb2.Status(code=code, message=message)
        )
        try:
            with self._wlock:
                write_frame(
                    self._ch, sid, MESSAGE_TYPE_RESPONSE,
                    resp.SerializeToString(),
                )
        except ChannelClosed:
            pass
