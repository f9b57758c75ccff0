"""Message transport for the shard-host RPC: length-prefixed frames over
sockets/pipes.

Built on :mod:`multiprocessing.connection` — its ``send_bytes`` /
``recv_bytes`` are exactly the length-prefixed byte frames the protocol
needs (over a loopback TCP socket here; the same API serves AF_UNIX and
Windows pipes), with HMAC connection auth for free. Payload encoding is
:mod:`repro_torch.service.rpc.wire` (msgpack-or-JSON), *not* pickle: frames
stay self-describing and language-agnostic, and a malformed peer can't
execute code in the controller.

Request/response protocol: every request is ``{"id": n, "method": m,
...params}``; the peer answers ``{"id": n, "ok": true, ...result}`` or
``{"id": n, "ok": false, "error": repr}``. One outstanding request per
connection (the controller serializes per-worker calls behind a lock;
concurrency comes from having many workers, not from pipelining one
socket).
"""
from __future__ import annotations

import itertools
import os
import threading
from multiprocessing.connection import Client, Connection, Listener
from typing import Any, Dict, Optional, Tuple

from . import wire

__all__ = ["RpcError", "WorkerGone", "RemoteError", "RpcEndpoint",
           "RpcListener", "connect"]


class RpcError(RuntimeError):
    """Base class for transport-level failures."""


class WorkerGone(RpcError):
    """The peer hung up (process death or clean shutdown): EOF/broken
    pipe on the frame socket."""


class RemoteError(RpcError):
    """The peer processed the request and reported an application
    error."""


class RpcEndpoint:
    """One framed, codec'd connection (either side)."""

    def __init__(self, conn: Connection):
        self._conn = conn
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self.bytes_sent = 0
        self.bytes_received = 0

    # -- raw framed messages ------------------------------------------- #
    def send(self, msg: Dict[str, Any]) -> int:
        frame = wire.encode(msg)
        try:
            self._conn.send_bytes(frame)
        except (OSError, ValueError, EOFError, BrokenPipeError) as e:
            raise WorkerGone(f"send failed: {e!r}") from e
        self.bytes_sent += len(frame)
        return len(frame)

    def recv(self, timeout: Optional[float] = None) -> Dict[str, Any]:
        try:
            if timeout is not None and not self._conn.poll(timeout):
                raise RpcError(f"no frame within {timeout}s")
            frame = self._conn.recv_bytes()
        except (EOFError, OSError, BrokenPipeError) as e:
            raise WorkerGone(f"peer hung up: {e!r}") from e
        self.bytes_received += len(frame)
        return wire.decode(frame)

    # -- request/response ---------------------------------------------- #
    def request(self, method: str, timeout: Optional[float] = None,
                **params) -> Tuple[Dict[str, Any], int, int]:
        """One round trip; returns ``(result, sent_bytes, recv_bytes)``.
        Raises :class:`WorkerGone` on transport death and
        :class:`RemoteError` when the peer reports a failure."""
        with self._lock:
            rid = next(self._ids)
            s0, r0 = self.bytes_sent, self.bytes_received
            self.send(dict(params, id=rid, method=method))
            reply = self.recv(timeout)
            sent = self.bytes_sent - s0
            received = self.bytes_received - r0
        if reply.get("id") != rid:
            raise RpcError(
                f"out-of-order reply: sent id {rid}, got {reply.get('id')}")
        if not reply.get("ok"):
            raise RemoteError(reply.get("error", "unknown remote error"))
        return reply, sent, received

    def close(self) -> None:
        try:
            self._conn.close()
        except OSError:
            pass


class RpcListener:
    """The controller's accept socket (loopback TCP, HMAC-authed)."""

    def __init__(self, authkey: Optional[bytes] = None,
                 backlog: int = 64):
        self.authkey = authkey if authkey is not None else os.urandom(16)
        # backlog must cover a whole fleet dialing back at once: with the
        # default listen(1), connects past the queue complete the TCP
        # handshake (Linux acks them) but never reach accept(), leaving
        # those workers waiting forever for an auth challenge
        self._listener = Listener(("127.0.0.1", 0), backlog=backlog,
                                  authkey=self.authkey)

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.address

    def accept(self, timeout: Optional[float] = None) -> RpcEndpoint:
        """Accept one peer. ``timeout`` bounds the wait for the TCP
        connect (the auth handshake then runs on the accepted socket)."""
        if timeout is not None:
            # Listener has no native timeout; poll the underlying socket
            sock = self._listener._listener._socket
            sock.settimeout(timeout)
        try:
            conn = self._listener.accept()
        except OSError as e:
            raise RpcError(f"accept failed/timed out: {e!r}") from e
        return RpcEndpoint(conn)

    def close(self) -> None:
        try:
            self._listener.close()
        except OSError:
            pass


def connect(address: Tuple[str, int], authkey: bytes) -> RpcEndpoint:
    """Worker-side dial back to the controller's listener."""
    return RpcEndpoint(Client(tuple(address), authkey=authkey))
