"""The coupling wire protocol, client side.

Frozen copy of the frame format of ``climsim_tpu_torch/online/server.py``
and ``runtime/climclient.c`` at commit ad9d7d2: a little-endian u32 header
(magic 0x434C4D54 "CLMT", rows, features) and float32 rows, row-major;
the reply mirrors it, and a reply of 0 rows reports an error.
"""

from __future__ import annotations

import socket
import struct

import numpy as np

MAGIC = 0x434C4D54
HEADER = struct.Struct("<III")


class WireError(RuntimeError):
    """The server closed the connection, sent a bad frame or an error."""


def _recv_into(sock: socket.socket, view: memoryview) -> None:
    got = 0
    while got < len(view):
        n = sock.recv_into(view[got:])
        if n == 0:
            raise WireError("peer closed")
        got += n


class Client:
    """One persistent connection; ``step`` sends a chunk and waits."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, frame: bytes) -> None:
        self.sock.sendall(frame)

    def recv(self) -> np.ndarray:
        hdr = bytearray(HEADER.size)
        _recv_into(self.sock, memoryview(hdr))
        magic, rows, feats = HEADER.unpack(hdr)
        if magic != MAGIC:
            raise WireError(f"bad magic {magic:#x}")
        if rows == 0:
            raise WireError("the server reported an error for this request")
        out = np.empty((rows, feats), "<f4")
        _recv_into(self.sock, memoryview(out).cast("B"))
        return out

    def close(self) -> None:
        self.sock.close()


def frame(x: np.ndarray) -> bytes:
    """The request frame of host rows ``x``."""
    x = np.ascontiguousarray(x, dtype="<f4")
    return HEADER.pack(MAGIC, x.shape[0], x.shape[1]) + x.tobytes()
