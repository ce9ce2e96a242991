"""Coupling bridge: serve the wrapped emulator to a host model over TCP.

The counterpart of ``climsim_tpu.online.server``.  The host model sends raw
column state over a socket, this sidecar answers with raw tendencies; the
wire format is the reference package's, unchanged, so the same host
clients (``CouplingClient``, ``runtime/climclient.c``) talk to either.

  * **Micro-batching.**  The dispatcher drains ALL queued requests and
    answers them with ONE device call, so concurrent host ranks share a
    dispatch.
  * **Buckets.**  Batches are padded up to a fixed ladder (powers of two
    over the base chunk up to ``max_batch``), and ``_warmup`` runs each
    bucket once before serving, which also builds and loads the kernels.
  * **Wire format** implementable from Fortran in ~20 lines: little-
    endian u32 header (magic, n_rows, n_features) + f32 row-major
    payload; the reply mirrors it; a 0-row reply reports an error.
"""

from __future__ import annotations

import logging
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

MAGIC = 0x434C4D54  # "CLMT"
_HDR = struct.Struct("<III")
_log = logging.getLogger(__name__)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf.extend(chunk)
    return bytes(buf)


def _send_array(sock: socket.socket, arr: np.ndarray) -> None:
    arr = np.ascontiguousarray(arr, dtype="<f4")
    sock.sendall(_HDR.pack(MAGIC, arr.shape[0], arr.shape[1]) +
                 arr.tobytes())


def _recv_array(sock: socket.socket) -> np.ndarray:
    magic, rows, feats = _HDR.unpack(_recv_exact(sock, _HDR.size))
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    data = _recv_exact(sock, rows * feats * 4)
    return np.frombuffer(data, dtype="<f4").reshape(rows, feats)


@dataclass
class ServerStats:
    requests: int = 0
    rows: int = 0
    batches: int = 0
    padded_rows: int = 0
    latencies_ms: list = field(default_factory=list)

    def summary(self) -> dict:
        lat = np.asarray(self.latencies_ms) if self.latencies_ms else \
            np.asarray([0.0])
        return {
            "requests": self.requests,
            "rows": self.rows,
            "batches": self.batches,
            "rows_per_batch": self.rows / max(self.batches, 1),
            "pad_fraction": self.padded_rows / max(
                self.rows + self.padded_rows, 1),
            "latency_ms_p50": float(np.percentile(lat, 50)),
            "latency_ms_p99": float(np.percentile(lat, 99)),
        }


class CouplingServer:
    """Serve ``wrapper(x_raw) -> y_raw`` over TCP with micro-batching across
    concurrent client requests.

    Parameters
    ----------
    wrapper : fn(tensor (B, n_features) on ``device``) -> tensor (B, n_out),
        e.g. ``online.wrapper.make_fast_mlp_wrapper`` output.
    n_features : expected input width (requests are validated).
    base_chunk : the host's natural chunk (384 for low-res E3SM);
        bucket ladder = base_chunk * 2**k up to ``max_batch``.
    host/port : bind address; port=0 picks a free port (see ``.port``).
    device : where batches are sent before the wrapper runs.
    """

    def __init__(self, wrapper, n_features: int, base_chunk: int = 384,
                 max_batch: int = 6144, host: str = "127.0.0.1",
                 port: int = 0, warmup: bool = True, device="cuda"):
        self._wrapper = wrapper
        self.device = torch.device(device)
        self.n_features = n_features
        self.buckets = []
        b = base_chunk
        while b < max_batch:
            self.buckets.append(b)
            b *= 2
        self.buckets.append(max_batch)
        self.max_batch = max_batch
        self.stats = ServerStats()
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        # tests (and drain-style maintenance) can hold the dispatcher to
        # force deterministic coalescing of queued requests
        self.dispatch_paused = threading.Event()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.port = self._sock.getsockname()[1]
        self._threads: list[threading.Thread] = []
        if warmup:
            self._warmup()

    def _run(self, x: np.ndarray) -> np.ndarray:
        """One device call: host (B, n_features) float32 -> host output."""
        if not x.flags.writeable:  # a received frame is a read-only buffer
            x = x.copy()
        with torch.inference_mode():
            y = self._wrapper(torch.from_numpy(x).to(self.device))
            return y.cpu().numpy()

    def _warmup(self) -> None:
        """Run every bucket before serving (no first-request stall)."""
        for b in self.buckets:
            self._run(np.zeros((b, self.n_features), np.float32))

    def _bucket(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    # -- dispatcher: drain queue, one device call per drained group ------
    def _dispatch_loop(self) -> None:
        carry = None  # request that would have overflowed the last group
        while not self._stop.is_set():
            if self.dispatch_paused.is_set():
                time.sleep(0.005)
                continue
            if carry is not None:
                first, carry = carry, None
            else:
                try:
                    first = self._q.get(timeout=0.05)
                except queue.Empty:
                    continue
            group = [first]
            rows = first[0].shape[0]
            # coalesce whatever is already queued, never beyond max_batch
            # (the largest bucket)
            while rows < self.max_batch:
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if rows + nxt[0].shape[0] > self.max_batch:
                    carry = nxt  # heads the next group
                    break
                group.append(nxt)
                rows += nxt[0].shape[0]
            x = np.concatenate([g[0] for g in group], axis=0) \
                if len(group) > 1 else group[0][0]
            n = x.shape[0]
            bucket = self._bucket(n)
            if n < bucket:
                x = np.concatenate(
                    [x, np.zeros((bucket - n, x.shape[1]), x.dtype)], axis=0)
            t0 = time.perf_counter()
            try:
                y = self._run(x)
            except Exception as e:  # noqa: BLE001 -- reply, don't die:
                # a dead dispatcher would hang every pending+future client
                _log.exception("device call failed for %d rows", n)
                for _, reply in group:
                    reply.put(e)
                continue
            dt = (time.perf_counter() - t0) * 1e3
            self.stats.batches += 1
            self.stats.rows += n
            self.stats.padded_rows += bucket - n
            self.stats.latencies_ms.append(dt)
            if len(self.stats.latencies_ms) > 10000:  # bound memory
                del self.stats.latencies_ms[:5000]
            off = 0
            for xb, reply in group:
                reply.put(y[off:off + xb.shape[0]])
                off += xb.shape[0]

    # -- per-connection reader -------------------------------------------
    def _client_loop(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    x = _recv_array(conn)
                except (ConnectionError, OSError):
                    return
                if x.shape[1] != self.n_features:
                    conn.close()
                    return
                if x.shape[0] > self.max_batch:
                    conn.close()
                    return
                self.stats.requests += 1
                reply: queue.Queue = queue.Queue(maxsize=1)
                self._q.put((x, reply))
                out = reply.get()
                if isinstance(out, Exception):
                    # error sentinel: a 0-row frame (requests are always
                    # >= 1 row, so unambiguous); the client raises
                    _send_array(conn, np.zeros((0, 1), np.float32))
                    continue
                _send_array(conn, out)
        finally:
            conn.close()

    def _accept_loop(self) -> None:
        self._sock.settimeout(0.2)
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            t = threading.Thread(target=self._client_loop, args=(conn,),
                                 daemon=True)
            t.start()
            self._threads.append(t)

    def start(self) -> "CouplingServer":
        for target in (self._dispatch_loop, self._accept_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        # join worker threads so no dispatch is mid-device-call when the
        # interpreter tears down
        for t in self._threads:
            t.join(timeout=2.0)


class CouplingClient:
    """Host-side stub: one persistent connection, blocking step() calls.

    The Fortran/C equivalent is a write(header+payload) / read(header+
    payload) pair per physics step -- this class exists for tests and
    Python hosts.
    """

    def __init__(self, host: str, port: int, timeout: float = 60.0):
        self._sock = socket.create_connection((host, port), timeout=timeout)

    def step(self, x_raw: np.ndarray) -> np.ndarray:
        _send_array(self._sock, np.asarray(x_raw, np.float32))
        out = _recv_array(self._sock)
        if out.shape[0] == 0:
            raise RuntimeError(
                "server reported a model-execution error for this request")
        return out

    def close(self) -> None:
        self._sock.close()
