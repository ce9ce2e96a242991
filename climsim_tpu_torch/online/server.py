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
  * **Sharding** (``rules``, ``climsim_tpu/online/server.py:110-128``):
    high-res serving (21,600 columns a physics step) saturates several
    cards, and one sidecar feeds them all.  Rank 0 of the mesh listens,
    coalesces and splits each bucket over the data axis; every rank runs
    the wrapper on its rows on its own device (the others in
    :func:`serve_follower`), and rank 0 gathers the replies in row order.
    Headers and rows travel as host tensors on a gloo group of the
    server's own, as ``DistributedCheckpointer``'s do: the rows come from
    the socket as host arrays, and the dispatcher's traffic stays off the
    training group.
"""

from __future__ import annotations

import itertools
import logging
import queue
import socket
import struct
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.distributed as dist

from ..utils.profiling import record_span, span

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


def _recv_payload(sock: socket.socket, header: bytes) -> np.ndarray:
    """The array a received ``header`` announces, read from ``sock``."""
    magic, rows, feats = _HDR.unpack(header)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    data = _recv_exact(sock, rows * feats * 4)
    return np.frombuffer(data, dtype="<f4").reshape(rows, feats)


def _recv_array(sock: socket.socket) -> np.ndarray:
    return _recv_payload(sock, _recv_exact(sock, _HDR.size))


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


_END, _CALL = 0, 1


class _Shards:
    """The sharded call's collectives over the server's gloo group: a
    header (op, rows a rank, features) broadcast from the mesh's rank 0,
    the rows scattered, the replies gathered, all host float32 tensors.
    Making it is a collective: rank 0 (``CouplingServer``) and the others
    (``serve_follower``) make it at the same point."""

    def __init__(self, rules):
        if rules.model_size != 1:
            raise ValueError(f"a sharded server splits rows over the data "
                             f"axis only; model axis {rules.model_size}")
        mesh = rules.mesh
        self.n = rules.world_size
        self.src = mesh.global_rank(0, 0)
        self.group = dist.new_group(
            ranks=None if mesh.ranks is None else list(mesh.ranks),
            backend="gloo")

    def header(self, op: int = 0, rows: int = 0, feats: int = 0):
        """Rank 0 sends (op, rows, feats); every rank returns them."""
        h = torch.tensor([op, rows, feats], dtype=torch.int64)
        dist.broadcast(h, src=self.src, group=self.group)
        return tuple(int(v) for v in h)

    def scatter(self, x: torch.Tensor | None, rows: int, feats: int):
        """Rank 0's (n * rows, feats) -> each rank's (rows, feats)."""
        out = torch.empty(rows, feats, dtype=torch.float32)
        parts = list(x.split(rows)) if x is not None else None
        dist.scatter(out, parts, src=self.src, group=self.group)
        return out

    def gather(self, y: torch.Tensor, lead: bool):
        """Each rank's reply rows -> rank 0's, in row order."""
        y = y.float().contiguous()
        parts = [torch.empty_like(y) for _ in range(self.n)] if lead \
            else None
        dist.gather(y, parts, dst=self.src, group=self.group)
        return torch.cat(parts) if lead else None


def serve_follower(wrapper, n_features: int, rules) -> int:
    """A rank other than 0 of a sharded ``CouplingServer``: run
    ``wrapper`` on this rank's rows of every sharded call, on
    ``rules.device``, until rank 0's ``stop()`` sends the end.  Returns
    the number of calls served.  ``n_features`` is checked against each
    call's header."""
    shards = _Shards(rules)
    calls = 0
    while True:
        op, rows, feats = shards.header()
        if op == _END:
            return calls
        if feats != n_features:
            raise ValueError(f"a call of {feats} features, serving "
                             f"{n_features}")
        x = shards.scatter(None, rows, feats)
        with torch.inference_mode():
            y = wrapper(x.to(rules.device)).cpu()
        shards.gather(y, False)
        calls += 1


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
    rules : a ``ShardingRules`` (model axis 1): every coalesced bucket
        splits over the data axis, and each rank's rows run on its own
        device (``rules.device`` here); ``base_chunk`` and ``max_batch``
        are rounded up to multiples of the data axis.  Made on the mesh's
        rank 0, while every other rank runs ``serve_follower``.
    """

    def __init__(self, wrapper, n_features: int, base_chunk: int = 384,
                 max_batch: int = 6144, host: str = "127.0.0.1",
                 port: int = 0, warmup: bool = True, device="cuda",
                 rules=None):
        self._wrapper = wrapper
        self._shards = None
        if rules is not None:
            if rules.rank != 0:
                raise ValueError("the sharded server runs on rank 0; the "
                                 "other ranks run serve_follower")
            self._shards = _Shards(rules)
            n = rules.world_size
            base_chunk = -(-base_chunk // n) * n
            max_batch = -(-max_batch // n) * n
            device = rules.device
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
        self._requests_lock = threading.Lock()   # stats.requests
        self._q: queue.Queue = queue.Queue()
        # spans' ids: a request as its header arrives, a device call as
        # the dispatcher starts to gather it
        self._req_ids = itertools.count()
        self._call_ids = itertools.count()
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

    def _run(self, x: np.ndarray, call: int | None = None) -> np.ndarray:
        """One device call: host (B, n_features) float32 -> host output;
        with ``rules``, one call on every rank, B / world_size rows each.
        Spans ``server.h2d``, ``server.wrapper`` and ``server.d2h`` (the
        copy back, which waits for the card)."""
        if not x.flags.writeable:  # a received frame is a read-only buffer
            x = x.copy()
        xt = torch.from_numpy(x)
        sh = self._shards
        if sh is not None:
            rows = x.shape[0] // sh.n
            sh.header(_CALL, rows, x.shape[1])
            xt = sh.scatter(xt, rows, x.shape[1])
        with torch.inference_mode():
            with span("server.h2d", call=call):
                xt = xt.to(self.device)
            with span("server.wrapper", call=call):
                y = self._wrapper(xt)
            with span("server.d2h", call=call):
                y = y.cpu()
        if sh is not None:
            y = sh.gather(y, True)
        return y.numpy()

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
    # A queued request is (rows, reply queue, its req id, the time_ns it
    # was queued).  Spans: server.dispatch, a turn of the loop (the time
    # between its stages is the dispatcher's own Python, and its waits for
    # the GIL), holding server.wait (blocked on the queue),
    # server.coalesce (drain, concatenate, pad; a server.queued per
    # request taken, from its queueing to its taking), server.call (with
    # _run's children) and server.reply.
    def _dispatch_loop(self) -> None:
        carry = None  # request that would have overflowed the last group
        while not self._stop.is_set():
            if self.dispatch_paused.is_set():
                time.sleep(0.005)
                continue
            with span("server.dispatch"):
                carry = self._dispatch(carry)

    def _dispatch(self, carry):
        """One turn: wait for a request unless ``carry`` holds one, answer
        the group it heads with one device call; returns the request that
        would have overflowed the group, or None."""
        if carry is None:
            with span("server.wait"):
                try:
                    carry = self._q.get(timeout=0.05)
                except queue.Empty:
                    return None
        call = next(self._call_ids)
        with span("server.coalesce", call=call):
            group, taken = [carry], [time.time_ns()]
            carry = None
            rows = group[0][0].shape[0]
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
                taken.append(time.time_ns())
                rows += nxt[0].shape[0]
            for (_, _, req, queued_ns), t in zip(group, taken):
                record_span("server.queued", queued_ns, t, req=req,
                            call=call)
            x = np.concatenate([g[0] for g in group], axis=0) \
                if len(group) > 1 else group[0][0]
            n = x.shape[0]
            bucket = self._bucket(n)
            if n < bucket:
                x = np.concatenate(
                    [x, np.zeros((bucket - n, x.shape[1]), x.dtype)], axis=0)
        with span("server.call", call=call, timed=True) as timer:
            try:
                y = self._run(x, call)
            except Exception as e:  # noqa: BLE001 -- reply, don't die:
                # a dead dispatcher would hang every pending+future client
                _log.exception("device call failed for %d rows", n)
                for g in group:
                    g[1].put(e)
                return carry
        with span("server.reply", call=call):
            self.stats.batches += 1
            self.stats.rows += n
            self.stats.padded_rows += bucket - n
            self.stats.latencies_ms.append(timer.ns / 1e6)
            if len(self.stats.latencies_ms) > 10000:  # bound memory
                del self.stats.latencies_ms[:5000]
            off = 0
            for xb, reply, _, _ in group:
                reply.put(y[off:off + xb.shape[0]])
                off += xb.shape[0]
        return carry

    # -- per-connection reader -------------------------------------------
    # Spans: server.request, from the header's arrival to the reply's last
    # byte sent (the wait for the client's next header is the client's,
    # outside it), with server.read (to the parsed array) and server.send.
    def _client_loop(self, conn: socket.socket) -> None:
        try:
            while not self._stop.is_set():
                try:
                    header = _recv_exact(conn, _HDR.size)
                except (ConnectionError, OSError):
                    return
                req = next(self._req_ids)
                with span("server.request", req=req):
                    with span("server.read", req=req):
                        try:
                            x = _recv_payload(conn, header)
                        except (ConnectionError, OSError):
                            return
                    if x.shape[1] != self.n_features:
                        conn.close()
                        return
                    if x.shape[0] > self.max_batch:
                        conn.close()
                        return
                    reply: queue.Queue = queue.Queue(maxsize=1)
                    with self._requests_lock:
                        self.stats.requests += 1
                    self._q.put((x, reply, req, time.time_ns()))
                    out = reply.get()
                    if isinstance(out, Exception):
                        # error sentinel: a 0-row frame (requests are
                        # always >= 1 row, so unambiguous); the client
                        # raises
                        out = np.zeros((0, 1), np.float32)
                    with span("server.send", req=req):
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
        if self._shards is not None:   # the followers' end, once
            while self._threads and self._threads[0].is_alive():
                self._threads[0].join(0.1)   # the dispatcher, mid-call
            self._shards.header(_END)
            self._shards = None


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
