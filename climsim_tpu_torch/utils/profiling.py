"""Profiling and observability (the counterpart of
``climsim_tpu.utils.profiling``):

  * ``span`` / ``record_span`` -- named spans of the program's own work
    (the coupling server's stages, the train step's parts), kept in a
    bounded in-memory ring and read back by ``spans``; ``profiler_range``
    -- a profiler range alone (the launches of kernels 1, 4 and 5);
  * ``trace`` -- a ``torch.profiler`` context writing a Chrome trace that
    TensorBoard and Perfetto load, the spans of every thread in it;
  * ``time_fn`` -- the median wall time of a call, synchronized with the
    card;
  * ``cost_analysis`` -- the products' FLOPs of a call
    (``torch.utils.flop_counter``) and its peak device memory;
  * ``MetricsLogger`` -- JSONL + CSV run logging.

**Spans.**  Tracing is on while a ``torch.profiler`` profile records in
the process, in any thread: ``with trace(logdir): ...`` or any
``torch.profiler.profile`` an operator starts.  There is no other switch.
Off, ``span`` is one read of the profiler's global flag and returns a
shared no-op context: it allocates nothing and calls nothing in torch.
On, a span opens ``torch.profiler.record_function(name)`` in a thread the
profiler records (a host event there, with its kernels' device-side
range; in other threads none) and, at its end, appends a ``SpanRecord``
to the ring: its name,
thread (native id), start and end in ns on ``time.time_ns``'s clock, which
is the profiler's (Kineto's event times, made relative by the result's
``trace_start_ns()``), the thread's CPU ns over it (``time.thread_time_ns``:
wall time minus CPU time is waiting, for I/O or for the GIL), its ids and
its parent, the span open around it in the same thread.  The ids:

  * ``req`` -- a request of the coupling server, numbered by the server as
    its header arrives (``server.request``, ``server.read``,
    ``server.queued``, ``server.send``);
  * ``call`` -- the server's device call that answered it, numbered by the
    dispatcher (``server.coalesce``, ``server.queued``, ``server.call`` and
    its children ``server.h2d``, ``server.wrapper``, ``server.d2h``,
    ``server.reply``);
  * ``step`` -- a training step, the updates its state made before it
    (``train.forward``, ``train.backward``, ``train.optimizer``; the loader's
    ``train.batch``, the batches it drew before).

The dispatcher's ``server.dispatch`` (a turn of its loop) and
``server.wait`` carry no id.  An operator sees the spans in a profiler's
Chrome trace by ``with trace(logdir):`` around the stretch to look at
(each thread's spans on a row of their own), or reads them with ``spans``
while or after any ``torch.profiler`` profile ran.

The ring keeps the newest ``RING_SPANS`` records; ``dropped`` counts the
records it overwrote, by the second they ended in, so a reader of a
stretch can tell that the stretch is incomplete.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler
from torch.utils.flop_counter import FlopCounterMode

RING_SPANS = 1 << 17       # records the ring keeps


class SpanRecord(NamedTuple):
    name: str
    thread: int            # the thread's native id
    start_ns: int          # time.time_ns(), the profiler's clock
    end_ns: int
    cpu_ns: int | None     # the thread's CPU time over it; None where the
    #                        span was recorded after the fact
    req: int | None
    call: int | None
    step: int | None
    id: int
    parent: int | None     # the span open around it in its thread


class _Ring:
    """The newest ``capacity`` records, and how many it overwrote, by the
    second (of ``time.time_ns``) their end fell in."""

    def __init__(self, capacity: int):
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self.lost: dict[int, int] = {}
        self.lock = threading.Lock()

    def add(self, rec: SpanRecord) -> None:
        with self.lock:
            if len(self.records) == self.records.maxlen:
                sec = self.records[0].end_ns // 1_000_000_000
                self.lost[sec] = self.lost.get(sec, 0) + 1
            self.records.append(rec)


_RING = _Ring(RING_SPANS)
_IDS = itertools.count(1)
_LOCAL = threading.local()
_THREAD_NAMES: dict[int, str] = {}
# whether the profiler records this thread (its state is the thread's own)
_profiled = torch._C._autograd._profiler_enabled


def _thread() -> tuple:
    """(this thread's native id, the ids of the spans open in it,
    innermost last), made at its first span."""
    state = getattr(_LOCAL, "state", None)
    if state is None:
        tid = threading.get_native_id()
        state = _LOCAL.state = (tid, [])
        _THREAD_NAMES[tid] = threading.current_thread().name
    return state


class _Off:
    """The span while tracing is off: a shared context that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Clock:
    """A timed span while tracing is off: its start and end, nothing
    recorded."""

    __slots__ = ("start_ns", "end_ns")

    def __enter__(self):
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        return False

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


class _Span(_Clock):
    """A span while tracing is on (see the module's docstring)."""

    __slots__ = ("name", "ids", "id", "parent", "_range", "_cpu0")

    def __init__(self, name: str, ids: tuple):
        self.name, self.ids = name, ids

    def __enter__(self):
        _, stack = _thread()
        self.parent = stack[-1] if stack else None
        self.id = next(_IDS)
        stack.append(self.id)
        self.start_ns = time.time_ns()
        self._cpu0 = time.thread_time_ns()
        # a range only where the profiler records this thread: elsewhere
        # it would leave no event and cost the thread its time
        self._range = (torch.profiler.record_function(self.name)
                       if _profiled() else None)
        if self._range is not None:
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        if self._range is not None:
            self._range.__exit__(*exc)
        cpu = time.thread_time_ns() - self._cpu0
        self.end_ns = time.time_ns()
        tid, stack = _thread()
        stack.pop()
        _RING.add(SpanRecord(self.name, tid, self.start_ns, self.end_ns, cpu,
                             *self.ids, self.id, self.parent))
        return False


def span(name: str, req: int | None = None, call: int | None = None,
         step: int | None = None, timed: bool = False):
    """A context around a stretch of the program's work (see the module's
    docstring).  ``timed``: the context reads the clock even when tracing
    is off, and its ``ns`` after the block is the block's length, so one
    measurement feeds both a program's statistic and the span."""
    if not _autograd_profiler._is_profiler_enabled:
        return _Clock() if timed else _OFF
    return _Span(name, (req, call, step))


def profiler_range(name: str):
    """A profiler range, not a span: a host event where the profiler
    records this thread, with its device-side range, and nothing in the
    ring; the shared no-op elsewhere.  For a launch the program makes many
    times a step (kernel 5's, 82 a U-Net forward), where a span's ring
    record and CPU clock would add to a traced step's host time."""
    if _autograd_profiler._is_profiler_enabled and _profiled():
        return torch.profiler.record_function(name)
    return _OFF


def record_span(name: str, start_ns: int, end_ns: int,
                req: int | None = None, call: int | None = None,
                step: int | None = None) -> None:
    """Record a span that started in the past (``start_ns``, ``end_ns`` on
    ``time.time_ns``'s clock), with no host event; its parent is the span
    open in this thread, and its CPU time is not known (None)."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    tid, stack = _thread()
    _RING.add(SpanRecord(name, tid, start_ns, end_ns,
                         None, req, call, step, next(_IDS),
                         stack[-1] if stack else None))


def spans(since_ns: int | None = None,
          until_ns: int | None = None) -> list[SpanRecord]:
    """The ring's records that overlap [since_ns, until_ns] (either end
    None: open), in the order they ended."""
    lo = -1 if since_ns is None else since_ns
    hi = float("inf") if until_ns is None else until_ns
    with _RING.lock:
        recs = list(_RING.records)
    return [r for r in recs if r.end_ns >= lo and r.start_ns <= hi]


def dropped(since_ns: int | None = None, until_ns: int | None = None) -> int:
    """Records the ring overwrote that ended in the seconds [since_ns,
    until_ns] touches (the whole second at each end): nonzero means
    ``spans`` of that interval may be incomplete."""
    lo = -1 if since_ns is None else since_ns // 1_000_000_000
    hi = float("inf") if until_ns is None else until_ns // 1_000_000_000
    with _RING.lock:
        return sum(n for sec, n in _RING.lost.items() if lo <= sec <= hi)


def _span_events(recs, base_ns: int, pid: int) -> list:
    """Chrome-trace complete events of ``recs`` (µs from ``base_ns``), one
    row a thread, with the rows' names."""
    out = []
    for tid in sorted({r.thread for r in recs}):
        out.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                    "args": {"name": f"spans: "
                             f"{_THREAD_NAMES.get(tid, str(tid))}"}})
    for r in recs:
        args = {k: getattr(r, k) for k in ("id", "parent", "req", "call",
                                           "step")
                if getattr(r, k) is not None}
        if r.cpu_ns is not None:
            args["cpu_us"] = r.cpu_ns / 1e3
        out.append({"ph": "X", "cat": "span", "name": r.name, "pid": pid,
                    "tid": r.thread, "ts": (r.start_ns - base_ns) / 1e3,
                    "dur": (r.end_ns - r.start_ns) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, where there is a card, device
    activity) and write ``trace_<pid>.json`` into ``logdir``: the
    profiler's events, and the spans every thread recorded while it ran,
    on rows of their threads, on the trace's own time base."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        yield prof
    recs = spans(t0, time.time_ns())
    path = os.path.join(logdir, f"trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_span_events(
        recs, int(doc.get("baseTimeNanoseconds", 0)), os.getpid()))
    with open(path, "w") as f:
        json.dump(doc, f)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 50, warmup: int = 2) -> float:
    """Median wall time per call (seconds), each call ended by a
    synchronize of the card; the ``warmup`` calls (kernel builds, first
    allocations) are not timed."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _gn_silu_conv3_flops(x_shape, gamma_shape, beta_shape, w_shape, b_shape,
                         out_shape=None, **kw) -> int:
    """Kernel 5's products: a k = 3 convolution, 2 * B * L * C_in * C_out *
    3.  Its GroupNorm and silu are elementwise; FlopCounterMode counts
    products only, so they count 0, as the plain chain's do."""
    b, l, c = x_shape
    return 2 * b * l * c * w_shape[2] * 3


def kernel_formulas() -> dict:
    """FlopCounterMode formulas of the port's torch.library operators.
    Kernel 5 holds the U-Net's k = 3 convolutions (82 chains a forward);
    without its formula a U-Net count silently loses most of its
    products.  Kernels 1 and 4 are elementwise and count 0."""
    from ..ops import unet_fused

    op = getattr(torch.ops, unet_fused.OPS_NAMESPACE).fused_gn_silu_conv3
    return {op: _gn_silu_conv3_flops}


def cost_analysis(fn, *args) -> dict:
    """``{"flops", "flops_by_op", "peak_memory_bytes"}`` of one call of
    ``fn(*args)`` (the counterpart of XLA's cost analysis, itself the
    analog of fvcore's FlopCountAnalysis, HSR/training/hpo.py:30).

    ``flops`` are the products' (matmuls, convolutions, attention) as
    ``torch.utils.flop_counter`` counts them, with ``kernel_formulas``
    for the port's operators; while the counter runs, kernel 5 is called
    through its operator so that the count sees it.  ``flops_by_op``
    splits the count by operator.  ``peak_memory_bytes`` is the card's
    peak allocation during the call (``max_memory_allocated`` after
    ``reset_peak_memory_stats``), left out without a card.  XLA's
    ``bytes accessed`` has no PyTorch counterpart and is left out."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False,
                         custom_mapping=kernel_formulas()) as counter:
        fn(*args)
    out = {"flops": float(counter.get_total_flops()),
           "flops_by_op": {str(k): float(v) for k, v in
                           counter.get_flop_counts()["Global"].items()}}
    if cuda:
        torch.cuda.synchronize()
        out["peak_memory_bytes"] = float(torch.cuda.max_memory_allocated())
    return out


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics stream + end-of-run CSV table."""

    directory: str
    name: str = "run"
    _rows: list = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._path = os.path.join(self.directory, f"{self.name}.jsonl")

    def log(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **metrics}
        self._rows.append(row)
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def to_csv(self, path: str | None = None):
        path = path or os.path.join(self.directory, f"{self.name}.csv")
        if not self._rows:
            return path
        keys = sorted({k for r in self._rows for k in r})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self._rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")
        return path
