"""Served cells: the port's coupling server under ranks in a closed loop.

Set-up draws the weights on the card from the seed, builds the
configuration's model and its coupling wrapper (``make_wrapper`` over the
fused U-Net engine, ``unet_apply_fused``), and a ``CouplingServer`` over
it.  The server's own warm-up is off: set-up runs the wrapper once at each
bucket of the server's ladder that the traffic can reach (up to clients x
chunk rows), and no other.  Then the load generator starts, in a process
of its own (``traffic/loadgen.py``); it connects a client a connection,
sends each client's first chunk once and says it is ready.  The window
opens when ``run`` tells it to go, and lasts ``--seconds``; the ranks
step together, each step as soon as the last has its replies, so the
server runs at the rate it sustains.

``served_columns_per_s`` is every column replied to inside the window
over the window.  The round trips of the requests are timed at the
client from their step's start to the reply, a failed one counted as
+inf; their nearest-rank 95th percentile outside the traced stretch is
the per-layer ``round_trip_p95_ms.serve``.  The server's counts
(``ServerStats``) are read at the window's two ends, and in a traced run
also around the traced stretch, which the per-layer metrics leave out.
The wrapper is called through ``CallLog``, which notes each device call's
rows and marks it with a profiler range ``portbench.device_call.<rows>``.

Correctness: the replies of a sample drawn from the seed (``keep`` a
client, and each client's first) against the reference's answer to the
same raw columns, by ``harness.gap_by_column`` in scaled units; every
request must have been answered.
"""

from __future__ import annotations

import gc
import os
import shutil
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

from .. import harness
from ..reference.common import CASTS, load_norms
from ..traffic.loadgen import client_chunks
from ..traffic.varspec import Layout


class CallLog:
    """The wrapper as the server calls it, in the dispatcher's thread: each
    call's rows noted and its range marked; and, in a traced run, the
    profiler started and stopped there, between two calls, with the
    server's counts read at the stretch's start and at the first call
    after the one that stopped it."""

    def __init__(self, fn, stats, tracer=None):
        self.fn, self.stats, self.tracer = fn, stats, tracer
        self.rows, self.traced = [], []
        self.t0 = None               # the window's start, once it opened
        self.marks: dict = {}        # "start", "resume": (counts, time)
        self.closing = False         # the window is over: stop the tracer

    def __call__(self, x):
        import torch

        b = int(x.shape[0])
        tr = self.tracer
        if tr is not None and self.t0 is not None:
            now = time.perf_counter()
            if "stop" in self.marks and "resume" not in self.marks:
                self.marks["resume"] = (_snapshot(self.stats), now)
            counts = _snapshot(self.stats)
            if self.closing and tr.on:
                tr.stop()
            event = tr.poll(now - self.t0)
            if event == "start":
                self.marks["start"] = (counts, now)
            elif event == "stop":
                self.marks["stop"] = True
            if tr.on:
                self.traced.append(b)
        self.rows.append(b)
        with torch.profiler.record_function(f"portbench.device_call.{b}"):
            return self.fn(x)


def build(ctx):
    """(wrapper, the weights on the host) of the cell on ``ctx.device``."""
    import torch

    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.norms import NormStats
    from climsim_tpu_torch.online.wrapper import WrapperConfig, make_wrapper
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.varspec import get_varspec

    cfg = ctx.config
    weights = ctx.reference.make_weights(cfg, ctx.seed, ctx.device)
    model = ClimSimUNet(get_varspec(cfg["varspec"]),
                        compute_dtype=getattr(torch,
                                              cfg["precision"]["compute"]),
                        device=ctx.device, **cfg["model"])
    model.load_state_dict(weights, strict=True)
    host = {k: harness.host_copy(v) for k, v in weights.items()}
    del weights
    stats = NormStats.from_npz(ctx.cell.path(cfg["norms"]))
    wrapper = make_wrapper(
        partial(unet_apply_fused, model.eval()), stats,
        WrapperConfig(input_version=cfg["serve"]["input_version"]),
        device=ctx.device)
    return wrapper, host


def _snapshot(stats) -> dict:
    return {"requests": stats.requests, "rows": stats.rows,
            "batches": stats.batches, "padded_rows": stats.padded_rows,
            "latencies": len(stats.latencies_ms)}


def _between(stats, a: dict, b: dict) -> dict:
    """The server's counts from snapshot ``a`` to ``b``, with the device
    calls' times between them."""
    out = {k: b[k] - a[k] for k in ("requests", "rows", "batches",
                                    "padded_rows")}
    out["latencies_ms"] = list(stats.latencies_ms[a["latencies"]:
                                                  b["latencies"]])
    return out


def _flush(port: int, features: int, rows: int) -> None:
    """One request after the window, so that the dispatcher's thread,
    which started the profiler, stops it where the stretch outlasted the
    window's calls."""
    from ..traffic.wire import Client, frame

    c = Client("127.0.0.1", port)
    try:
        c.send(frame(np.zeros((rows, features), np.float32)))
        c.recv()
    finally:
        c.close()


def _untraced(stats, before: dict, end: dict, t0: float, t_end: float,
              marks: dict) -> dict:
    """The server's counts over the window, leaving out a traced stretch:
    from the window's start to the stretch's, and from the first call
    after the stretch to the end; with the seconds they span."""
    if "start" not in marks:
        return {**_between(stats, before, end), "seconds": t_end - t0}
    parts = [_between(stats, before, marks["start"][0])]
    seconds = marks["start"][1] - t0
    if "resume" in marks and marks["resume"][1] < t_end:
        parts.append(_between(stats, marks["resume"][0], end))
        seconds += t_end - marks["resume"][1]
    out = {k: sum((p[k] for p in parts), [] if k == "latencies_ms" else 0)
           for k in parts[0]}
    return {**out, "seconds": seconds}


def _host_ticks() -> tuple:
    """(this process's CPU ticks, the machine's steal ticks, all its CPU
    ticks) so far, from /proc; zeros where it cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            own = f.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as f:
            cpu = [int(v) for v in f.readline().split()[1:]]
        return int(own[11]) + int(own[12]), cpu[7], sum(cpu[:8])
    except (OSError, ValueError, IndexError):
        return 0, 0, 0


def _stretch(marks: dict, t0: float) -> tuple:
    """The traced stretch in seconds from the window's start, from its
    start to the first call after it; (inf, inf) where none was traced."""
    if "start" not in marks:
        return float("inf"), float("inf")
    end = marks["resume"][1] - t0 if "resume" in marks else float("inf")
    return marks["start"][1] - t0, end


def _expect(proc, word: str) -> None:
    line = proc.stdout.readline().strip()
    if line != word:
        raise RuntimeError(f"the load generator said {line!r}, not {word!r}"
                           f" (exit {proc.poll()})")


def run(ctx) -> dict:
    import torch

    from climsim_tpu_torch.online.server import CouplingServer

    cfg, mix = ctx.config, ctx.mix
    wire = Layout(cfg["serve"]["wire_varspec"])
    most = mix["clients"] * mix["chunk"]
    wrapper, weights = build(ctx)
    harness.say(ctx.t_process, "wrapper built, weights loaded")
    calls = CallLog(wrapper, None, ctx.tracer)
    server = CouplingServer(calls, wire.input_len,
                            base_chunk=mix["base_chunk"],
                            max_batch=mix["max_batch"], warmup=False,
                            device=ctx.device)
    calls.stats = server.stats
    reach = [b for b in server.buckets if b < most] + [server._bucket(most)]
    with torch.inference_mode():
        for b in reach:
            calls(torch.zeros(b, wire.input_len, device=ctx.device)).cpu()
    calls.rows.clear()
    if ctx.tracer is not None:
        ctx.tracer.warm()
    harness.say(ctx.t_process, f"buckets {reach} warmed")
    server.start()
    tmp = tempfile.mkdtemp(prefix="portbench-")
    out = os.path.join(tmp, "loadgen.npz")
    proc = subprocess.Popen(
        [sys.executable, str(harness.HERE / "traffic" / "loadgen.py"),
         "--port", str(server.port), "--clients", str(mix["clients"]),
         "--chunk", str(mix["chunk"]),
         "--chunks-per-client", str(mix["chunks_per_client"]),
         "--layout", wire.name, "--seed", str(ctx.seed),
         "--keep", str(mix["keep"]), "--out", out],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        _expect(proc, "ready")
        harness.say(ctx.t_process, "load generator ready")
        before = _snapshot(server.stats)
        ticks = _host_ticks()
        proc.stdin.write(f"go {ctx.seconds!r}\n")
        proc.stdin.flush()
        t0 = calls.t0 = time.perf_counter()
        setup_s = t0 - ctx.t_process
        _expect(proc, "done")
        t_end = time.perf_counter()
        end = _snapshot(server.stats)
        ticks = [b - a for a, b in zip(ticks, _host_ticks())]
        proc.wait(timeout=60)
        tracer = ctx.tracer
        if tracer is not None and tracer.on:
            calls.closing = True
            _flush(server.port, wire.input_len, mix["chunk"])
        counted = _untraced(server.stats, before, end, t0, t_end,
                            calls.marks)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    rec = dict(np.load(out))
    shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() if str(
        ctx.device).startswith("cuda") else 0

    secs = ctx.seconds
    columns, p95, attempted, failed = window_metrics(rec, mix["chunk"], secs)
    late = (np.asarray(rec["t_send"]) - np.asarray(rec["due"])).tolist()
    harness.say(ctx.t_process, f"{attempted} requests due, {columns} "
                f"columns answered in the window, round trip p95 {p95:.1f} "
                f"ms; sends after the step's "
                f"start by at most {1e3 * max(late, default=0.0):.1f} ms, "
                f"p95 {1e3 * harness.nearest_rank(late or [0.0], 0.95):.1f}"
                f"; {step_times(rec, secs)}; the server's CPU "
                f"{ticks[0] / os.sysconf('SC_CLK_TCK'):.1f} s, the machine's "
                f"steal {100 * ticks[1] / max(ticks[2], 1):.2f}% of its CPU "
                f"time")
    lo, hi = _stretch(calls.marks, t0)
    due = np.asarray(rec["due"], float)
    outside = (due < lo) | (due > hi)
    data = {"kind": "serve", "config": ctx.config,
            "reference": ctx.reference, "server": counted,
            "round_trips_ms": round_trips_ms(rec)[outside].tolist(),
            "traced_rows": calls.traced, "trace": tracer}

    del server, calls, wrapper
    gc.collect()
    if str(ctx.device).startswith("cuda"):
        torch.cuda.empty_cache()
    checks = {"reply_gap": reply_gap(ctx, weights, rec),
              "failed_requests": failed}
    harness.say(ctx.t_process, "replies compared")
    checks = {k: {"value": v, "limit": ctx.limits[k]}
              for k, v in checks.items()}
    return {"correct": all(c["value"] <= c["limit"]
                           for c in checks.values()),
            "attempted": attempted, "failed": failed,
            "end_to_end": {
                "served_columns_per_s": {"value": columns / secs,
                                         "unit": "columns/s"},
                "setup_s": {"value": setup_s, "unit": "s"}},
            "checks": checks, "memory_peak_bytes": peak, "data": data}


def round_trips_ms(rec: dict) -> np.ndarray:
    """Each request's round trip in ms, from when it was due (its step's
    start) to its reply; +inf for a failed one."""
    ok = np.asarray(rec["ok"], bool)
    due = np.asarray(rec["due"], float)
    return np.where(ok, (np.asarray(rec["t_recv"], float) - due) * 1e3,
                    np.inf)


def window_metrics(rec: dict, chunk: int, seconds: float) -> tuple:
    """(columns replied to inside the window, the nearest-rank p95 of the
    round trips in ms, requests due, requests failed) of the load
    generator's record: every request was due inside the window; a round
    trip runs from when the request was due (its step's start); one answered after the
    window counts in the tail but not in the columns, and a failed one
    counts as +inf."""
    ok = np.asarray(rec["ok"], bool)
    t_recv = np.asarray(rec["t_recv"], float)
    columns = int(chunk * np.sum(ok & (t_recv <= seconds)))
    return (columns, harness.nearest_rank(round_trips_ms(rec).tolist(),
                                          0.95),
            int(ok.size), int(np.sum(~ok)))


def step_times(rec: dict, seconds: float) -> str:
    """The steps of the window in a line: how many, the median and p95 of
    their length (start to the last reply) and the steps a second in each
    half of the window."""
    due = np.asarray(rec["due"], float)
    t_recv = np.asarray(rec["t_recv"], float)
    starts = np.unique(due)
    if starts.size == 0:
        return "no steps"
    ms = [1e3 * (t_recv[due == d].max() - d) for d in starts]
    ends = starts + np.asarray(ms) / 1e3
    halves = [int(np.sum((ends <= seconds / 2))),
              int(np.sum((ends > seconds / 2) & (ends <= seconds)))]
    return (f"{starts.size} steps, median {np.median(ms):.1f} ms, p95 "
            f"{harness.nearest_rank(ms, 0.95):.1f} ms; steps a second in "
            f"the two halves {2 * halves[0] / seconds:.2f}, "
            f"{2 * halves[1] / seconds:.2f}")


def reference_replies(ctx, weights, cast="exact"):
    """(clients, chunks, chunk, outputs): the reference's answer to every
    chunk of every client, and the wire's scale."""
    import torch

    cfg, mix = ctx.config, ctx.mix
    norms = load_norms(ctx.cell.path(cfg["norms"]))
    x = client_chunks(cfg["serve"]["wire_varspec"], mix["clients"],
                      mix["chunks_per_client"], mix["chunk"], ctx.seed)
    shape = x.shape
    xt = torch.as_tensor(x.reshape(-1, shape[-1]), device=ctx.device)
    y = ctx.reference.serve(cfg, {k: v.to(ctx.device)
                                  for k, v in weights.items()},
                            norms, xt, CASTS[cast])
    return (y.cpu().reshape(*shape[:3], -1),
            ctx.reference.wire_scale(norms))


def reply_gap(ctx, weights, rec: dict) -> float:
    """The widest gap of the kept replies to the reference's."""
    ref, scale = reference_replies(ctx, weights)
    if rec["kept_reply"].shape[0] == 0:
        return float("inf")
    return max(harness.gap_by_column(y, ref[c, k], scale)
               for c, k, y in zip(rec["kept_client"], rec["kept_chunk"],
                                  rec["kept_reply"]))
