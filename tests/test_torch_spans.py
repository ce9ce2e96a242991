"""The port's spans (utils.profiling.span / record_span / spans / trace) on
the CPU: off they record nothing and open no profiler range; under a
profiler a span in the profiled thread is a host event around its aten
op, a span of another thread is in the ring only, and both sit on the
profiler's timeline (a profiler_range is a host event of the profiled
thread alone, never in the ring); the coupling server's spans join each request to
the device call that answered it, and its counts are as before; one train
step gives one forward, backward and optimizer span; ``trace`` writes the
spans of every thread into its Chrome trace."""

import json
import sys
import threading
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from climsim_tpu_torch import get_varspec, load_asset_norms
from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
from climsim_tpu_torch.data.synthetic import synthetic_split
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.online.server import CouplingClient, CouplingServer
from climsim_tpu_torch.train import recipes
from climsim_tpu_torch.utils import profiling as PF


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_a_span_records_nothing_and_opens_no_range(monkeypatch):
    def no_range(name):
        raise AssertionError(f"a profiler range {name!r} was opened")

    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    assert not torch.autograd.profiler._is_profiler_enabled
    t0 = time.time_ns()
    a, b = PF.span("a", step=1), PF.span("b", req=2)
    assert a is b is PF.profiler_range("r")   # one shared no-op context
    with a:
        torch.ones(4).add_(1)
    PF.record_span("c", t0, time.time_ns(), call=3)
    with PF.span("d", timed=True) as timer:
        pass
    assert timer.ns >= 0                  # timed: the clock, nothing kept
    assert PF.spans(t0, time.time_ns()) == []


def test_spans_on_the_profilers_timeline():
    """The profiled thread's span is a host event that brackets its aten
    op; the second thread's is in the ring only; aligned by the result's
    trace_start_ns(), each ring span lies within 1 ms of the profiler's
    events around it."""
    def other():
        with PF.span("spans.other", req=5):
            torch.ones(8).mul_(2)
        with PF.profiler_range("spans.other_range"):
            pass

    with _cpu_profile() as prof:
        with torch.profiler.record_function("spans.warm"):
            pass                       # the first range's one-time cost
        with PF.span("spans.main", step=1):
            torch.ones(16).add_(1)
        with PF.profiler_range("spans.range"):
            pass
        th = threading.Thread(target=other)
        th.start()
        th.join()
        with torch.profiler.record_function("spans.after"):
            pass
    t0 = prof.profiler.kineto_results.trace_start_ns()
    evs = prof.events()
    main = _named(evs, "spans.main")
    assert len(main) == 1 and not _named(evs, "spans.other")
    # a profiler range: a host event in the profiled thread only
    assert len(_named(evs, "spans.range")) == 1
    assert not _named(evs, "spans.other_range")
    main = main[0]
    add = [e for e in evs if e.name == "aten::add_"
           and main.time_range.start <= e.time_range.start
           and e.time_range.end <= main.time_range.end]
    assert len(add) == 1
    after = _named(evs, "spans.after")[0]
    recs = PF.spans(t0, time.time_ns())
    (rm,), (ro,) = _named(recs, "spans.main"), _named(recs, "spans.other")
    assert not {r.name for r in recs} & {"spans.range", "spans.other_range"}
    assert (rm.step, rm.req, ro.req, ro.step) == (1, None, 5, None)
    assert ro.thread != rm.thread and ro.parent is None
    assert rm.cpu_ns is not None and rm.cpu_ns >= 0

    def us(ns):
        return (ns - t0) / 1e3

    # the ring's span holds the profiler's host event, within 1 ms
    assert 0 <= main.time_range.start - us(rm.start_ns) < 1000
    assert 0 <= us(rm.end_ns) - main.time_range.end < 1000
    # the other thread's span lies between the two profiled events
    assert us(ro.start_ns) > main.time_range.end - 1000
    assert us(ro.end_ns) < after.time_range.start + 1000
    assert us(ro.start_ns) <= us(ro.end_ns)


def test_nested_spans_name_their_parent_and_record_span_its_thread():
    t0 = time.time_ns()
    with _cpu_profile():
        with PF.span("spans.outer", call=1) as outer:
            with PF.span("spans.inner", call=1):
                PF.record_span("spans.past", t0, time.time_ns(), req=9)
    recs = PF.spans(t0, time.time_ns())
    (o,), (i,), (p,) = (_named(recs, n) for n in
                        ("spans.outer", "spans.inner", "spans.past"))
    assert o.id == outer.id and i.parent == o.id and p.parent == i.id
    assert p.cpu_ns is None and (p.req, p.start_ns) == (9, t0)
    assert PF.dropped(t0, time.time_ns()) == 0


def _echo(x):
    return x[:, :8] * 2.0 + 1.0


def test_server_spans_join_each_request_to_its_call():
    """Two clients, three requests each, under a CPU profiler started in
    this thread: each request has server.request, server.read,
    server.queued and server.send with its req; each server.queued names
    a call with its own server.call, in a turn of the dispatcher
    (server.dispatch); ServerStats counts as without spans, and its
    device-call times are the server.call spans' own."""
    srv = CouplingServer(_echo, n_features=16, base_chunk=64, max_batch=256,
                         warmup=False, device="cpu").start()
    rng = np.random.default_rng(0)
    xs = [[rng.normal(size=(n, 16)).astype(np.float32) for n in (64, 50, 7)]
          for _ in range(2)]
    outs = [[], []]

    def client(i):
        cl = CouplingClient("127.0.0.1", srv.port)
        for x in xs[i]:
            outs[i].append(cl.step(x))
        cl.close()

    try:
        t0 = time.time_ns()
        with _cpu_profile():
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
        t1 = time.time_ns()
    finally:
        srv.stop()
    for i in range(2):
        for x, y in zip(xs[i], outs[i]):
            np.testing.assert_array_equal(y, x[:, :8] * np.float32(2) + 1)
    recs = PF.spans(t0, t1)
    reqs = {r.req for r in _named(recs, "server.request")}
    assert len(reqs) == 6
    for name in ("server.read", "server.queued", "server.send"):
        assert sorted(r.req for r in _named(recs, name)) == sorted(reqs)
    calls = {r.call: r for r in _named(recs, "server.call")}
    coalesce = {r.call: r for r in _named(recs, "server.coalesce")}
    for q in _named(recs, "server.queued"):
        assert q.call in calls and q.end_ns <= calls[q.call].start_ns
        assert q.parent == coalesce[q.call].id
    # a turn entered before the profiler started is no span: its call has
    # no parent
    turns = {r.id for r in _named(recs, "server.dispatch")}
    assert all(c.parent in turns | {None} for c in calls.values())
    assert any(c.parent in turns for c in calls.values())
    for name in ("server.h2d", "server.wrapper", "server.d2h"):
        kids = _named(recs, name)
        assert sorted(k.call for k in kids) == sorted(calls)
        assert all(k.parent == calls[k.call].id for k in kids)
    st = srv.stats
    assert st.requests == 6 and st.batches == len(calls)
    assert st.rows == 2 * (64 + 50 + 7)
    assert st.latencies_ms == [(c.end_ns - c.start_ns) / 1e6 for c in
                               sorted(calls.values(), key=lambda r: r.call)]


def test_requests_are_counted_across_many_connection_threads():
    """16 clients of 10 requests each, more threads than cores, the
    interpreter switching threads every microsecond: ServerStats.requests
    counts every request (it is counted under a lock), as do the spans."""
    srv = CouplingServer(_echo, n_features=16, base_chunk=64, max_batch=256,
                         warmup=False, device="cpu").start()
    x = np.ones((4, 16), np.float32)
    failed = []

    def client():
        cl = CouplingClient("127.0.0.1", srv.port)
        try:
            for _ in range(10):
                if not np.array_equal(cl.step(x), x[:, :8] * 2 + 1):
                    failed.append(1)
        finally:
            cl.close()

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.time_ns()
        with _cpu_profile():
            threads = [threading.Thread(target=client) for _ in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
                assert not t.is_alive()
        t1 = time.time_ns()
    finally:
        sys.setswitchinterval(switch)
        srv.stop()
    assert not failed and srv.stats.requests == 160
    recs = PF.spans(t0, t1)
    assert len({r.req for r in _named(recs, "server.request")}) == 160
    assert len(_named(recs, "server.queued")) == 160


def test_one_train_step_gives_one_span_of_each_part():
    spec = get_varspec("v1")
    x, y = synthetic_split(spec, 64, load_default_grid(), seed=0)
    tr = recipes.mlp_trainer(spec, load_asset_norms("v1"), None, 0,
                        hidden=(16,), compute_dtype=torch.float32,
                        device="cpu")
    loader = DeviceResidentLoader(x, y, 32, seed=0, device="cpu")
    t0 = time.time_ns()
    with _cpu_profile():
        xb, yb = next(iter(loader))
        tr.train_step(tr.state, xb, yb)
    recs = PF.spans(t0, time.time_ns())
    for name in ("train.forward", "train.backward", "train.optimizer"):
        (r,) = _named(recs, name)
        assert r.step == 0
    parts = [_named(recs, n)[0] for n in ("train.forward", "train.backward",
                                          "train.optimizer")]
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    assert {r.step for r in _named(recs, "train.batch")} == {0}
    assert tr.state.step == 1


def test_trace_writes_every_threads_spans(tmp_path):
    def other():
        with PF.span("spans.traced", req=7):
            time.sleep(0.002)
        ids.append(threading.get_native_id())

    ids = []
    with PF.trace(str(tmp_path)):
        th = threading.Thread(target=other, name="conn-7")
        th.start()
        th.join()
        with PF.span("spans.profiled", step=3):
            torch.ones(4).add_(1)
    (path,) = tmp_path.glob("trace_*.json")
    doc = json.loads(path.read_text())
    evs = doc["traceEvents"]
    (ev,) = [e for e in evs if e.get("name") == "spans.traced"]
    assert ev["ph"] == "X" and ev["tid"] == ids[0]
    assert ev["args"]["req"] == 7 and ev["dur"] >= 2000
    assert any(e.get("ph") == "M" and e.get("tid") == ids[0]
               and "conn-7" in e["args"]["name"] for e in evs)
    # the profiled thread's span beside its own host event, on one base
    ring = [e for e in evs if e.get("name") == "spans.profiled"]
    assert len(ring) == 2
    assert abs(ring[0]["ts"] - ring[1]["ts"]) < 1000
    assert {e.get("cat") for e in ring} >= {"span"}


def test_a_full_ring_counts_what_it_overwrote(monkeypatch):
    capacity = 4
    ring = PF._Ring(capacity)
    monkeypatch.setattr(PF, "_RING", ring)
    t0 = time.time_ns()
    with _cpu_profile():
        for i in range(capacity + 3):
            PF.record_span("spans.fill", t0 + i, t0 + i + 1, step=i)
    assert [r.step for r in PF.spans()] == list(range(3, capacity + 3))
    assert PF.dropped(t0, t0 + 10) == 3
    assert PF.dropped(t0 + 2_000_000_000, None) == 0
