"""Window arithmetic: a rate is all the work over all the time, a tail is
taken over every request, a failed request misses every limit."""

import math

import numpy as np
import pytest

from portbench import harness
from portbench.drivers import serve
from portbench.tests.conftest import cpu_context, tiny_cell


def test_nearest_rank_over_every_value():
    v = list(range(1, 101))
    assert harness.nearest_rank(v, 0.95) == 95
    assert harness.nearest_rank(v[::-1], 0.95) == 95
    assert harness.nearest_rank([5.0], 0.95) == 5.0
    # a failure is +inf: with 6 of 100 failed the p95 is +inf
    assert harness.nearest_rank(v[:94] + [math.inf] * 6, 0.95) == math.inf
    assert harness.nearest_rank(v[:95] + [math.inf] * 5, 0.95) == 95


def test_served_columns_count_replies_inside_the_window_only():
    rec = {"ok": np.array([True, True, True, False]),
           "due": np.array([0.0, 1.0, 9.5, 9.9]),
           "t_recv": np.array([0.5, 1.2, 10.4, np.inf])}
    columns, p95, attempted, failed = serve.window_metrics(rec, 384, 10.0)
    assert columns == 2 * 384                 # the third came after 10 s
    assert attempted == 4 and failed == 1
    assert p95 == math.inf                    # 1 of 4 failed


def test_the_tail_counts_late_replies_from_when_they_were_due():
    n = 40
    rec = {"ok": np.ones(n, bool), "due": np.linspace(0, 9.9, n),
           "t_recv": np.linspace(0, 9.9, n) + 0.1}
    rec["t_recv"][-2:] += 5.0                 # two late, past the window
    columns, p95, _, _ = serve.window_metrics(rec, 1, 10.0)
    assert columns == n - 2
    assert p95 == pytest.approx(100.0)        # 38th of 40: not the late
    rec["t_recv"][-3:] += 5.0
    assert serve.window_metrics(rec, 1, 10.0)[1] > 5000.0


def test_the_server_counts_leave_out_the_traced_stretch():
    class Stats:
        requests = rows = batches = padded_rows = 0
        latencies_ms = []

    st = Stats()

    def advance(calls, rows, ms):
        st.batches += calls
        st.rows += rows
        st.requests += calls
        st.latencies_ms = st.latencies_ms + [ms] * calls
        return serve._snapshot(st)

    before = serve._snapshot(st)
    start = advance(10, 1000, 50.0)           # 10 calls before the stretch
    advance(5, 500, 900.0)                     # traced: slow, left out
    resume = advance(1, 100, 900.0)            # the call that stopped it
    end = advance(4, 400, 60.0)
    marks = {"start": (start, 2.0), "resume": (resume, 7.0)}
    counts = serve._untraced(st, before, end, 0.0, 10.0, marks)
    assert counts["batches"] == 14 and counts["rows"] == 1400
    assert counts["latencies_ms"] == [50.0] * 10 + [60.0] * 4
    assert counts["seconds"] == pytest.approx(2.0 + 3.0)
    whole = serve._untraced(st, before, end, 0.0, 10.0, {})
    assert whole["batches"] == 20 and whole["seconds"] == 10.0
    # a first call after the stretch that came after the window: none
    late = {"start": marks["start"], "resume": (resume, 11.0)}
    counts = serve._untraced(st, before, end, 0.0, 10.0, late)
    assert counts["batches"] == 10 and counts["seconds"] == 2.0


def test_a_training_rate_is_every_sample_over_the_whole_window():
    cell = tiny_cell("mlp_v1.train_b32768")
    res = cell.driver.run(cpu_context(cell, seconds=1.0))
    data = res["data"]
    rate = res["end_to_end"]["train_samples_per_s"]["value"]
    assert data["samples"] == res["attempted"] * cell.mix["batch"]
    assert rate == pytest.approx(data["samples"] / data["window_s"])
    assert data["window_s"] >= 1.0


def test_the_ranks_step_together(tmp_path, monkeypatch):
    """Every rank sends one request a step, and a step starts only once
    the last reply of the step before is in."""
    import io
    import sys
    import time

    from climsim_tpu_torch.online.server import CouplingServer
    from portbench.traffic import loadgen
    from portbench.traffic.varspec import Layout

    def slow(x):
        time.sleep(0.02)
        return x[:, :3] * 2

    feats = Layout("v4").input_len
    server = CouplingServer(slow, feats, base_chunk=8, max_batch=32,
                            warmup=False, device="cpu").start()
    out = tmp_path / "rec.npz"
    monkeypatch.setattr(sys, "stdin", io.StringIO("go 0.5\n"))
    try:
        assert loadgen.main([
            "--port", str(server.port), "--clients", "3", "--chunk", "8",
            "--chunks-per-client", "2", "--layout", "v4", "--seed", "5",
            "--keep", "1", "--out", str(out)]) == 0
    finally:
        server.stop()
    rec = np.load(out)
    assert rec["ok"].all()
    starts = np.unique(rec["due"])
    assert starts.size >= 3 and starts[-1] < 0.5
    for d in starts:
        assert sorted(rec["client"][rec["due"] == d]) == [0, 1, 2]
    for a, b in zip(starts[:-1], starts[1:]):
        assert rec["t_recv"][rec["due"] == a].max() <= b
    x = loadgen.client_chunks("v4", 3, 2, 8, 5)
    for c, k, y in zip(rec["kept_client"], rec["kept_chunk"],
                       rec["kept_reply"]):
        np.testing.assert_allclose(y, x[c, k][:, :3] * 2)


def test_the_round_trip_tail_leaves_out_the_traced_stretch():
    rec = {"ok": np.ones(6, bool),
           "due": np.array([0.0, 1.0, 2.0, 3.0, 4.0, 5.0]),
           "t_recv": np.array([0.1, 1.1, 2.9, 3.9, 4.1, 5.1])}
    trips = serve.round_trips_ms(rec)
    assert trips.tolist() == pytest.approx([100, 100, 900, 900, 100, 100])
    marks = {"start": (None, 11.5), "resume": (None, 13.5)}
    lo, hi = serve._stretch(marks, 10.0)
    assert (lo, hi) == (1.5, 3.5)
    outside = (rec["due"] < lo) | (rec["due"] > hi)
    assert trips[outside].max() == pytest.approx(100)
    assert serve._stretch({}, 10.0) == (math.inf, math.inf)
