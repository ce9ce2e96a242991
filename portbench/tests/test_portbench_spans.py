"""The span readers (queue_wait_p95_ms.serve, idle_in_server_pct.serve,
forward_ms.train, backward_ms.train, optimizer_ms.train) on a digest and
a ring of spans built by hand: a gap inside and a gap outside a request,
waits inside and outside the stretch, a ring that overwrote a span (the
readers give None), a stretch with no steps, and a program that keeps no
spans (the parent of the span readers: None, no error)."""

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from climsim_tpu_torch.utils import profiling
from portbench import harness

T0 = 1_000_000_000_000          # the trace's start, ns
WINDOW_S = 0.1                  # the stretch: 100 ms


def _reader(name):
    return harness.load_module("metrics", name)


def _ns(us):
    return T0 + int(us * 1e3)


class _Prof:
    """What the readers take of a profiler: its trace's start and its
    events (device operations, their runtime launches)."""

    def __init__(self, events):
        self._events = events
        self.profiler = SimpleNamespace(kineto_results=SimpleNamespace(
            trace_start_ns=lambda: T0))

    def events(self):
        return self._events


def _event(eid, name, start_us, end_us, device):
    return SimpleNamespace(
        id=eid, name=name, is_user_annotation=False,
        time_range=SimpleNamespace(start=start_us, end=end_us),
        device_type=DeviceType.CUDA if device else DeviceType.CPU)


def _data(kind, device_us, events=()):
    """A run's data with a traced stretch: the digest's device intervals
    (µs from the stretch's start) and the profiler's events."""
    digest = SimpleNamespace(device=[("op", s, e) for s, e in device_us],
                             busy_s=sum(e - s for s, e in device_us) / 1e6,
                             window_s=WINDOW_S)
    tracer = SimpleNamespace(prof=_Prof(list(events)), window_s=WINDOW_S,
                             digest=digest)
    return {"kind": kind, "trace": tracer}


@pytest.fixture
def ring(monkeypatch):
    """A fresh ring of spans, with tracing on while records are added."""
    r = profiling._Ring(64)
    monkeypatch.setattr(profiling, "_RING", r)

    def add(name, start_us, end_us, **ids):
        rec = profiling.SpanRecord(
            name, 1, _ns(start_us), _ns(end_us), 0, ids.get("req"),
            ids.get("call"), ids.get("step"), len(r.records) + 1, None)
        r.records.append(rec)

    return SimpleNamespace(ring=r, add=add)


def test_queue_wait_p95_reads_the_waits_that_lie_in_the_stretch(ring):
    for i, ms in enumerate([1.0, 2.0, 3.0, 4.0]):
        ring.add("server.queued", 10_000 + i, 10_000 + i + 1e3 * ms,
                 req=i, call=0)
    data = _data("serve", [(0, 50_000)])
    assert _reader("queue_wait_p95_ms.serve").read(data) == \
        pytest.approx(4.0)
    # a wait that starts before the stretch, one that ends after it (the
    # profiler's stop holds the dispatcher), and one inside, of 61 ms
    ring.add("server.queued", -5_000, 1_000, req=9, call=0)
    ring.add("server.queued", 99_000, 160_000, req=8, call=1)
    assert _reader("queue_wait_p95_ms.serve").read(data) == \
        pytest.approx(4.0)
    ring.add("server.queued", 20_000, 81_000, req=7, call=1)
    assert _reader("queue_wait_p95_ms.serve").read(data) == \
        pytest.approx(61.0)
    assert _reader("queue_wait_p95_ms.serve").read(
        {**data, "kind": "train"}) is None


def test_idle_in_server_counts_only_the_gaps_inside_a_request(ring):
    # the card runs [0, 20] and [30, 60] and [90, 100] ms; one request is
    # open over [15, 40] ms: of the gaps [20, 30] and [60, 90] only the
    # first lies inside it
    ring.add("server.request", 15_000, 40_000, req=0)
    data = _data("serve", [(0, 20_000), (30_000, 60_000),
                           (90_000, 100_000)])
    got = _reader("idle_in_server_pct.serve").read(data)
    assert got == pytest.approx(10.0)
    # a second request over the other gap, and past the stretch's end
    ring.add("server.request", 55_000, 130_000, req=1)
    assert _reader("idle_in_server_pct.serve").read(data) == \
        pytest.approx(40.0)


def test_a_ring_that_overwrote_a_span_in_the_stretch_reads_none(ring):
    ring.add("server.queued", 1_000, 2_000, req=0, call=0)
    ring.add("server.request", 0, 3_000, req=0)
    data = _data("serve", [(0, 500)])
    assert _reader("queue_wait_p95_ms.serve").read(data) is not None
    ring.ring.lost[_ns(50_000) // 1_000_000_000] = 1
    for name in ("queue_wait_p95_ms.serve", "idle_in_server_pct.serve"):
        assert _reader(name).read(data) is None


def _step(ring, events, k, t, eid):
    """A step at ``t`` µs: a 10 µs forward span launching two kernels and
    one whose launch the profiler did not see, a backward launching
    one, an optimizer launching one; the device runs 100 µs after."""
    ring.add("train.forward", t, t + 10, step=k)
    ring.add("train.backward", t + 10, t + 20, step=k)
    ring.add("train.optimizer", t + 20, t + 30, step=k)
    dev = t + 100
    for i, (launch, s, e) in enumerate([
            (t + 1, dev, dev + 5), (None, dev + 5, dev + 8),
            (t + 2, dev + 8, dev + 10),           # forward: 10 µs
            (t + 15, dev + 12, dev + 32),         # backward: 20 µs
            (t + 25, dev + 33, dev + 36)]):       # optimizer: 3 µs
        events.append(_event(eid + i, "kernel", s, e, True))
        if launch is not None:
            events.append(_event(eid + i, "cudaLaunchKernel", launch,
                                 launch + 1, False))
    # the next batch's gather, launched outside the step's spans
    events.append(_event(eid + 9, "gather", dev + 40, dev + 45, True))
    events.append(_event(eid + 9, "cudaLaunchKernel", t + 40, t + 41,
                         False))


def test_the_train_parts_read_each_steps_device_time(ring):
    events: list = []
    for k in range(3):
        _step(ring, events, k, 1_000 + 200 * k, 100 * k)
    # a step whose optimizer ends after the stretch is not counted
    ring.add("train.forward", 99_990, 99_995, step=3)
    ring.add("train.backward", 99_995, 99_999, step=3)
    ring.add("train.optimizer", 99_999, 100_100, step=3)
    devs = [(e.time_range.start, e.time_range.end) for e in events
            if e.device_type == DeviceType.CUDA]
    data = _data("train", devs, events)
    want = {"forward": 0.010, "backward": 0.020, "optimizer": 0.003}
    for part, ms in want.items():
        assert _reader(f"{part}_ms.train").read(data) == pytest.approx(ms)
    assert _reader("forward_ms.train").read({**data, "kind": "serve"}) \
        is None


def test_a_stretch_with_no_steps_reads_none(ring):
    ring.add("train.forward", 1_000, 2_000, step=0)    # no optimizer
    ring.add("train.batch", 0, 10, step=0)
    data = _data("train", [(0, 10)], [_event(1, "k", 0, 10, True)])
    for part in ("forward", "backward", "optimizer"):
        assert _reader(f"{part}_ms.train").read(data) is None


def test_a_program_without_spans_reads_none(ring, monkeypatch):
    ring.add("server.queued", 1_000, 2_000, req=0, call=0)
    ring.add("server.request", 0, 3_000, req=0)
    monkeypatch.delattr(profiling, "spans")
    data = _data("serve", [(0, 500)])
    for name in ("queue_wait_p95_ms.serve", "idle_in_server_pct.serve",
                 "forward_ms.train"):
        assert _reader(name).read(data) is None
    untraced = {"kind": "serve", "trace": None}
    assert _reader("queue_wait_p95_ms.serve").read(untraced) is None
