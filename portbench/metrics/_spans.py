"""What the span readers share: the traced stretch on the profiler's
clock, the program's spans in it (``climsim_tpu_torch.utils.profiling``:
the server's and the train step's), and the device time of each part of
the steps.  A program that keeps no spans, or a stretch in which its ring
overwrote one, gives None: the metric is left out."""

from __future__ import annotations

import bisect

from portbench.metrics._common import digest

TRAIN_PARTS = ("train.forward", "train.backward", "train.optimizer")
# host events of CUDA's API calls (`cudaLaunchKernel`, `cuLaunchKernel`,
# `cudaMemcpyAsync`, ...): a device operation's launch, by the correlation
# id it shares with it
_API_PREFIX = "cu"


def stretch_ns(data: dict):
    """(start, end) of the traced stretch in ns on the profiler's clock:
    the profiler's ``trace_start_ns()`` and the stretch's length; None
    where the run traced nothing."""
    tracer = data.get("trace")
    if tracer is None or tracer.prof is None or tracer.window_s is None:
        return None
    try:
        t0 = int(tracer.prof.profiler.kineto_results.trace_start_ns())
    except AttributeError:
        return None
    return t0, t0 + int(tracer.window_s * 1e9)


def spans_in(data: dict, names) -> tuple | None:
    """(t0, t1, {name: records}) of the spans ``names`` that overlap the
    traced stretch [t0, t1] (ns); None where there is no stretch, the
    program keeps no spans, or the ring overwrote a span in the stretch."""
    st = stretch_ns(data)
    if st is None:
        return None
    try:
        from climsim_tpu_torch.utils import profiling
        get, dropped = profiling.spans, profiling.dropped
    except (ImportError, AttributeError):
        return None
    t0, t1 = st
    if dropped(t0, t1):
        return None
    out: dict = {n: [] for n in names}
    for r in get(t0, t1):
        if r.name in out:
            out[r.name].append(r)
    return t0, t1, out


def merged(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint [start,
    end] pairs."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def length(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def device_ops(data: dict) -> list:
    """(start_us, end_us, launch_us) of every device operation of the
    stretch (µs from the stretch's start); ``launch_us`` the start of the
    CUDA call that launched it, None where the profiler saw none."""
    from torch.autograd import DeviceType

    events = data["trace"].prof.events()
    launch = {ev.id: ev.time_range.start for ev in events
              if ev.device_type == DeviceType.CPU
              and ev.name.startswith(_API_PREFIX)}
    return [(ev.time_range.start, ev.time_range.end, launch.get(ev.id))
            for ev in events if ev.device_type == DeviceType.CUDA
            and not ev.is_user_annotation]


def train_parts_ms(data: dict) -> dict | None:
    """{part: device ms a step} of ``TRAIN_PARTS`` over the steps whose
    three spans lie in the stretch.  A part's region of the device's
    timeline, in a step, runs from the first start to the last end of the
    device operations launched while its span was open (the backward's by
    the autograd engine's thread, while the step's thread waits in
    ``train.backward``); its time is the union of the operations that
    start in that region, those whose launch the profiler did not see
    included."""
    if data.get("kind") != "train" or digest(data) is None:
        return None
    got = spans_in(data, TRAIN_PARTS)
    if got is None:
        return None
    t0, t1, by = got
    steps: dict = {}
    for name in TRAIN_PARTS:
        for r in by[name]:
            if t0 <= r.start_ns and r.end_ns <= t1:
                steps.setdefault(r.step, {})[name] = ((r.start_ns - t0) / 1e3,
                                                      (r.end_ns - t0) / 1e3)
    steps = {k: v for k, v in steps.items() if len(v) == len(TRAIN_PARTS)}
    if not steps:
        return None
    ops = device_ops(data)
    hosts = sorted((s, e, k, name) for k, parts in steps.items()
                   for name, (s, e) in parts.items())
    starts = [h[0] for h in hosts]
    regions: dict = {}
    for s, e, launch in ops:
        if launch is None:
            continue
        i = bisect.bisect_right(starts, launch) - 1
        if i >= 0 and launch <= hosts[i][1]:
            key = hosts[i][2:]
            lo, hi = regions.get(key, (s, e))
            regions[key] = (min(lo, s), max(hi, e))
    order = sorted((lo, hi, key) for key, (lo, hi) in regions.items())
    lows = [o[0] for o in order]
    spent: dict = {}
    for s, e, _ in ops:
        i = bisect.bisect_right(lows, s) - 1
        if i >= 0 and s <= order[i][1]:
            spent.setdefault(order[i][2], []).append((s, min(e, order[i][1])))
    out = {}
    for name in TRAIN_PARTS:
        total = sum(length(v) for (k, n), v in spent.items() if n == name)
        out[name] = total / 1e3 / len(steps)
    return out
