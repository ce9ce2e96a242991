"""The profiler's trace of a steady stretch of the window, digested.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over a
stretch that starts and ends with the card synchronized, so that every
device operation in it was launched in it.  It is started and stopped in
the thread that launches the work (the profiler records the host events
of that thread, and of the autograd engine's for a backward it starts).
``Digest``
keeps what the readers take from it: each device operation's name and
interval, each host event's name, interval and the kernels launched under
it, and the stretch's length by the host's clock.
"""

from __future__ import annotations

import time

_LABELLED_GAPS = 500     # the longest gaps, each labelled by its host event


class Digest:
    def __init__(self, prof, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.device = []          # (name, start_us, end_us)
        self.ranges = []          # host ranges on the device's timeline
        self.host = []            # FunctionEvent on the host
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                (self.ranges if ev.is_user_annotation else self.device
                 ).append((ev.name, ev.time_range.start, ev.time_range.end))
            else:
                self.host.append(ev)
        self.busy_s = _union_us(self.device) / 1e6

    def kernel_s(self, pattern: str) -> float:
        """Seconds of the device operations whose name holds ``pattern``."""
        return sum(e - s for n, s, e in self.device if pattern in n) / 1e6

    def within(self, name: str) -> float:
        """Seconds of the device operations that ran inside the device-side
        spans of the host range ``name``."""
        spans = _merged_us([r for r in self.ranges if r[0] == name])
        total, i = 0.0, 0
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            while i < len(spans) and spans[i][1] < s:
                i += 1
            if i < len(spans) and spans[i][0] <= s and e <= spans[i][1]:
                total += e - s
        return total / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the device's
        longest idle gaps summed by the innermost host event running at
        each gap's middle, in seconds."""
        by_op: dict = {}
        for n, s, e in self.device:
            by_op[n] = by_op.get(n, 0.0) + (e - s) / 1e6
        gaps: dict = {}
        if self.host:
            import numpy as np

            starts = np.array([ev.time_range.start for ev in self.host], float)
            ends = np.array([ev.time_range.end for ev in self.host], float)
            names = [ev.name for ev in self.host]
            longest = sorted(_gaps_us(self.device),
                             key=lambda g: g[0] - g[1])[:_LABELLED_GAPS]
            for lo, hi in longest:
                mid = 0.5 * (lo + hi)
                cover = np.flatnonzero((starts <= mid) & (ends >= mid))
                label = (names[cover[np.argmin(ends[cover] - starts[cover])]]
                         if cover.size else "no host event")
                gaps[label] = gaps.get(label, 0.0) + (hi - lo) / 1e6
        rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                                key=lambda kv: -kv[1])[:top]
        return {"device_ops": rank(by_op), "idle_gaps": rank(gaps)}


def _merged_us(intervals) -> list:
    out: list = []
    for _, s, e in sorted(intervals, key=lambda t: t[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _union_us(intervals) -> float:
    return sum(e - s for s, e in _merged_us(intervals))


def _gaps_us(intervals) -> list:
    m = _merged_us(intervals)
    return [(a[1], b[0]) for a, b in zip(m[:-1], m[1:]) if b[0] > a[1]]


class Tracer:
    """A profiler over [start_s, start_s + seconds) of the window, started
    and stopped by ``poll`` between two units of work."""

    def __init__(self, start_s: float, seconds: float):
        self.start_s, self.seconds = start_s, seconds
        self.prof = None
        self.t_start = self.t_stop = None
        self.window_s = None
        self._digest = None

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])

    @property
    def on(self) -> bool:
        return self.prof is not None and self.window_s is None

    @property
    def digest(self) -> Digest | None:
        """The stretch's digest, made at the first look after it ended."""
        if self._digest is None and self.window_s is not None:
            self._digest = Digest(self.prof, self.window_s)
        return self._digest

    def warm(self) -> None:
        """Start and stop the profiler once in this thread, so that its
        one-time set-up happens here and not in a measured stretch (and
        in the thread that first registered it)."""
        import torch

        with self._profiler():
            torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()

    def poll(self, elapsed: float) -> str | None:
        """Start at ``start_s`` of the window, stop ``seconds`` later;
        returns "start", "stop" or None."""
        import torch

        if self.prof is None and elapsed >= self.start_s:
            torch.cuda.synchronize()
            self.prof = self._profiler()
            self.prof.start()
            self.t_start = time.perf_counter()
            return "start"
        if self.on and time.perf_counter() - self.t_start >= self.seconds:
            self.stop()
            return "stop"
        return None

    def stop(self) -> None:
        import torch

        if not self.on:
            return
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t_start
        self.prof.stop()
        self.t_stop = time.perf_counter()
