"""queue_wait_p95_ms.serve: the nearest-rank 95th percentile of the
requests' waits in the coupling server's queue, from their queueing by a
connection thread to their taking into a device call by the dispatcher
(the program's ``server.queued`` spans, ``utils.profiling``), over the
spans that start and end in the traced stretch, in ms.  (One that ends
after it waited out the profiler's stop, which holds the dispatcher for
seconds.)"""

from portbench.harness import nearest_rank
from portbench.metrics._spans import spans_in

UNIT = "ms"


def read(data: dict):
    if data.get("kind") != "serve":
        return None
    got = spans_in(data, ("server.queued",))
    if got is None:
        return None
    t0, t1, by = got
    waits = [(r.end_ns - r.start_ns) / 1e6 for r in by["server.queued"]
             if t0 <= r.start_ns and r.end_ns <= t1]
    return nearest_rank(waits, 0.95) if waits else None
