"""idle_in_server_pct.serve: the share of the traced stretch in which no
operation ran on the card while at least one request was open in the
coupling server (a ``server.request`` span, ``utils.profiling``: from its
header's arrival to its reply's last byte sent).  ``device_idle_pct.serve``
less this is the idle time that the ranks and the wire cause."""

from portbench.metrics._common import digest
from portbench.metrics._spans import length, merged, spans_in

UNIT = "%"


def read(data: dict):
    d = digest(data)
    if data.get("kind") != "serve" or d is None or d.busy_s <= 0:
        return None
    got = spans_in(data, ("server.request",))
    if got is None or not got[2]["server.request"]:
        return None
    t0, t1, by = got
    end_us = (t1 - t0) / 1e3
    open_ = merged((max((r.start_ns - t0) / 1e3, 0.0),
                    min((r.end_ns - t0) / 1e3, end_us))
                   for r in by["server.request"])
    busy = merged((s, e) for _, s, e in d.device)
    idle = 0.0
    j = 0
    for s, e in open_:
        covered = 0.0
        while j < len(busy) and busy[j][1] < s:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < e:
            covered += min(e, busy[k][1]) - max(s, busy[k][0])
            k += 1
        idle += (e - s) - covered
    return 100.0 * idle / end_us
