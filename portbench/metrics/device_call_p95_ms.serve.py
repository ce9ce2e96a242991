"""device_call_p95_ms.serve: the nearest-rank 95th percentile of the
window's device calls outside the traced stretch, as the server times them
(``ServerStats.latencies_ms``: host to card, the wrapper, the reply copied
back)."""

from portbench.harness import nearest_rank

UNIT = "ms"


def read(data: dict):
    if data.get("kind") != "serve" or not data["server"]["latencies_ms"]:
        return None
    return nearest_rank(data["server"]["latencies_ms"], 0.95)
