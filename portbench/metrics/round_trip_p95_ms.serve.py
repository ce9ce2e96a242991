"""round_trip_p95_ms.serve: the nearest-rank 95th percentile of the round
trips of the window's requests whose step started outside the traced
stretch, timed at the client from the step's start to the reply; a
failed request counts as +inf."""

from portbench.harness import nearest_rank

UNIT = "ms"


def read(data: dict):
    if data.get("kind") != "serve" or not data["round_trips_ms"]:
        return None
    return nearest_rank(data["round_trips_ms"], 0.95)
