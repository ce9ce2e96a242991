"""rows_per_call.serve: the server's coalescing, the change of
``ServerStats.rows`` over the change of ``ServerStats.batches`` across the
window outside the traced stretch (padding not counted)."""

UNIT = "rows/call"


def read(data: dict):
    if data.get("kind") != "serve" or data["server"]["batches"] <= 0:
        return None
    return data["server"]["rows"] / data["server"]["batches"]
