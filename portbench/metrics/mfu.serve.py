"""mfu.serve: the served window's share of the card's bf16 peak: the
columns the server answered in the window outside the traced stretch x
the forward's operations a column (the reference's, two a multiply-add)
/ those seconds of the window / 989 TFLOP/s."""

from portbench.metrics._common import mfu_pct

UNIT = "%"


def read(data: dict):
    if data.get("kind") != "serve" or data["server"]["seconds"] <= 0:
        return None
    return mfu_pct(data, data["server"]["rows"], 1,
                   data["server"]["seconds"])
