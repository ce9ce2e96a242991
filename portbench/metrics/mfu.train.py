"""mfu.train: the training window's share of the card's bf16 peak: every
sample of the window outside the traced stretch x 3 x the forward's
operations a sample (the reference's, two a multiply-add) / those seconds
/ 989 TFLOP/s."""

from portbench.metrics._common import mfu_pct

UNIT = "%"


def read(data: dict):
    if data.get("kind") != "train":
        return None
    return mfu_pct(data, data["samples"], 3, data["window_s"])
