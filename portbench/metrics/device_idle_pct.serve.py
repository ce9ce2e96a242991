"""device_idle_pct.serve: the share of the traced stretch of a served
window in which no operation ran on the card: 1 - the union of the device
operations' intervals / the stretch."""

from portbench.metrics._common import idle_pct

UNIT = "%"


def read(data: dict):
    return idle_pct(data, "serve")
