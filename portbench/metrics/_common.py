"""What several readers share."""

from __future__ import annotations


def digest(data: dict):
    """The digest of the run's traced stretch, or None."""
    tracer = data.get("trace")
    return None if tracer is None else tracer.digest


def idle_pct(data: dict, kind: str):
    d = digest(data)
    if data.get("kind") != kind or d is None or d.busy_s <= 0:
        return None
    return 100.0 * (1.0 - d.busy_s / d.window_s)


def mfu_pct(data: dict, samples: float, passes: int, seconds: float):
    from ..work.flops import forward_flops_per_sample
    from ..work.peaks import MFU_PEAK

    flops = forward_flops_per_sample(data["config"], data["reference"])
    if samples <= 0 or flops <= 0:
        return None
    return 100.0 * samples * passes * flops / seconds / MFU_PEAK
