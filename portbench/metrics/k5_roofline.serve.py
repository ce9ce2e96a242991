"""k5_roofline.serve: kernel 5 (the fused GroupNorm -> silu -> conv3) in
the served forward, against its roofline: the least time of the chains of
the device calls in the traced stretch at their rows, padding included
(``work.unet``), over the device time of every ``gn_silu_conv3_kernel``
launch in the stretch (each of its calls starts and ends in it)."""

from portbench.metrics._common import digest

UNIT = "%"
KERNEL = "gn_silu_conv3_kernel"


def read(data: dict):
    from portbench.work.unet import chain_census, forward_bound_ms

    d = digest(data)
    if data.get("kind") != "serve" or d is None or not data["traced_rows"]:
        return None
    spent_s = d.kernel_s(KERNEL)
    if spent_s <= 0:
        return None
    census = chain_census(data["config"])
    bound_ms = sum(forward_bound_ms(census, b) for b in data["traced_rows"])
    return 100.0 * bound_ms / 1e3 / spent_s
