"""k5bwd_roofline.train: the backward of 5' (the fused chains' custom
VJP) in the training step, against its roofline: the least time of the
chains' backward a step at the batch (``work.unet``) x the steps of the
traced stretch, over the device time of the operations that ran inside
the device-side spans of the program's range ``fused_gn_silu_conv3
backward`` (its kernels are launched through the driver API, which the
profiler does not tie to a host event, so the spans and not the host
events' kernels are read)."""

from portbench.metrics._common import digest

UNIT = "%"
RANGE = "fused_gn_silu_conv3 backward"


def read(data: dict):
    from portbench.work.unet import backward_bound_ms, chain_census

    d = digest(data)
    if data.get("kind") != "train" or d is None or not data["steps_traced"]:
        return None
    spent_s = d.within(RANGE)
    if spent_s <= 0:
        return None
    bound_ms = backward_bound_ms(chain_census(data["config"]),
                                 data["batch"]) * data["steps_traced"]
    return 100.0 * bound_ms / 1e3 / spent_s
