"""Operations of one forward a sample, counted from the shapes of the
plain reference on the meta device (convolutions and products, two a
multiply-add): the counterpart of ``bench_unet_train.forward_flops_per_sample``
in ``climsim_tpu_torch`` at commit ad9d7d2, taken of the reference, so
that no change to the program moves it."""

from __future__ import annotations


def forward_flops_per_sample(cfg: dict, reference) -> float:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..traffic.varspec import Layout

    lay = Layout(cfg["varspec"])
    with torch.device("meta"):
        model = reference.Model(cfg)
        x = torch.zeros(2, lay.input_len)
        if "icol" in lay.input_slices:
            x[:, lay.input_slices["icol"]] = 1.0
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        model(x)
    return counter.get_total_flops() / 2
