"""The work formulas against hand counts."""

import json

import pytest

from portbench import harness
from portbench.reference import mlp_v1, unet_v5
from portbench.work import flops, peaks, unet


def config(name):
    return harness.load_json("configs", name)


def test_chain_bound_at_one_shape_by_hand():
    b, l, c, cout = 2, 4, 8, 16
    nbytes = 4 * 2 * 4 * (8 + 16) + 4 * (2 * 8 + 16) + 2 * 3 * 8 * 16
    assert nbytes == 1664
    ops = 2 * 2 * 4 * 3 * 8 * 16
    ms, kind = unet.chain_bound_ms(b, l, c, cout)
    assert kind == "bytes"
    assert ms == pytest.approx(1664 / 3.35e12 * 1e3, rel=1e-12)
    assert ops / peaks.BF16_FLOPS < nbytes / peaks.HBM_BYTES_S


def test_chain_backward_bound_at_one_shape_by_hand():
    b, l, c, cout = 1024, 64, 128, 128
    nbytes = 4 * b * l * (2 * c + cout) + 4 * (4 * c + cout) \
        + 6 * 3 * c * cout
    ops = 4 * b * l * 3 * c * cout
    ms, kind = unet.chain_bwd_bound_ms(b, l, c, cout)
    want = max(nbytes / 3.35e12, ops / 989e12) * 1e3
    assert ms == pytest.approx(want, rel=1e-12)
    assert kind == ("bytes" if nbytes / 3.35e12 >= ops / 989e12
                    else "operations")


def test_census_is_the_ports_82_chains():
    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.varspec import get_varspec

    cfg = config("unet_v5")
    census = unet.chain_census(cfg)
    assert sum(census.values()) == 82 and len(census) == 13
    import torch

    with torch.device("meta"):
        port = ClimSimUNet(get_varspec("v5"), **cfg["model"])
    assert census == port.fused_chains(16)
    assert unet.backward_bound_ms(census, 1024) == pytest.approx(1.97193,
                                                                 rel=1e-5)


def test_mlp_forward_flops_by_hand():
    widths = [124, 768, 640, 512, 640, 640, 128]
    macs = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    macs += 128 * 120 + 128 * 8          # the head
    assert flops.forward_flops_per_sample(config("mlp_v1"),
                                          mlp_v1) == 2 * macs


def test_unet_forward_flops_match_the_ports_count():
    from climsim_tpu_torch.bench_unet_train import forward_flops_per_sample

    got = flops.forward_flops_per_sample(config("unet_v5"), unet_v5)
    assert got == forward_flops_per_sample()["total"] == 896073728


def test_reference_parameter_counts_are_the_configs():
    import torch

    for name, mod in (("unet_v5", unet_v5), ("mlp_v1", mlp_v1)):
        cfg = config(name)
        with torch.device("meta"):
            m = mod.Model(cfg)
        assert sum(p.numel() for p in m.parameters()) == cfg["params"]
