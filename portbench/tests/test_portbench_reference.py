"""The plain references agree with the port at tiny sizes on the CPU,
with the port computing in float32 (the exact path), through the
harness's own drivers: the U-Net's and the MLP's first three training
steps, and the served U-Net behind the coupling wrapper."""

import json

import pytest
import torch

from portbench import harness
from portbench.reference import common, mlp_v1, unet_v5
from portbench.tests.conftest import cpu_context, tiny_cell

# the port in float32 against the float32 reference: the gaps are the
# float32 sums' orders (the port's GroupNorm takes E[x^2] - E[x]^2, the
# reference two passes; kernel 1 multiplies by 1 / div, the reference
# divides), 1e-6 to 1e-5 on the CPU; the bf16 program reads 1e-3 to 1e-2
F32_TOL = 2e-4


def float32_cell(name):
    cell = tiny_cell(name)
    cell.config["precision"]["compute"] = "float32"
    return cell


@pytest.mark.parametrize("name", ["unet_v5.train_b1024",
                                  "mlp_v1.train_b32768"])
def test_training_steps_agree_in_float32(name):
    from portbench import calibrate

    cell = float32_cell(name)
    got = calibrate.train_seed(cpu_context(cell, seed=2**31 + 101),
                               False)["program"]
    for k in ("loss_gap", "grad_gap", "grad_diff", "change_gap"):
        assert got[k] < F32_TOL, (k, got)
    assert got["rows_unmoved"] == 0
    res = cell.driver.run(cpu_context(cell, seed=2**31 + 101))
    assert res["correct"] is True
    assert res["checks"]["batch_rows_foreign"]["value"] == 0


def test_the_served_path_agrees_in_float32():
    cell = float32_cell("unet_v5.serve_c8")
    res = cell.driver.run(cpu_context(cell, seed=2**31 + 102))
    assert res["checks"]["reply_gap"]["value"] < F32_TOL
    assert res["failed"] == 0


def test_forward_passes_agree_with_the_port():
    from climsim_tpu_torch.models.mlp import ClimSimMLP
    from climsim_tpu_torch.models.unet import ClimSimUNet
    from climsim_tpu_torch.varspec import get_varspec

    cfg = harness.load_json("configs", "unet_v5")
    cfg["model"].update(model_channels=16, num_blocks=1)
    w = unet_v5.make_weights(cfg, 3, "cpu")
    port = ClimSimUNet(get_varspec("v5"), compute_dtype=torch.float32,
                       **cfg["model"])
    port.load_state_dict(w)
    x = torch.randn(8, 1405, generator=torch.Generator().manual_seed(0))
    x[:, -1] = torch.arange(8) * 40 + 1.0
    ref = unet_v5.build(cfg, w)
    with torch.no_grad():
        a, b = port(x), ref(x)
    assert float((a - b).abs().max() / b.abs().max()) < 1e-5

    cfg = harness.load_json("configs", "mlp_v1")
    w = mlp_v1.make_weights(cfg, 4, "cpu")
    port = ClimSimMLP(get_varspec("v1"), hidden=cfg["model"]["hidden"],
                      compute_dtype=torch.float32)
    port.load_state_dict(w)
    x = torch.randn(16, 124, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        a, b = port(x), mlp_v1.build(cfg, w)(x)
    assert float((a - b).abs().max() / b.abs().max()) < 1e-5


def test_the_schedules_are_the_ports():
    from climsim_tpu_torch.train import schedules

    cos = schedules.build("cosine", 1000, init_lr=1e-3, decay_epochs=30)
    cyc = schedules.build("cyclic", 1000)
    for cfg, port in (("unet_v5", cos), ("mlp_v1", cyc)):
        sched = harness.load_json("configs", cfg)["train"]["schedule"]
        for step in (0, 1, 2, 3, 1999, 2000, 2500):
            assert common.learning_rate(sched, step) == pytest.approx(
                float(port(step)), rel=1e-6)


def test_the_weights_are_drawn_from_the_seed():
    cfg = harness.load_json("configs", "mlp_v1")
    a = mlp_v1.make_weights(cfg, 2**31 + 5, "cpu")
    b = mlp_v1.make_weights(cfg, 2**31 + 5, "cpu")
    c = mlp_v1.make_weights(cfg, 2**31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["prehead.weight"], c["prehead.weight"])
    assert json.dumps(sorted(a)) == json.dumps(sorted(c))
