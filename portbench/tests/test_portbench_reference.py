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


@pytest.mark.parametrize("name", ["unet_v5.train_b8192",
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


def tiny_steps(name: str, batch: int, seed: int = 2**31 + 104):
    """(config, reference module, weights, norms, three raw batches of
    ``batch`` rows) of configuration ``name`` at a tiny width."""
    from portbench.traffic.synthetic import synthetic_split
    from portbench.traffic.varspec import Layout

    cfg = harness.load_json("configs", name)
    ref = {"unet_v5": unet_v5, "mlp_v1": mlp_v1}[name]
    if name == "unet_v5":
        cfg["model"].update(model_channels=16, num_blocks=1)
    else:
        cfg["model"].update(hidden=[32, 16])
    lay = Layout(cfg["varspec"])
    x, y = synthetic_split(lay, 3 * batch, seed=seed)
    if "icol" in lay.input_slices:
        x[:, lay.input_slices["icol"]] = (
            torch.arange(3 * batch) % 384 + 1)[:, None].numpy()
    batches = [(torch.as_tensor(x[i:i + batch]),
                torch.as_tensor(y[i:i + batch]))
               for i in range(0, 3 * batch, batch)]
    norms = common.load_norms(str(harness.ROOT / cfg["norms"]))
    return cfg, ref, ref.make_weights(cfg, seed, "cpu"), norms, batches


def follow(cfg, ref, weights, norms, batches, rows=None):
    """The reference's three steps through ``common.follow_steps``, the
    whole batch at once or in blocks of ``rows`` rows."""
    from portbench.traffic.varspec import Layout

    model = ref.build(cfg, weights)
    lay, tr = Layout(cfg["varspec"]), cfg["train"]
    in_t = common.input_transform(lay, norms, tr["transform"], "cpu")
    tgt_t = common.target_transform(lay, norms, tr["transform"], "cpu")
    with common.no_tf32():
        return common.follow_steps(model, dict(model.named_parameters()),
                                   batches, tr, in_t, tgt_t, rows)


def bit_equal(a: dict, b: dict) -> bool:
    return (a["loss"] == b["loss"]
            and all(torch.equal(a[k][n], b[k][n]) for k in ("grad", "change")
                    for n in b[k]))


@pytest.mark.parametrize("name", ["unet_v5", "mlp_v1"])
def test_a_block_as_large_as_the_batch_is_the_whole_batch(name):
    """A block of the batch's rows takes the whole-batch path bit for bit:
    one forward and one backward a step, the loss weighted by 1."""
    cfg, ref, w, norms, batches = tiny_steps(name, 40)
    assert bit_equal(follow(cfg, ref, w, norms, batches, rows=40),
                     follow(cfg, ref, w, norms, batches))


# a blocked step sums the same float32 terms in another order: the losses
# agree to float32's rounding of a mean (read: ~1e-7), the first gradient
# to the rounding of its sums over rows (read: 5.5e-7); Adam's first steps
# divide by sqrt(v), which carries that rounding into the change of the
# elements whose gradient is near nought (read: 5.0e-6). Weighting the
# blocks alike, the fault these catch, reads 1e-2 and 1.3.
GRAD_TOL, CHANGE_TOL = 1e-5, 1e-4


def test_blocked_steps_equal_the_whole_batch():
    """The U-Net's three steps at B = 50 in blocks of 16 rows (the last
    block 2 rows) against the whole batch."""
    cfg, ref, w, norms, batches = tiny_steps("unet_v5", 50)
    whole = follow(cfg, ref, w, norms, batches)
    blocked = follow(cfg, ref, w, norms, batches, rows=16)
    assert not bit_equal(blocked, whole)
    for a, b in zip(blocked["loss"], whole["loss"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    assert harness.diff_by_leaf(blocked["grad"], whole["grad"]) < GRAD_TOL
    assert harness.diff_by_leaf(blocked["change"], whole["change"]
                                ) < CHANGE_TOL


@pytest.mark.parametrize("k", [3, 5])
def test_the_reference_conv_is_conv1d_with_its_gradients(k):
    """``unet_v5.ConvK``: the forward is ``F.conv1d``'s bit for bit, and
    both gradients are autograd's of it to float64's rounding (the weight's
    sums in another order)."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(k)
    x = torch.randn(5, 7, 11, generator=g, dtype=torch.float64)
    w = torch.randn(4, 7, k, generator=g, dtype=torch.float64)
    ct = torch.randn(5, 4, 11, generator=g, dtype=torch.float64)
    grads = []
    for fn in (unet_v5.ConvK.apply,
               lambda a, b: F.conv1d(a, b, padding=k // 2)):
        a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
        y = fn(a, b)
        y.backward(ct)
        grads.append((y.detach(), a.grad, b.grad))
    (y0, dx0, dw0), (y1, dx1, dw1) = grads
    assert torch.equal(y0, y1)
    assert torch.allclose(dx0, dx1, rtol=1e-12, atol=1e-12)
    assert torch.allclose(dw0, dw1, rtol=1e-12, atol=1e-12)
    b = w.clone().requires_grad_()
    unet_v5.ConvK.apply(x, b).backward(ct)
    assert torch.allclose(b.grad, dw1, rtol=1e-12, atol=1e-12)
