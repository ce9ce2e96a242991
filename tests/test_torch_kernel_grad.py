"""Kernels 1 and 4 under autograd (``ops.kernels._InputTransformGrad``,
``_ConstraintHeadGrad``), on the CPU.

A kernel launch writes into a fresh tensor that autograd cannot see, so a
differentiated wrapper on the card would lose every gradient through it
(F4).  The public functions therefore launch through an autograd Function
where a gradient is wanted: forward the kernel, backward autograd of the
plain version at the saved inputs.  No card here: the launches are
replaced by the plain versions under no_grad (a tensor with no grad_fn,
as the kernel returns) and ``_on_cuda`` by True, so CPU tensors take the
kernel's route.  The Function's input gradients equal autograd of the
plain chain bit for bit; with no gradient wanted it is not entered.
"""

import numpy as np
import pytest
import torch

from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.norms import load_asset_norms
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.varspec import get_varspec

GRID = load_default_grid()
CONFIGS = {"v5": PT.v5_online_config(),
           "v4": PT.TransformConfig(qn_transform=True, qinput_prune=True,
                                    input_clip=True, input_clip_rhonly=True),
           "v2_rh": PT.TransformConfig(input_clip=True,
                                       input_clip_rhonly=True)}


@pytest.fixture
def kernel_route(monkeypatch):
    """CPU tensors take the kernel's route; each launch is the plain
    version with no grad_fn, counted.  Returns the counts (launches and
    Function entries)."""
    seen = {"transform": 0, "head": 0, "transform_fn": 0, "head_fn": 0}

    def transform(x, consts, dev):
        seen["transform"] += 1
        with torch.no_grad():
            return PK.fused_input_transform_plain(x, consts)

    def head(y, t, qc, qi, consts, dt, lds, dev):
        seen["head"] += 1
        with torch.no_grad():
            return PK.fused_constraint_head_plain(y, t, qc, qi, consts, dt)

    def counted(cls, key):
        fwd = cls.forward

        def forward(*a):
            seen[key] += 1
            return fwd(*a)
        monkeypatch.setattr(cls, "forward", staticmethod(forward))

    monkeypatch.setattr(PK, "_on_cuda", lambda x, what: True)
    monkeypatch.setattr(PK, "_transform_launch", transform)
    monkeypatch.setattr(PK, "_head_launch", head)
    counted(PK._InputTransformGrad, "transform_fn")
    counted(PK._ConstraintHeadGrad, "head_fn")
    return seen


def _columns(version, n=12, seed=4):
    spec = get_varspec(version)
    x = synthetic_inputs(spec, n, GRID, seed=seed)
    if "state_rh" in spec.input_slices:     # RH at both clip bounds: ties
        s = spec.input_slices["state_rh"].start
        x[0, s:s + 5], x[1, s:s + 5] = 0.0, 1.2
    return spec, x


@pytest.mark.parametrize("version", sorted(CONFIGS))
def test_transform_gradient_is_the_plain_chains(version, kernel_route):
    spec, x = _columns(version)
    consts = PT.input_transform_consts(spec, load_asset_norms(version),
                                       CONFIGS[version], "cpu")
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        x.shape).astype(np.float32))
    xk = torch.from_numpy(x).requires_grad_()
    y = PK.fused_input_transform(xk, consts)
    assert kernel_route["transform_fn"] == kernel_route["transform"] == 1
    assert type(y.grad_fn).__name__ == "_InputTransformGradBackward"
    (got,) = torch.autograd.grad(y, xk, g)
    xp = torch.from_numpy(x).requires_grad_()
    want_y = PK.fused_input_transform_plain(xp, consts)
    (want,) = torch.autograd.grad(want_y, xp, g)
    assert torch.equal(y.detach(), want_y.detach())
    assert torch.equal(got, want)
    assert got.abs().max() > 0


@pytest.mark.parametrize("b", [1, 7])
def test_head_gradient_is_the_plain_chains(b, kernel_route):
    """y_norm and t, qc, qi as strided views of a raw v4 row, every one
    requiring grad through its base."""
    rng = np.random.default_rng(b)
    raw = rng.normal(size=(b, 1525)).astype(np.float32)
    raw[:, 0:60] = 240 + 45 * rng.random((b, 60))   # both sides of the ramp
    raw[:, 120:240] = np.abs(rng.normal(size=(b, 120))) * 1e-5
    y = rng.normal(size=(b, 308)).astype(np.float32)
    g = torch.from_numpy(rng.normal(size=(b, 368)).astype(np.float32))
    consts = PK.constraint_head_consts(load_asset_norms("v5").out_scale, 15,
                                       device="cpu")

    def run(fn):
        xr = torch.from_numpy(raw).requires_grad_()
        yn = torch.from_numpy(y).requires_grad_()
        out = fn(yn, xr[:, 0:60], xr[:, 120:180], xr[:, 180:240], consts,
                 1200.0)
        return (out.detach(),) + torch.autograd.grad(out, (yn, xr), g)

    got = run(PK.fused_constraint_head)
    assert kernel_route["head_fn"] == kernel_route["head"] == 1
    want = run(PK.fused_constraint_head_plain)
    for a, w in zip(got, want):
        assert torch.equal(a, w)
    assert got[1].abs().max() > 0 and got[2].abs().max() > 0


def test_no_gradient_wanted_takes_the_direct_launch(kernel_route):
    spec, x = _columns("v5")
    consts = PT.input_transform_consts(spec, load_asset_norms("v5"),
                                       CONFIGS["v5"], "cpu")
    hconsts = PK.constraint_head_consts(load_asset_norms("v5").out_scale,
                                        15, device="cpu")
    raw = torch.from_numpy(synthetic_inputs(get_varspec("v4"), 12, GRID,
                                            seed=2))
    y = torch.zeros(12, 308)
    args = (raw[:, 0:60], raw[:, 120:180], raw[:, 180:240], hconsts, 1200.0)
    xt = torch.from_numpy(x)
    PK.fused_input_transform(xt, consts)          # nothing requires grad
    PK.fused_constraint_head(y, *args)
    with torch.no_grad():                         # grad mode off
        PK.fused_input_transform(xt.requires_grad_(), consts)
        PK.fused_constraint_head(y.requires_grad_(), *args)
    with torch.inference_mode():
        PK.fused_input_transform(torch.from_numpy(x), consts)
    assert kernel_route == {"transform": 3, "head": 2, "transform_fn": 0,
                            "head_fn": 0}


def test_f4_a_bare_launch_drops_the_gradient(kernel_route, monkeypatch):
    """F4 planted: the launch handed back as it is where a gradient is
    wanted.  Its output has no grad_fn, so a loss through it reaches no
    input."""
    spec, x = _columns("v2_rh")
    consts = PT.input_transform_consts(spec, load_asset_norms("v2_rh"),
                                       CONFIGS["v2_rh"], "cpu")
    monkeypatch.setattr(PK._InputTransformGrad, "apply",
                        lambda x, c: PK._transform_launch(x, c, c.device))
    xk = torch.from_numpy(x).requires_grad_()
    y = PK.fused_input_transform(xk, consts)
    assert y.grad_fn is None and not y.requires_grad
    with pytest.raises(RuntimeError, match="does not require grad"):
        torch.autograd.grad(y.sum(), xk)


def test_v4_wrapper_gradient_through_both_kernels(kernel_route):
    """make_wrapper on raw v4 columns: the gradient with respect to the
    columns and a linear model's weight through kernels 1 and 4 equals
    the plain path's (the CPU's own), bit for bit."""
    spec4 = get_varspec("v4")
    x = synthetic_inputs(spec4, 9, GRID, seed=6)
    proj0 = np.random.default_rng(0).standard_normal(
        (1405, 308)).astype(np.float32) / 40
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (9, 368)).astype(np.float32))

    def grads():
        proj = torch.from_numpy(proj0).requires_grad_()
        wrap = PW.make_wrapper(lambda xn: xn @ proj, load_asset_norms("v5"),
                               PW.WrapperConfig(input_version="v4"),
                               device="cpu")
        xr = torch.from_numpy(x).requires_grad_()
        out = wrap(xr)
        return (out.detach(),) + torch.autograd.grad(out, (xr, proj), g)

    got = grads()
    assert kernel_route["transform_fn"] == kernel_route["head_fn"] == 1
    with pytest.MonkeyPatch.context() as mp:    # the CPU's plain route
        mp.setattr(PK, "_on_cuda", lambda x, what: False)
        want = grads()
    assert kernel_route["transform"] == kernel_route["head"] == 1
    for a, w in zip(got, want):
        assert torch.equal(a, w)
