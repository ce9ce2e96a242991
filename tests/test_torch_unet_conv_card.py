"""The U-Net's plain convolutions on bf16 tensor cores, on the card.

One ``unet_trainer`` step of the fused unet_v5 U-Net at B = 1024 (the
``unet_v5.train_b1024`` cell's model and batch): 41 ``Conv1d`` calls a
forward on the tensor-core path and none on the widened one; no FFT
convolution and no complex float32 GEMM among the step's device ops; the
loss, the input's gradient and every parameter's gradient within a bf16
tolerance of the same step with ``conv_widened`` in the tensor-core
path's place (float32 products, TF32 off), where the same step with
torch's own bf16 k = 3 convolution (cuDNN off: partial sums rounded to
bf16) in its place, the control, must fall outside it.  Besides: the bf16
bias add bit-equal to flax's two roundings; a k = 3 conv with cuDNN off
on the widened path.

This file imports no JAX: the tests skip without a card, and on the card
run with the repository's conftest (which imports JAX) left out:

  python -m pytest --noconftest -p no:cacheprovider -m card \\
      tests/test_torch_unet_conv_card.py
"""

import pytest
import torch

BATCH = 1024
# The step with bf16 tensor-core convolutions against the same step with
# the widened float32 ones.  Both round the same float32 sums to bf16;
# only the order of the sums differs, so a share of the roundings flips
# and the 40 blocks carry the flips on.  The loss, relative, as
# chip_smoke.py's UNET_FIRST_LOSS_TOL (card against CPU).  The gradients:
# on an H100 the step read dx 3.9e-3 (rel-L2) and dw 3.0e-3 (worst leaf)
# from the widened step, and a single (384, 64, 256->256) k = 3 conv with
# torch's own bf16 convolution (cuDNN off, dw's sum over the batch and
# dx's over the taps rounded to bf16 part by part) dw 2.3e-2, dx 2.7e-3,
# and in this step dw 0.128, dx 5.0e-3; the tolerance lies between, and
# that control must exceed it.
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-2


@pytest.fixture
def card():
    """Skips the test where no CUDA card is present (decided here, when
    the test runs, never while the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def _reinit(model, seed):
    """Weights at variance 1 / fan-in with no zero init, biases and norm
    shifts 0.1 N, norm scales 1 + 0.1 N: every branch moves the output
    (the zero-initialized convolutions would leave most gradients 0)."""
    from climsim_tpu_torch.models.unet import Conv1d, GroupNorm

    g = torch.Generator(device=next(model.parameters()).device)
    g.manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv1d):
                cout, cin, k = m.weight.shape
                lim = (3.0 / (cin * k)) ** 0.5
                m.weight.uniform_(-lim, lim, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
            elif isinstance(m, GroupNorm):
                m.weight.normal_(1.0, 0.1, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)


def _step(tr, xb, yb):
    """(loss, the model input's gradient, {parameter: gradient}) of one
    ``train_step``; the input's gradient by a forward pre-hook."""
    seen = []

    def keep(module, args):
        seen.append(args[0].detach().requires_grad_())
        return (seen[-1], *args[1:])

    hook = tr.model.register_forward_pre_hook(keep)
    try:
        tr.state, metrics = tr.train_step(tr.state, xb, yb)
    finally:
        hook.remove()
    return (float(metrics["loss"]), seen[0].grad,
            {k: p.grad.clone() for k, p in tr.model.named_parameters()})


def _torch_bf16_conv(x, w, b):
    """The control: ``conv_tensor_core`` with torch's own bf16
    convolution, cuDNN off in the forward and in the backward, in place of
    cuDNN's (a 1x1 conv is the same GEMM either way)."""
    from climsim_tpu_torch.models import unet

    class Conv(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x_, w_):
            ctx.save_for_backward(x_, w_)
            with torch.backends.cudnn.flags(enabled=False):
                return unet.conv_nlc(x_, w_)

        @staticmethod
        def backward(ctx, dy):
            x_, w_ = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            with torch.enable_grad(), \
                    torch.backends.cudnn.flags(enabled=False):
                return torch.autograd.grad(unet.conv_nlc(x_, w_), (x_, w_),
                                           dy)

    bf = torch.bfloat16
    return (Conv.apply(x.to(bf), w.to(bf)) + b.to(bf)).float()


def _diff_by_leaf(got: dict, want: dict) -> float:
    """max ‖p − r‖ / max(‖r‖, median ‖r‖) over the leaves."""
    norm = {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in want.items()}
    med = float(torch.tensor(list(norm.values())).median())
    return max(float(torch.linalg.vector_norm(got[k].double()
                                              - want[k].double()))
               / max(norm[k], med) for k in want)


@pytest.mark.card
@pytest.mark.parametrize("k", [1, 3])
def test_tensor_core_bias_is_added_as_flax_adds_it(card, k):
    """The bf16 add of the bias is round(round(y) + round(b)), bit for bit,
    on the card's elementwise kernels too."""
    from climsim_tpu_torch.models import unet

    bf = torch.bfloat16
    g = torch.Generator(device=card).manual_seed(k)
    x = torch.randn(BATCH, 64, 128, device=card, generator=g)
    w = torch.randn(256, 128, k, device=card, generator=g) / (128 * k) ** 0.5
    b = 0.3 * torch.randn(256, device=card, generator=g)
    y = unet.conv_nlc(x.to(bf), w.to(bf)).float()
    want = unet._round(y + unet._round(b, bf), bf)
    assert torch.equal(unet.conv_tensor_core(x, w, b), want)


@pytest.mark.card
def test_k3_without_cudnn_takes_the_widened_path(card):
    """With cuDNN off a k = 3 conv takes the widened float32 path (torch's
    own bf16 conv would round dw and dx's partial sums to bf16); a 1x1
    conv keeps its bf16 GEMM."""
    from climsim_tpu_torch.models import unet

    x = torch.randn(64, 32, 128, device=card)
    convs = {k: unet.Conv1d(128, 64, k, device=card) for k in (1, 3)}
    with torch.backends.cudnn.flags(enabled=False):
        for k, m in convs.items():
            unet.reset_conv_calls()
            y = m(x)
            path = "tensor_core" if k == 1 else "float32"
            assert unet.CONV_CALLS[path] == 1, (k, unet.CONV_CALLS)
        assert torch.equal(y, unet.conv_widened(x, m.weight, m.bias,
                                                torch.bfloat16))
    unet.reset_conv_calls()
    convs[3](x)
    assert unet.CONV_CALLS == {"tensor_core": 1, "float32": 0}


@pytest.mark.card
def test_unet_v5_step_on_tensor_cores(card, monkeypatch):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from climsim_tpu_torch import bench_unet_train as BU
    from climsim_tpu_torch.models import unet

    data = BU.pool(BATCH)
    xb, yb = (torch.from_numpy(a).to(card) for a in data)
    tr, _ = BU.build(card, "fused", data, batch=BATCH)
    _reinit(tr.model, 1)
    weights = {k: v.clone() for k, v in tr.model.state_dict().items()}
    ref, _ = BU.build(card, "fused", data, batch=BATCH, state_dict=weights)

    tr.train_step(tr.state, xb, yb)           # cuDNN's and cuBLAS's set-up
    tr.model.load_state_dict(weights)         # the gradients at ``weights``
    torch.cuda.synchronize()
    unet.reset_conv_calls()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        loss, dx, dw = _step(tr, xb, yb)
        torch.cuda.synchronize()
    assert unet.CONV_CALLS == {"tensor_core": 41, "float32": 0}
    ops = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            ops[ev.name] = ops.get(ev.name, 0.0) + ev.device_time_total
    assert ops, "the profiler saw no device op"
    slow = [n for n in ops if "fft" in n.lower() or "cf32" in n.lower()]
    assert slow == [], slow
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:8]
    print("top device ops (ms): " + "; ".join(
        f"{n[:60]} {t / 1e3:.3f}" for n, t in top))

    monkeypatch.setattr(unet, "conv_tensor_core", lambda x, w, b:
                        unet.conv_widened(x, w, b, torch.bfloat16))
    want_loss, want_dx, want_dw = _step(ref, xb, yb)
    loss_gap = abs(loss - want_loss) / abs(want_loss)
    dx_gap = float(torch.linalg.vector_norm((dx - want_dx).double())
                   / torch.linalg.vector_norm(want_dx.double()))
    dw_gap = _diff_by_leaf(dw, want_dw)
    print(f"tensor core against widened at B={BATCH}: loss {loss_gap:.3e} "
          f"(tolerance {LOSS_RTOL}), dx rel-L2 {dx_gap:.3e}, dw worst leaf "
          f"{dw_gap:.3e} (tolerance {GRAD_TOL})")
    assert loss_gap <= LOSS_RTOL
    assert dx_gap <= GRAD_TOL and dw_gap <= GRAD_TOL

    # the control, from the same weights (the step above updated them)
    tr.model.load_state_dict(weights)
    monkeypatch.setattr(unet, "conv_tensor_core", _torch_bf16_conv)
    _, ctl_dx, ctl_dw = _step(tr, xb, yb)
    ctl_dx_gap = float(torch.linalg.vector_norm((ctl_dx - want_dx).double())
                       / torch.linalg.vector_norm(want_dx.double()))
    ctl_dw_gap = _diff_by_leaf(ctl_dw, want_dw)
    print(f"control (torch's bf16 k = 3 conv, cuDNN off): dx rel-L2 "
          f"{ctl_dx_gap:.3e}, dw worst leaf {ctl_dw_gap:.3e}")
    assert max(ctl_dx_gap, ctl_dw_gap) > GRAD_TOL
