"""Kernel 6 of the port (climsim_tpu_torch.ops.fused_mlp_train) on the
CPU, where it takes its plain PyTorch versions, against the JAX package's
custom-VJP Pallas kernels (interpret mode on the CPU) and the JAX test's
own criteria (tests/test_fused_train.py).

Tolerances: forward rtol 1e-5 / atol 1e-6 and dW, db rel-L2 <= 1e-5
against the Pallas kernels (the same float32 activations, bf16 roundings
and float32 sums; only the order of summation differs); against bf16
autodiff the JAX test's rel-L2 < 0.08 and cosine > 0.995; two tile_b
within its rtol 2e-2 / atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.fused_mlp_train import make_fused_mlp_train as jax_fused
from climsim_tpu_torch.ops import fused_mlp_train as FT
from climsim_tpu_torch.ops import kernels as PK

WIDTHS = (124, 192, 160, 128)


@pytest.fixture(scope="module")
def net():
    """The JAX test's network and batch (the same draws)."""
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=(WIDTHS[i], WIDTHS[i + 1])).astype(np.float32)
          * 0.05 for i in range(len(WIDTHS) - 1)]
    bs = [rng.normal(size=(WIDTHS[i + 1],)).astype(np.float32) * 0.01
          for i in range(len(WIDTHS) - 1)]
    x = rng.normal(size=(96, WIDTHS[0])).astype(np.float32)
    y = rng.normal(size=(96, WIDTHS[-1])).astype(np.float32)
    return ws, bs, x, y


def _params(ws, bs):
    return ([torch.tensor(w, requires_grad=True) for w in ws],
            [torch.tensor(b, requires_grad=True) for b in bs])


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


def _torch_grads(fn, ws, bs, x, y):
    tw, tb = _params(ws, bs)
    loss = ((fn(torch.from_numpy(x), tw, tb) - torch.from_numpy(y)) ** 2
            ).mean()
    loss.backward()
    return [w.grad.numpy() for w in tw] + [b.grad.numpy() for b in tb]


def _jax_grads(fused, ws, bs, x, y):
    gw, gb = jax.grad(lambda a, b: jnp.mean((fused(jnp.asarray(x), a, b)
                                             - y) ** 2), argnums=(0, 1))(
        [jnp.asarray(w) for w in ws], [jnp.asarray(b) for b in bs])
    return [np.asarray(g) for g in list(gw) + list(gb)]


def test_forward_matches_pallas(net):
    ws, bs, x, _ = net
    PK.reset_launches()
    got = FT.make_fused_mlp_train(WIDTHS, tile_b=32)(
        torch.from_numpy(x), *_params(ws, bs)).detach().numpy()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)  # CPU: plain
    want = np.asarray(jax_fused(WIDTHS, tile_b=32)(
        jnp.asarray(x), [jnp.asarray(w) for w in ws],
        [jnp.asarray(b) for b in bs]))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tile_b", [16, 32, 96])
def test_gradients_match_the_jax_vjp(net, tile_b):
    ws, bs, x, y = net
    got = _torch_grads(FT.make_fused_mlp_train(WIDTHS, tile_b), ws, bs, x, y)
    want = _jax_grads(jax_fused(WIDTHS, tile_b), ws, bs, x, y)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_l2(a, b) <= 1e-5, _rel_l2(a, b)


def test_ragged_widths_match_the_jax_vjp():
    """Hidden widths of 2 mod 4 at an odd batch: on the card the second
    layer's saved activations then start off a 16-byte boundary, so the
    forward's recompute must store them a float at a time."""
    widths = (12, 10, 8, 3)
    rng = np.random.default_rng(1)
    ws = [(rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.normal(size=o)).astype(np.float32) for o in widths[1:]]
    x = rng.normal(size=(7, widths[0])).astype(np.float32)
    y = rng.normal(size=(7, widths[-1])).astype(np.float32)
    got = _torch_grads(FT.make_fused_mlp_train(widths), ws, bs, x, y)
    want = _jax_grads(jax_fused(widths), ws, bs, x, y)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert _rel_l2(a, b) <= 1e-5, _rel_l2(a, b)


def _bf16_apply(x, ws, bs):
    """The JAX test's ref_apply: bf16 operands, bf16 products."""
    h = x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = (h.to(torch.bfloat16) @ w.to(torch.bfloat16)).float() + b
        if i < len(ws) - 1:
            h = torch.relu(h)
    return h


def test_gradients_match_bf16_autodiff(net):
    """The JAX test's criteria (test_fused_train.py:63-69)."""
    ws, bs, x, y = net
    got = _torch_grads(FT.make_fused_mlp_train(WIDTHS, 32), ws, bs, x, y)
    want = _torch_grads(_bf16_apply, ws, bs, x, y)
    for a, b in zip(got, want):
        assert _rel_l2(a, b) < 0.08
        assert _cos(a, b) > 0.995


def test_multi_tile_accumulation(net):
    """dW summed over six 16-row tiles equals the one-tile result."""
    ws, bs, x, y = net
    small = _torch_grads(FT.make_fused_mlp_train(WIDTHS, 16), ws, bs, x, y)
    big = _torch_grads(FT.make_fused_mlp_train(WIDTHS, 96), ws, bs, x, y)
    for a, b in zip(small, big):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-4)


def test_no_gradient_for_the_input(net):
    ws, bs, x, _ = net
    xt = torch.tensor(x, requires_grad=True)
    FT.make_fused_mlp_train(WIDTHS)(xt, *_params(ws, bs)).sum().backward()
    assert torch.equal(xt.grad, torch.zeros_like(xt))


def test_plain_twin_and_the_float32_control(net):
    """make_fused_mlp_train_plain is the same function; the backward
    without the bf16 roundings (the card's control) is > 1e-3 rel-L2 off
    on every dW, while the last layer's db (sum of dy) is unchanged; its
    rounded=False twin takes that backward."""
    ws, bs, x, y = net
    a = _torch_grads(FT.make_fused_mlp_train(WIDTHS), ws, bs, x, y)
    b = _torch_grads(FT.make_fused_mlp_train_plain(WIDTHS), ws, bs, x, y)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    c = _torch_grads(FT.make_fused_mlp_train_plain(WIDTHS, rounded=False),
                     ws, bs, x, y)
    for u, v in zip(c[:len(ws)], b[:len(ws)]):
        assert _rel_l2(u, v) > 1e-3
    xt, dy = torch.from_numpy(x), torch.from_numpy(y) / 96
    tw = [torch.from_numpy(w) for w in ws]
    tb = [torch.from_numpy(b) for b in bs]
    want = FT.fused_mlp_train_bwd_plain(xt, dy, tw, tb)
    ctl = FT.fused_mlp_train_bwd_plain(xt, dy, tw, tb, rounded=False)
    for w, c in zip(want[0], ctl[0]):
        assert _rel_l2(c, w) > 1e-3
    np.testing.assert_array_equal(want[1][-1], ctl[1][-1])


def test_training_converges(net):
    """Adam on the fused function drives the loss down (the JAX test's
    loop, test_fused_train.py:87-108)."""
    ws, bs, x, y = net
    fused = FT.make_fused_mlp_train(WIDTHS, tile_b=32)
    tw, tb = _params(ws, bs)
    opt = torch.optim.Adam(tw + tb, lr=1e-3)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    losses = []
    for _ in range(31):
        opt.zero_grad()
        loss = ((fused(xt, tw, tb) - yt) ** 2).mean()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.9


def test_entries_reject_bad_inputs(net):
    ws, bs, x, y = net
    tw = [torch.from_numpy(w) for w in ws]
    tb = [torch.from_numpy(b) for b in bs]
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError):
        FT.fused_mlp_train_fwd(xt.double(), tw, tb)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_fwd(xt[:, :100].contiguous(), tw, tb)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_fwd(xt, tw, tb[:-1])
    with pytest.raises(ValueError):
        FT.fused_mlp_train_fwd(xt, [tw[0].t()] + tw[1:], tb)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_bwd(xt, torch.zeros(96, 127), tw, tb)
    with pytest.raises(ValueError):
        FT.fused_mlp_train_bwd(xt, torch.zeros(96, 128), tw, tb, tile_b=0)
    with pytest.raises(ValueError):
        FT.make_fused_mlp_train((124, 192, 160, 64))(xt, tw, tb)
