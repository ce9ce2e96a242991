"""GroupNorm -> silu -> conv3, the U-Net half-block, as one CUDA kernel,
and that kernel under a custom VJP for training.

The counterpart of ``climsim_tpu.ops.unet_fused``: the EDM half-block

    GroupNorm(float32 two-pass statistics) -> silu -> bf16 -> Conv1d(k=3,
    bf16 x bf16 products summed in float32) + float32 bias

in one launch (``ops/csrc/fused_gn_silu_conv3.cu``), so the normalized
activations never leave the chip.  Layout is the JAX package's,
channels-last: x (B, L, C), w (3, C, Cout) as flax keeps a conv kernel.

As in ``ops.kernels``: the public function checks its arguments, takes the
plain version for a tensor on the CPU and launches the kernel for a tensor
on a CUDA device (no fallback), and counts each launch in
``kernels.LAUNCHES["fused_gn_silu_conv3"]``.

``make_trainable_fused_block`` (``climsim_tpu/ops/unet_fused.py:160``) puts
the kernel inside a training step: its forward is the kernel, its backward
autograd of the plain chain ``xla_gn_silu_conv3_plain(f32_accum=False)``
recomputed at the saved inputs, as the JAX backward is ``jax.vjp`` of the
XLA chain (``:194-196``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.unet import _num_groups
from . import _build
from .kernels import LAUNCHES, _check, _on_cuda, _stream

EPS = 1e-6
MAX_LEVELS = 64   # kMaxRowTiles * 16 in the kernel
# the profiler range around the custom VJP's backward (the recompute)
BACKWARD_RANGE = "fused_gn_silu_conv3 backward"


def xla_gn_silu_conv3_plain(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor,
                            compute_dtype: torch.dtype | None = None,
                            f32_accum: bool = True, *,
                            groups: int | None = None,
                            eps: float = EPS) -> torch.Tensor:
    """``xla_gn_silu_conv3`` (``climsim_tpu/ops/unet_fused.py:129-157``) in
    torch: two-pass GroupNorm statistics, affine, silu, rounded to
    ``compute_dtype`` (``w``'s dtype by default), conv3 with ``w`` rounded
    to it, + ``b``; ``groups`` defaults to ``_num_groups(C)``.

    The rounded operands are widened back to ``x``'s dtype and the product
    is taken there (bf16 products are exact in float32).  ``f32_accum=True``
    keeps the float32 sum (the kernel's arithmetic); ``False`` rounds the
    conv's output to ``compute_dtype`` before the bias, as flax's Conv1d
    does, and autograd of it rounds as the XLA VJP does: the incoming
    gradient to bf16 before the conv's transposes, dxn and dw to bf16
    after them."""
    cd = compute_dtype or w.dtype
    bsz, l, c = x.shape
    g = groups or _num_groups(c)
    xg = x.reshape(bsz, l, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    xn = F.silu(xn * gamma + beta).to(cd).to(x.dtype)
    y = F.conv1d(xn.transpose(1, 2), w.to(cd).to(x.dtype).permute(2, 1, 0),
                 padding=1).transpose(1, 2)
    if not f32_accum:
        y = y.to(cd).to(x.dtype)
    return y + b


def _shape_error(bsz: int, l: int, c: int, cout: int,
                 dev: torch.device) -> str | None:
    """Why the kernel cannot take this shape on ``dev``, or None."""
    if (not 1 <= l <= MAX_LEVELS or c % 64 or (c // _num_groups(c)) % 4
            or cout % 16 or bsz > 65535):
        return (f"the kernel takes L <= {MAX_LEVELS}, C a multiple of 64 "
                "with C / groups a multiple of 4, Cout a multiple of 16 and "
                f"B <= 65535; got B={bsz}, L={l}, C={c}, Cout={cout}")
    rows = -(-l // 16) * 16
    smem = ((rows + 2) * (c + 16) * 2 + max(3 * 64 * 136 * 2, rows * 128 * 4)
            + 8 * _num_groups(c))
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        return (f"C={c} at L={l} needs {smem} B of shared memory; the card "
                f"has {limit}")
    return None


def check_kernel_shapes(chains, device) -> None:
    """Raise unless the kernel takes every (L, C, Cout) of ``chains`` (a
    model's ``fused_chains()``) on ``device``: a trainer checks its network
    before the first step, not by a failure in the middle of one."""
    dev = torch.device(device)
    for l, c, cout in chains:
        err = _shape_error(1, l, c, cout, dev)
        if err:
            raise ValueError(f"fused chain (L={l}, C={c}, Cout={cout}): "
                             + err)


def fused_gn_silu_conv3(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """x (B, L, C) float32, gamma/beta (C,) float32, w (3, C, Cout) bf16,
    b (Cout,) float32 -> (B, L, Cout) float32, with ``_num_groups(C)``
    groups and eps 1e-6.  On the CPU, w may also be float32 (the
    float32-compute path); the kernel takes bf16 only."""
    dev = x.device
    _check(x, "x", torch.float32, (None, None, None), dev)
    bsz, l, c = x.shape
    if w.dim() != 3:
        raise ValueError(f"w: want (3, {c}, Cout), got {tuple(w.shape)}")
    cout = w.shape[2]
    _check(w, "w", w.dtype, (3, c, cout), dev)
    for name, t, n in (("gamma", gamma, c), ("beta", beta, c), ("b", b, cout)):
        _check(t, name, torch.float32, (n,), dev)
    if not _on_cuda(x, "fused_gn_silu_conv3"):
        if w.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"w: want bf16 or float32, got {w.dtype}")
        return xla_gn_silu_conv3_plain(x, gamma, beta, w, b)
    if w.dtype != torch.bfloat16:
        raise TypeError(f"w: the kernel takes bf16 weights, got {w.dtype}")
    err = _shape_error(bsz, l, c, cout, dev)
    if err:
        raise ValueError(err)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (vector loads)")
    out = torch.empty((bsz, l, cout), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.cst_fused_gn_silu_conv3(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), bsz, l, c, cout, _num_groups(c),
            EPS, _stream(dev))
    _build.check(code, "fused_gn_silu_conv3")
    LAUNCHES["fused_gn_silu_conv3"] += 1
    return out


class _TrainableBlock(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU) on ``w`` rounded
    to the compute dtype.  Saves the five inputs only; the backward
    recomputes the plain chain at them and differentiates it."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, groups, eps, compute_dtype):
        # activations reach a chain from torch.cat and residual sums; the
        # kernel takes a contiguous x, so it is made so here, once
        x = x.contiguous()
        if groups != _num_groups(x.shape[2]) or eps != EPS:
            raise ValueError(f"the kernel takes {_num_groups(x.shape[2])} "
                             f"groups and eps {EPS}; got {groups}, {eps}")
        if x.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise TypeError("the kernel takes bf16 weights; "
                            f"compute_dtype {compute_dtype} runs on the CPU")
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.cfg = (groups, eps, compute_dtype)
        # the weight changes after every update, so it is cast every call
        return fused_gn_silu_conv3(x, gamma, beta,
                                   w.to(compute_dtype).contiguous(), b)

    @staticmethod
    def backward(ctx, g):
        groups, eps, compute_dtype = ctx.cfg
        # the range lets a profile of a step tell the recompute apart
        with torch.profiler.record_function(BACKWARD_RANGE), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = xla_gn_silu_conv3_plain(*ins, compute_dtype, f32_accum=False,
                                        groups=groups, eps=eps)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None, None, None)


def make_trainable_fused_block(groups: int, eps: float = EPS,
                               compute_dtype: torch.dtype = torch.bfloat16):
    """The counterpart of ``make_trainable_fused_block``
    (``climsim_tpu/ops/unet_fused.py:160``): returns ``f(x, gamma, beta, w,
    b) -> (B, L, Cout)`` float32, differentiable in all five, with ``w`` the
    float32 (3, Cin, Cout) kernel in flax's layout (dw is float32).

    Forward: ``fused_gn_silu_conv3`` on ``w`` rounded to ``compute_dtype``,
    the CUDA kernel on the card and its plain version on the CPU.
    Backward: autograd of ``xla_gn_silu_conv3_plain(f32_accum=False)`` at
    the saved inputs; it never calls the kernel.  ``compute_dtype=float32``
    runs both halves in float32 (the CPU parity path; the kernel refuses
    it on the card).  Where the kernel cannot take a shape the forward
    raises: it never takes the plain version on the card."""

    def f(x, gamma, beta, w, b):
        return _TrainableBlock.apply(x, gamma, beta, w, b, groups, eps,
                                     compute_dtype)

    return f
