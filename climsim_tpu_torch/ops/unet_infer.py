"""Fused-inference engine for ClimSimUNet: the served U-Net v5 forward.

The counterpart of ``climsim_tpu.ops.unet_infer``.  It reads the port
module's parameters and replays the forward as the JAX engine does
(``climsim_tpu/ops/unet_infer.py:152-232``), over the module's own
topology (``ClimSimUNet.trunk``):

  * the norm0 chain of every non-resample block and the norm1 chain of
    every block run through the fused GroupNorm -> silu -> conv3 kernel
    (``ops.unet_fused``): 82 launches a forward at the ``unet_v5`` widths;
  * resample blocks, the 1x1 skips, attention, the first conv and the
    output head stay plain torch.  Their convs take bf16-rounded operands
    and add the float32 bias to the float32 sum, with no rounding of the
    sum to bf16: the JAX engine's ``_conv``, which differs in that from
    the module's flax casting, and is copied as it is;
  * GroupNorm statistics are two-pass float32, where the module (flax)
    uses E[x^2] - E[x]^2.

Any B is taken, 1 and ragged sizes included: the kernel works per sample,
so there is no batch tile.  ``fused=False`` is the all-plain engine.

The JAX engine ignores four of the model's flags (``resample_proj=True``,
``norm1_act=False``, ``attn_heads != 0``, ``norm_dtype`` other than
float32: its ``_gn`` always normalizes in float32,
``climsim_tpu/ops/unet_infer.py:49-56``) and the classifier's
stratosphere logit forcing (``classifier`` with ``output_prune``), and
then returns another network's answer; this engine refuses them with a
ValueError.  The ``unet_v5`` preset sets none of them.  The training
flags (``dropout``, ``fused_gn_conv``, ``remat_blocks``) do not change
inference, and the engine takes them.

Weights are prepared once per model and device -- bf16 conv kernels in
the kernel's (3, C, Cout) layout, bf16-rounded float32 kernels for the
plain convs -- and prepared anew when a parameter changes.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..models.unet import (ClimSimUNet, Conv1d, GroupNorm, UNetBlock, _down,
                           _round, _up, conv_nlc)
from .unet_fused import EPS, fused_gn_silu_conv3

_CACHE_ATTR = "_fused_engine_weights"


def _check_flags(model: ClimSimUNet) -> None:
    bad = [f for f, on in (
        ("resample_proj=True", model.resample_proj),
        ("norm1_act=False", not model.norm1_act),
        (f"attn_heads={model.attn_heads}", model.attn_heads != 0),
        (f"norm_dtype={model.norm_dtype}", model.norm_dtype != torch.float32),
        ("classifier with output_prune",
         model.classifier and model.output_prune)) if on]
    if bad:
        raise ValueError(
            f"the fused engine replays the default U-Net only; {bad} would "
            "be ignored, as the JAX engine ignores them (ROADMAP Queue 3)")


def _weights(model: ClimSimUNet, device: torch.device) -> dict:
    """{conv module: (float32 kernel rounded to its compute dtype, (3, C,
    Cout) kernel in its compute dtype or None)}, cached on the model and
    rebuilt when a parameter is replaced or changed in place."""
    key = (device, tuple((id(p), p._version) for p in model.parameters()))
    cached = model.__dict__.get(_CACHE_ATTR)
    if cached is not None and cached[0] == key:
        return cached[1]
    prepared = {}
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv1d):
                w = m.weight.to(device)
                half = (w.permute(2, 1, 0).to(m.compute_dtype).contiguous()
                        if w.shape[-1] == 3 else None)
                prepared[m] = (_round(w, m.compute_dtype), half)
    model.__dict__[_CACHE_ATTR] = (key, prepared)
    return prepared


def _gn(x: torch.Tensor, norm: GroupNorm) -> torch.Tensor:
    """float32 two-pass GroupNorm (the JAX engine's ``_gn``)."""
    b, l, c = x.shape
    xg = x.reshape(b, l, norm.groups, c // norm.groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    return xn * norm.weight + norm.bias


class _Engine:
    def __init__(self, model: ClimSimUNet, weights: dict, fused: bool):
        self.cd = model.compute_dtype
        self.w = weights
        self.fused = fused

    def conv(self, m: Conv1d, x: torch.Tensor) -> torch.Tensor:
        """bf16-rounded operands, float32 sum, float32 bias."""
        return conv_nlc(_round(x, m.compute_dtype), self.w[m][0]) + m.bias

    def half(self, x: torch.Tensor, norm: GroupNorm,
             m: Conv1d) -> torch.Tensor:
        """GroupNorm -> silu -> conv3 through the kernel."""
        return fused_gn_silu_conv3(x.contiguous(), norm.weight, norm.bias,
                                   self.w[m][1], m.bias)

    def attention(self, attn, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        heads = max(c // 64, 1)
        d = c // heads
        qkv = self.conv(attn.qkv, _gn(x, attn.norm)).reshape(b, l, 3, heads,
                                                             d)
        q, k, v = (_round(qkv[:, :, i], self.cd) for i in range(3))
        scores = torch.einsum("blhd,bmhd->bhlm", q, k)
        w = torch.softmax(scores / math.sqrt(d), dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", _round(w, self.cd), v)
        out = self.conv(attn.proj, out.reshape(b, l, c))
        return (x + out) / math.sqrt(2.0)

    def block(self, blk: UNetBlock, x: torch.Tensor) -> torch.Tensor:
        if blk.up or blk.down or not self.fused:
            h = F.silu(_gn(x, blk.norm0))
            if blk.down:
                h, x = _down(h), _down(x)
            elif blk.up:
                h, x = _up(h), _up(x)
            h = self.conv(blk.conv0, h)
        else:
            h = self.half(x, blk.norm0, blk.conv0)
        if self.fused:
            h = self.half(h, blk.norm1, blk.conv1)
        else:
            h = self.conv(blk.conv1, F.silu(_gn(h, blk.norm1)))
        if blk.skip is not None:
            x = self.conv(blk.skip, x)
        y = (h + x) / math.sqrt(2.0)
        if blk.Attention_0 is not None:
            y = self.attention(blk.Attention_0, y)
        return y


def unet_apply_fused(model: ClimSimUNet, x: torch.Tensor, *,
                     fused: bool = True) -> torch.Tensor:
    """Inference forward of ``model`` on normalized (B, D_in) float32
    columns; equals ``model(x)`` to bf16-accumulation tolerance
    (tests/test_torch_unet.py)."""
    _check_flags(model)
    eng = _Engine(model, _weights(model, x.device), fused)
    h = model.trunk(model.assemble(x), eng.block, eng.conv)
    h = eng.conv(model.out_conv, F.silu(_gn(h, model.out_norm)))
    return model.finish(h)
