"""1D U-Net over the vertical column -- the coupling-grade online model.

The counterpart of ``climsim_tpu.models.unet`` (itself re-architected from
the reference's Modulus/EDM-style ClimsimUnet, online_testing/
baseline_models/Unet_v5/training/climsim_unet.py:35-411), as torch
modules that keep the flax module names, so ``utils.migrate.port_flax_unet``
maps a flax tree onto it name by name.  Parameters use torch's layouts:
a conv weight is (Cout, Cin, K) where flax keeps (K, Cin, Cout), a
GroupNorm scale is ``weight``.

Activations are channels-last (B, L, C), as in the JAX package.  The
casts follow flax's, one by one:

  * ``Conv1d`` is flax ``nn.Conv(dtype=compute_dtype)``: x and w rounded
    to bf16, the product accumulated in float32 and rounded to bf16, the
    bias rounded to bf16 and added, the sum rounded again, then widened
    to float32 (``climsim_tpu/models/unet.py:66-69``).  On a CUDA device
    at bf16 compute the products run on bf16 tensor cores (cuDNN's bf16
    convolution, cuBLAS's bf16 GEMM for 1x1), which sum in float32 and
    round once to bf16, as do their dgrad and wgrad: the same arithmetic
    but for the order of the float32 sums (``conv_tensor_core``).
    Elsewhere the rounded operands are widened back to float32 before the
    product, where bf16 products are exact (the idiom of
    ``models.common.Dense``; ``conv_widened``), and so is a k = 3 conv
    with cuDNN off.  ``CONV_CALLS`` counts the calls of each path.
  * ``GroupNorm`` is flax ``nn.GroupNorm(dtype=norm_dtype)``: statistics
    in float32 by E[x^2] - E[x]^2 clipped at 0, the scale folded into
    rsqrt(var + eps), the result stored in ``norm_dtype`` (float32, or
    bf16 to halve the bytes a norm writes).
  * ``Attention`` takes scores and the weighted sum from bf16 operands
    with float32 sums, and the softmax in float32 (``:126-134``).

The training features of ``climsim_tpu/models/unet.py``:

  * ``dropout`` between silu and conv1 (``:263-264``), active in
    ``train()`` mode only.  The masks come from the ``seed`` given to
    ``ClimSimUNet.forward``, block ``i`` from ``seed + i``, as flax folds a
    module's path into its dropout key; a recomputed block draws the same
    mask.  JAX's threefry bits are not reproduced.
  * ``fused_gn_conv``: the eligible GroupNorm -> silu -> conv3 chains run
    through ``ops.unet_fused.make_trainable_fused_block`` (kernel 5 under
    a custom VJP), with JAX's eligibility rules (``:237-256``): chain 0
    unless the block resamples, chain 1 when ``norm1_act`` and no
    dropout, both only when B % 16 == 0, on every device.  The fused
    chain keeps float32 statistics whatever ``norm_dtype`` is.
  * ``remat_blocks``: each block under
    ``torch.utils.checkpoint.checkpoint(use_reentrant=False)`` (``:375``),
    its activations recomputed in the backward.

None of them changes the parameters: a flax tree carries over by
``port_flax_unet`` whatever the flags.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import physics
from ..varspec import NUM_LEVELS, VarSpec
from .common import dropout, out_dtype, step_generator

N_LOC = 385       # rows of the column-location embedding (icol 0..384)
LOC_DIM = 8


def _num_groups(c: int, cap: int = 32) -> int:
    """Reference-exact GroupNorm group count: min(cap, c // 4), i.e. at
    least 4 channels per group (layers.py:271-276), falling back to the
    largest divisor below it where that count does not divide c."""
    g = min(cap, max(c // 4, 1))
    while c % g:
        g -= 1
    return g


def _down(x: torch.Tensor) -> torch.Tensor:
    """Box-filter downsample by 2 on the level axis (resample_filter [1,1])."""
    return 0.5 * (x[:, 0::2, :] + x[:, 1::2, :])


def _up(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor upsample by 2 on the level axis."""
    return torch.repeat_interleave(x, 2, dim=1)


def conv_nlc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME conv along the levels, channels-last: x (B, L, Cin), w (Cout,
    Cin, K) with K odd -> (B, L, Cout), in the dtype of its operands."""
    k = w.shape[-1]
    if k == 1:
        return x @ w[:, :, 0].t()
    return F.conv1d(x.transpose(1, 2), w, padding=k // 2).transpose(1, 2)


def _round(t: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``cd`` and widened to the accumulation dtype."""
    return t.to(cd).to(out_dtype(cd))


# ``Conv1d`` calls by path: ``tensor_core`` (``conv_tensor_core``) and
# ``float32`` (``conv_widened``; its sums are float64 at float64 compute)
CONV_CALLS = {"tensor_core": 0, "float32": 0}


def reset_conv_calls() -> None:
    for k in CONV_CALLS:
        CONV_CALLS[k] = 0


def conv_widened(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 cd: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(dtype=cd)`` on x (B, L, Cin), w (Cout, Cin, K), b
    (Cout,): the operands rounded to ``cd`` and widened, one widened
    convolution, then the bias as flax adds it; ``out_dtype(cd)``."""
    y = conv_nlc(_round(x, cd), _round(w, cd))
    if cd == out_dtype(cd):   # float32 compute: one float32 conv + bias
        return y + b.to(y.dtype)
    return _round(_round(y, cd) + _round(b, cd), cd)


def conv_tensor_core(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """``conv_widened`` at bf16 compute with bf16 operands: the backend's
    bf16 convolution or GEMM sums the products in float32 and rounds the
    result to bf16 once, where ``conv_widened`` rounds its float32 sum;
    dx and dw are rounded once likewise.  The bias is added as there: two
    roundings, not one in the convolution's epilogue.  A bf16 add sums in
    float32 and rounds once, so ``y + b`` in bf16 is round(round(y) +
    round(b)) in fewer launches."""
    cd = torch.bfloat16
    return (conv_nlc(x.to(cd), w.to(cd)) + b.to(cd)).float()


class Conv1d(nn.Module):
    """flax Conv1d: xavier-uniform weight (scaled by 1e-5 for
    ``zero_init``, as the reference's init_weight=1e-5), zero bias."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 zero_init: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(
            features, cin, kernel, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
        with torch.no_grad():
            nn.init.xavier_uniform_(self.weight, generator=generator)
            if zero_init:
                self.weight.mul_(1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        # a k = 3 conv reaches tensor cores through cuDNN: without it,
        # torch's own bf16 conv sums dw over the batch and dx over the taps
        # in bf16, which is not this arithmetic
        if (x.is_cuda and cd == torch.bfloat16
                and (self.weight.shape[2] == 1
                     or torch.backends.cudnn.enabled)):
            CONV_CALLS["tensor_core"] += 1
            return conv_tensor_core(x, self.weight, self.bias)
        CONV_CALLS["float32"] += 1
        return conv_widened(x, self.weight, self.bias, cd)


class IdentityConv(Conv1d):
    """1x1 conv initialized to identity (the reference's skip_conv_layer,
    climsim_unet.py:211-218).  flax's ``nn.Conv`` without a dtype computes
    at its float32 input's dtype, whatever the model's compute dtype."""

    def __init__(self, channels: int, device=None):
        super().__init__(channels, channels, 1, compute_dtype=torch.float32,
                         device=device)
        with torch.no_grad():
            self.weight.copy_(torch.eye(channels)[:, :, None])


class GroupNorm(nn.Module):
    """flax ``nn.GroupNorm(epsilon=1e-6, dtype=dtype)`` over (L, C/G)."""

    def __init__(self, channels: int, eps: float = 1e-6,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.groups = _num_groups(channels)
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        b, l, c = x.shape
        g = self.groups
        xg = x.reshape(b, l, g, c // g)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        mean2 = (xg * xg).mean(dim=(1, 3), keepdim=True)
        var = physics.maximum(mean2 - mean * mean, 0.0)   # flax's
        mul = torch.rsqrt(var + self.eps) * self.weight.reshape(1, 1, g, -1)
        y = ((xg - mean) * mul + self.bias.reshape(1, 1, g, -1)).reshape(
            b, l, c)
        # flax stores the result in its dtype; float32 keeps a wider input
        # (the float64 parity path) as it is
        return y if self.dtype == torch.float32 else y.to(self.dtype)


class Attention(nn.Module):
    """Single-axis self-attention over the (<= 64-token) level axis;
    ``num_heads=0`` uses 64 channels a head, 1 is the reference's."""

    def __init__(self, channels: int, num_heads: int = 0,
                 channels_per_head: int = 64,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.heads = (num_heads if num_heads > 0
                      else max(channels // channels_per_head, 1))
        self.compute_dtype = compute_dtype
        self.norm = GroupNorm(channels, dtype=norm_dtype, device=device)
        self.qkv = Conv1d(channels, 3 * channels, 1,
                          compute_dtype=compute_dtype, device=device,
                          generator=generator)
        self.proj = Conv1d(channels, channels, 1, zero_init=True,
                           compute_dtype=compute_dtype, device=device,
                           generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, l, c = x.shape
        d = c // self.heads
        cd = self.compute_dtype
        qkv = self.qkv(self.norm(x)).reshape(b, l, 3, self.heads, d)
        q, k, v = (_round(qkv[:, :, i], cd) for i in range(3))
        scores = torch.einsum("blhd,bmhd->bhlm", q, k)
        w = torch.softmax(scores / math.sqrt(d), dim=-1)
        out = torch.einsum("bhlm,bmhd->blhd", _round(w, cd), v)
        out = self.proj(out.reshape(b, l, c))
        return (x + out) / math.sqrt(2.0)


def _dropout(h: torch.Tensor, rate: float, seed: int) -> torch.Tensor:
    """``common.dropout`` with its mask drawn from a generator on ``h``'s
    device seeded with ``seed``."""
    return dropout(h, rate, step_generator(seed, h.device))


class UNetBlock(nn.Module):
    """EDM-style residual block.  ``norm1_act=False`` (no silu after
    norm1), ``resample_proj=True`` (a 1x1 skip conv on every up/down block)
    and ``attn_heads=1`` reproduce the reference network; the defaults are
    the JAX package's design (``climsim_tpu/models/unet.py:189-220``).
    ``dropout``, ``fused_gn_conv`` and ``norm_dtype`` as the module
    docstring says."""

    def __init__(self, cin: int, out_channels: int, up: bool = False,
                 down: bool = False, attention: bool = False,
                 dropout: float = 0.10, norm1_act: bool = True,
                 resample_proj: bool = False, attn_heads: int = 0,
                 fused_gn_conv: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.up, self.down, self.norm1_act = up, down, norm1_act
        self.dropout = dropout
        self.fused_gn_conv = fused_gn_conv
        self.compute_dtype = compute_dtype
        self.seed_offset = 0   # this block's place in the network
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.norm0 = GroupNorm(cin, dtype=norm_dtype, device=device)
        self.conv0 = Conv1d(cin, out_channels, 3, **kw)
        self.norm1 = GroupNorm(out_channels, dtype=norm_dtype, device=device)
        self.conv1 = Conv1d(out_channels, out_channels, 3, zero_init=True,
                            **kw)
        self.skip = (Conv1d(cin, out_channels, 1, **kw)
                     if cin != out_channels or (resample_proj
                                                and (up or down))
                     else None)
        self.Attention_0 = (Attention(out_channels, num_heads=attn_heads,
                                      norm_dtype=norm_dtype, **kw)
                            if attention else None)

    def fused_chains(self, bsz: int) -> tuple[bool, bool]:
        """Whether chain 0 (norm0 -> silu -> conv0) and chain 1 (norm1 ->
        silu -> conv1) go through the fused block at batch ``bsz``
        (``climsim_tpu/models/unet.py:237-256``)."""
        fusable = self.fused_gn_conv and bsz % 16 == 0
        return (fusable and not (self.up or self.down),
                fusable and self.norm1_act and self.dropout == 0)

    def _fused(self, x: torch.Tensor, norm: GroupNorm,
               conv: Conv1d) -> torch.Tensor:
        """GroupNorm -> silu -> conv3 through kernel 5's custom VJP, on the
        parameters of the plain path (the flax kernel layout is a view)."""
        from ..ops.unet_fused import make_trainable_fused_block

        fn = make_trainable_fused_block(norm.groups, norm.eps,
                                        self.compute_dtype)
        return fn(x.float(), norm.weight, norm.bias,
                  conv.weight.permute(2, 1, 0), conv.bias)

    def forward(self, x: torch.Tensor, seed: int | None = None
                ) -> torch.Tensor:
        fuse0, fuse1 = self.fused_chains(x.shape[0])
        if fuse0:
            h = self._fused(x, self.norm0, self.conv0)
        else:
            h = F.silu(self.norm0(x))
            if self.down:
                h, x = _down(h), _down(x)
            elif self.up:
                h, x = _up(h), _up(x)
            h = self.conv0(h)
        if fuse1:
            h = self._fused(h, self.norm1, self.conv1)
        else:
            h = self.norm1(h)
            if self.norm1_act:
                h = F.silu(h)
            if self.dropout > 0 and self.training:
                h = _dropout(h, self.dropout, seed)
            h = self.conv1(h)
        if self.skip is not None:
            x = self.skip(x)
        y = (h + x) / math.sqrt(2.0)
        if self.Attention_0 is not None:
            y = self.Attention_0(y)
        return y


def _output_prune_mask(spec: VarSpec, strato_lev_out: int) -> np.ndarray:
    mask = np.ones(spec.output_len, np.float32)
    for v in spec.output_profile_vars:
        if v == "ptend_t":
            continue
        s = spec.output_slices[v].start
        mask[s:s + strato_lev_out] = 0.0
    return mask


class ClimSimUNet(nn.Module):
    """(B, D_in) normalized columns -> (B, D_out) normalized tendencies, or
    (B, 60, num_classes) per-level logits with ``classifier=True``."""

    def __init__(self, spec: VarSpec, model_channels: int = 128,
                 channel_mult: Sequence[int] = (1, 2, 2, 2),
                 num_blocks: int = 4, attn_resolutions: Sequence[int] = (8,),
                 seq_resolution: int = 64, loc_embedding: bool = True,
                 skip_conv: bool = False, prev_2d: bool = False,
                 output_prune: bool = False, strato_lev_out: int = 15,
                 classifier: bool = False, num_classes: int = 3,
                 norm1_act: bool = True, resample_proj: bool = False,
                 attn_heads: int = 0, dropout: float = 0.0,
                 fused_gn_conv: bool = False, remat_blocks: bool = False,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 norm_dtype: torch.dtype = torch.float32, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.model_channels = model_channels
        self.channel_mult = tuple(channel_mult)
        self.num_blocks = num_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.seq_resolution = seq_resolution
        self.loc_embedding = loc_embedding
        self.skip_conv = skip_conv
        self.prev_2d = prev_2d
        self.output_prune = output_prune
        self.strato_lev_out = strato_lev_out
        self.classifier = classifier
        self.num_classes = num_classes
        self.norm1_act = norm1_act
        self.resample_proj = resample_proj
        self.attn_heads = attn_heads
        self.dropout = dropout
        self.fused_gn_conv = fused_gn_conv
        self.remat_blocks = remat_blocks
        self.compute_dtype = compute_dtype
        self.norm_dtype = norm_dtype
        self.has_icol = "icol" in spec.inputs

        n_prof = len(spec.input_profile_vars)
        n_scal = len(spec.input_scalar_vars) - self.has_icol
        if self.has_icol:
            self.emb_loc = nn.Parameter(torch.empty(
                N_LOC, LOC_DIM, dtype=torch.float32, device=device))
            with torch.no_grad():
                self.emb_loc.normal_(generator=generator)
            keep = np.ones(n_scal, np.float32)
            keep[-7:-2] = 0.0   # tm_SOLIN..tm_COSZRS (climsim_unet.py:285-287)
            self.register_buffer("scal_mask", torch.as_tensor(
                keep, device=device), persistent=False)
        c = n_prof + n_scal + (LOC_DIM if self.has_icol else 0)

        mc = model_channels
        conv = dict(compute_dtype=compute_dtype, device=device,
                    generator=generator)
        blk = dict(dropout=dropout, norm1_act=norm1_act,
                   resample_proj=resample_proj, attn_heads=attn_heads,
                   fused_gn_conv=fused_gn_conv, norm_dtype=norm_dtype,
                   **conv)
        skips = []
        for level, mult in enumerate(self.channel_mult):
            res = seq_resolution >> level
            if level == 0:
                self.add_module(f"enc{res}_conv", Conv1d(c, mc, 3, **conv))
                c = mc
            else:
                self.add_module(f"enc{res}_down",
                                UNetBlock(c, c, down=True, **blk))
            skips.append(c)
            for idx in range(num_blocks):
                self.add_module(f"enc{res}_block{idx}", UNetBlock(
                    c, mc * mult, attention=res in self.attn_resolutions,
                    **blk))
                c = mc * mult
                skips.append(c)
        if skip_conv:
            for i, s in enumerate(skips):
                self.add_module(f"skipconv{i}", IdentityConv(s, device))
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = seq_resolution >> level
            if level == len(self.channel_mult) - 1:
                self.add_module(f"dec{res}_in0",
                                UNetBlock(c, c, attention=True, **blk))
                self.add_module(f"dec{res}_in1", UNetBlock(c, c, **blk))
            else:
                self.add_module(f"dec{res}_up", UNetBlock(c, c, up=True,
                                                          **blk))
            for idx in range(num_blocks + 1):
                attn = idx == num_blocks and res in self.attn_resolutions
                self.add_module(f"dec{res}_block{idx}", UNetBlock(
                    c + skips.pop(), mc * mult, attention=attn, **blk))
                c = mc * mult

        self.n_prof_out = (num_classes if classifier
                           else len(spec.output_profile_vars))
        n_scal_out = 0 if classifier else len(spec.output_scalar_vars)
        self.out_norm = GroupNorm(c, dtype=norm_dtype, device=device)
        self.out_conv = Conv1d(c, self.n_prof_out + n_scal_out, 3,
                               zero_init=True, **conv)
        self.register_buffer("prune_mask", torch.as_tensor(
            _output_prune_mask(spec, strato_lev_out), device=device),
            persistent=False)
        blocks = [m for m in self.modules() if isinstance(m, UNetBlock)]
        for i, m in enumerate(blocks):
            m.seed_offset = i

    def assemble(self, x: torch.Tensor) -> torch.Tensor:
        """(B, D_in) flat -> (B, 64, C) channelized with the location
        embedding, 60 levels left-padded to ``seq_resolution``."""
        b = x.shape[0]
        n_prof = len(self.spec.input_profile_vars)
        prof = x[:, :n_prof * NUM_LEVELS].reshape(
            b, n_prof, NUM_LEVELS).transpose(1, 2)
        scal = x[:, n_prof * NUM_LEVELS:]
        parts = [prof]
        if self.has_icol:
            icol, scal = scal[:, -1], scal[:, :-1]
            if not self.prev_2d:
                scal = scal * self.scal_mask
        parts.append(scal[:, None, :].expand(b, NUM_LEVELS, scal.shape[-1]))
        if self.has_icol:
            # float -> int truncates toward zero, as jnp's astype(int32)
            idx = (icol.to(torch.int32) if self.loc_embedding
                   else torch.zeros_like(icol, dtype=torch.int32))
            loc = self.emb_loc[torch.clamp(idx, 0, N_LOC - 1).long()]
            parts.append(loc[:, None, :].expand(b, NUM_LEVELS, LOC_DIM))
        h = torch.cat(parts, dim=-1)
        return F.pad(h, (0, 0, self.seq_resolution - NUM_LEVELS, 0))

    def trunk(self, h: torch.Tensor,
              block: Callable[[UNetBlock, torch.Tensor], torch.Tensor],
              conv: Callable[[Conv1d, torch.Tensor], torch.Tensor]
              ) -> torch.Tensor:
        """Encoder, skips and decoder, (B, 64, C) -> (B, 64, C'), with
        ``block(module, h)`` and ``conv(module, h)`` applying each layer;
        the fused engine (``ops.unet_infer``) walks the same topology."""
        skips = []
        for level, mult in enumerate(self.channel_mult):
            res = self.seq_resolution >> level
            if level == 0:
                h = conv(getattr(self, f"enc{res}_conv"), h)
            else:
                h = block(getattr(self, f"enc{res}_down"), h)
            skips.append(h)
            for idx in range(self.num_blocks):
                h = block(getattr(self, f"enc{res}_block{idx}"), h)
                skips.append(h)
        if self.skip_conv:
            skips = [conv(getattr(self, f"skipconv{i}"), s)
                     for i, s in enumerate(skips)]
        for level, mult in reversed(list(enumerate(self.channel_mult))):
            res = self.seq_resolution >> level
            if level == len(self.channel_mult) - 1:
                h = block(getattr(self, f"dec{res}_in0"), h)
                h = block(getattr(self, f"dec{res}_in1"), h)
            else:
                h = block(getattr(self, f"dec{res}_up"), h)
            for idx in range(self.num_blocks + 1):
                h = torch.cat([h, skips.pop()], dim=-1)
                h = block(getattr(self, f"dec{res}_block{idx}"), h)
        return h

    def finish(self, h: torch.Tensor) -> torch.Tensor:
        """The out_conv's (B, 64, C_out) -> the model's output."""
        h = h[:, self.seq_resolution - NUM_LEVELS:, :]   # (B, 60, C_out)
        if self.classifier:
            if self.output_prune:
                # force class 0 in the top strato_lev_out levels with a
                # saturating logit (climsim_unet_classifier.py:396-403)
                # made on the device: a host write would copy a scalar
                # to the card every call
                forced = torch.where(
                    torch.arange(self.num_classes, device=h.device) == 0,
                    1e2, 0.0).to(h.dtype)
                strat = (torch.arange(NUM_LEVELS, device=h.device)
                         < self.strato_lev_out)[None, :, None]
                h = torch.where(strat, forced, h)
            return h
        n = self.n_prof_out
        y_prof = h[:, :, :n].transpose(1, 2).reshape(-1, n * NUM_LEVELS)
        y_scal = torch.relu(h[:, :, n:]).mean(dim=1)
        y = torch.cat([y_prof, y_scal], dim=-1)
        if self.output_prune:
            y = y * self.prune_mask
        return y

    def fused_chains(self, bsz: int = 16) -> dict:
        """{(L, C, Cout): count} of the chains that run through the fused
        block in a forward at batch ``bsz`` (shapes only, on the meta
        device)."""
        chains: dict = {}

        def block(m, h):
            b, l, _ = h.shape
            l_out = l // 2 if m.down else 2 * l if m.up else l
            cout = m.conv0.weight.shape[0]
            fuse0, fuse1 = m.fused_chains(b)
            for on, key in ((fuse0, (l, h.shape[2], cout)),
                            (fuse1, (l_out, cout, cout))):
                if on:
                    chains[key] = chains.get(key, 0) + 1
            return h.new_empty(b, l_out, cout)

        def conv(m, h):
            return h.new_empty(*h.shape[:2], m.weight.shape[0])

        first = getattr(self, f"enc{self.seq_resolution}_conv")
        self.trunk(torch.empty(bsz, self.seq_resolution,
                               first.weight.shape[1], device="meta"),
                   block, conv)
        return chains

    def forward(self, x: torch.Tensor, seed: int | None = None
                ) -> torch.Tensor:
        """``seed`` draws the dropout masks in ``train()`` mode (block i
        from ``seed + i``); it is needed there when ``dropout > 0``."""
        if self.training and self.dropout > 0 and seed is None:
            raise ValueError("dropout in train() mode needs a seed")

        def block(m, h):
            s = None if seed is None else seed + m.seed_offset
            if self.remat_blocks and torch.is_grad_enabled():
                return checkpoint(m, h, s, use_reentrant=False)
            return m(h, s)

        h = self.trunk(self.assemble(x), block, lambda m, h: m(h))
        return self.finish(self.out_conv(F.silu(self.out_norm(h))))
