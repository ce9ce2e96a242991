"""Shared model building blocks (torch.nn).

The counterpart of ``climsim_tpu.models.common``, with its mixed-precision
policy copied cast by cast: float32 parameters; operands rounded to
``compute_dtype``; the product accumulated in float32; the bias added in
float32; the result stored in ``compute_dtype``.  ``torch.autocast`` does
not do this, and a plain ``bf16 @ bf16`` rounds the product to bf16 before
the bias is added, so the casts are written out: the rounded operands are
widened back to float32, where their products are exact and the sum is
float32.  ``compute_dtype=torch.float32`` gives the exact-parity path.

Importing this module sets ``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: a float32 product or
convolution on the card then runs in full float32, as the reference's
does, instead of TF32 with about three decimal digits (cuDNN's default
for convolutions is TF32).  It also sets
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction`` to
False: a bf16 GEMM (``models.unet.Conv1d``'s 1x1 convolutions on the card)
then adds its split-K partial sums in float32, not in bf16.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..physics import maximum

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def out_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """Model-output / accumulation dtype for a given compute dtype: float32
    for the bf16/f32 policies, float64 when a parity test runs at
    compute_dtype=float64."""
    return torch.promote_types(torch.float32, compute_dtype)


def leaky_relu15(x):
    """LeakyReLU with the 0.15 slope used by MLP/RPN baselines."""
    return torch.where(x > 0, x, 0.15 * x)


ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "elu": F.elu,
    # flax's nn.gelu defaults to the tanh approximation
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "tanh": torch.tanh,
    "leakyrelu": leaky_relu15,
}


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> None:
    """Fill ``w`` as flax's lecun_normal does: variance_scaling(1, fan_in,
    truncated_normal), a unit normal truncated to [-2, 2] (whose std is
    0.8796...) scaled to a variance of 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                              generator=generator)


class Dense(nn.Module):
    """Linear layer with the mixed-precision policy above.

    ``weight`` is stored as nn.Linear stores it, (features, in_features);
    initialized as flax's lecun_normal (truncated normal, fan-in variance)
    with a zero bias.
    """

    def __init__(self, in_features: int, features: int,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weight = nn.Parameter(torch.empty(
            features, in_features, dtype=torch.float32, device=device))
        self.bias = nn.Parameter(torch.zeros(
            features, dtype=torch.float32, device=device))
        lecun_normal_(self.weight, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, od = self.compute_dtype, out_dtype(self.compute_dtype)
        y = x.to(cd).to(od) @ self.weight.to(cd).to(od).t()
        return (y + self.bias.to(od)).to(cd)


def dropout(h: torch.Tensor, rate: float,
            gen: torch.Generator) -> torch.Tensor:
    """flax ``nn.Dropout(rate)`` in training: each element kept with
    probability 1 - rate and scaled by 1 / (1 - rate), the mask drawn from
    ``gen``, a generator on ``h``'s device.  JAX's threefry bits are not
    reproduced: the two packages drop alike, not identically."""
    keep = torch.rand(h.shape, generator=gen, device=h.device) < 1.0 - rate
    return torch.where(keep, h / (1.0 - rate), torch.zeros_like(h))


def step_generator(seed: int, device) -> torch.Generator:
    """The generator of one step's dropout masks and sampling noise: on
    the device the tensors live on, seeded with the step's seed, so the
    card never waits for the host to draw them."""
    return torch.Generator(device=device).manual_seed(int(seed))


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon, dtype=dtype)`` over the last axis, with
    flax 0.12's ``use_fast_variance=True``: the statistics in (at least)
    float32 as E[x], E[x^2] and var = max(E[x^2] - E[x]^2, 0) (JAX's tie
    gradient at the floor), then (x - mean) * (rsqrt(var + eps) * scale) +
    bias, stored in ``dtype``.  ``torch.nn.LayerNorm`` takes the variance
    in two passes, and its results differ in the last bits.  The
    parameters keep torch's names, ``weight`` and ``bias`` (flax's
    ``scale`` and ``bias``)."""

    def __init__(self, features: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xs.mean(dim=-1, keepdim=True)
        mean2 = (xs * xs).mean(dim=-1, keepdim=True)
        var = maximum(mean2 - mean * mean, 0.0)
        y = (xs - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(torch.promote_types(y.dtype, self.dtype))


class MLPTrunk(nn.Module):
    """Stack of Dense (+ LayerNorm) (+ dropout) + activation, in the order
    of the HSR/cVAE blocks: act(dropout(LN(dense(x))))
    (baseline_models/HSR/training/hsr.py:22-33).  LayerNorm has eps 1e-5
    (torch.nn.LayerNorm's, the reference blocks') and stores its result in
    ``out_dtype(compute_dtype)``.  Dropout runs when ``forward`` is given
    a generator (``step_generator``), which the models pass in
    ``train()`` mode only.  Submodules: ``layers.i`` (Dense) and
    ``norms.i`` (LayerNorm), flax's ``Dense_i`` and ``LayerNorm_i``."""

    def __init__(self, in_features: int, hidden: Sequence[int],
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None,
                 layernorm: bool = False, dropout: float = 0.0):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dropout = dropout
        widths = [in_features, *hidden]
        self.layers = nn.ModuleList(
            Dense(i, o, compute_dtype, device, generator)
            for i, o in zip(widths[:-1], widths[1:]))
        self.norms = (nn.ModuleList(
            LayerNorm(o, dtype=out_dtype(compute_dtype), device=device)
            for o in hidden) if layernorm else None)

    def forward(self, x: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if self.norms is not None:
                x = self.norms[i](x)
            if self.dropout > 0 and gen is not None:
                x = dropout(x, self.dropout, gen)
            x = self.act(x)
        return x


class LinReluHead(nn.Module):
    """The ClimSim output head: a linear block for the level-resolved
    tendencies beside a relu block for the positive surface scalars
    (hpo_baseline_v1.py:124-128), concatenated in ``out_dtype``.  The
    submodules carry the flax names ``out_linear`` and ``out_relu``."""

    def __init__(self, in_features: int, lin_features: int,
                 relu_features: int,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.out_linear = Dense(in_features, lin_features, compute_dtype,
                                device, generator)
        self.out_relu = Dense(in_features, relu_features, compute_dtype,
                              device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.out_linear(x), torch.relu(self.out_relu(x))],
                         dim=-1).to(out_dtype(self.compute_dtype))


def param_count(model: nn.Module) -> int:
    """The number of parameters (trainable or not) of ``model``."""
    return sum(p.numel() for p in model.parameters())
