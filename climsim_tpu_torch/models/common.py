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
for convolutions is TF32).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


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
        # flax variance_scaling(1, fan_in, truncated_normal): the std of a
        # unit normal truncated to [-2, 2] is 0.8796...
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, std=std, a=-2 * std,
                                  b=2 * std, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, od = self.compute_dtype, out_dtype(self.compute_dtype)
        y = x.to(cd).to(od) @ self.weight.to(cd).to(od).t()
        return (y + self.bias.to(od)).to(cd)


class MLPTrunk(nn.Module):
    """Stack of Dense + activation.

    The reference's optional LayerNorm and dropout (the HSR/cVAE blocks)
    are not ported yet: asking for them raises rather than training
    another network.
    """

    def __init__(self, in_features: int, hidden: Sequence[int],
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None,
                 layernorm: bool = False, dropout: float = 0.0):
        super().__init__()
        if layernorm or dropout:
            raise NotImplementedError(
                "MLPTrunk: layernorm and dropout are not ported yet")
        self.act = ACTIVATIONS[activation]
        widths = [in_features, *hidden]
        self.layers = nn.ModuleList(
            Dense(i, o, compute_dtype, device, generator)
            for i, o in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = self.act(layer(x))
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
