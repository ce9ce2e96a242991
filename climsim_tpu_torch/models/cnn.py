"""ResNet-style 1D CNN over the 60-level vertical column (the counterpart
of ``climsim_tpu.models.cnn``).

Reference: baseline_models/CNN/training/hpo_train.py:124-236 -- 12 residual
blocks of two same-padded k=3 Conv1D layers (406 channels, relu, dropout
0.175) with a 1x1-conv projected residual, then a 1x1 conv head (ELU) and
the linear / positive per-level output split.

Layout: activations are channels-last, (B, 60, C), as in the JAX package
and the port's U-Net; a conv weight is torch's (Cout, Cin, K), where flax
keeps (K, Cin, Cout).  Each conv is flax ``nn.Conv(dtype=compute_dtype)``
cast for cast (``models.unet.Conv1d``): x, the kernel and the bias
rounded to bf16, the product summed in float32 and rounded to bf16, the
bias added in bf16, then the result widened to ``out_dtype``.  ``Dense``
adds its bias in float32 instead; ``compute_dtype=torch.float32`` is the
exact-parity path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..varspec import VarSpec
from . import unet
from .common import ACTIVATIONS, dropout, lecun_normal_, out_dtype, \
    step_generator


class Conv1d(unet.Conv1d):
    """flax ``nn.Conv`` with its defaults: a lecun-normal kernel (fan-in
    Cin * K) and a constant bias, the result widened to ``out_dtype``."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 bias_init_value: float = 0.0, device=None,
                 generator: torch.Generator | None = None):
        super().__init__(cin, features, kernel, compute_dtype=compute_dtype,
                         device=device)
        lecun_normal_(self.weight, cin * kernel, generator)
        with torch.no_grad():
            self.bias.fill_(bias_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(out_dtype(self.compute_dtype))


class ResBlock(nn.Module):
    """conv -> act -> dropout -> conv -> act -> dropout, plus a 1x1
    projection of the input: ``conv0``, ``conv1`` and ``res`` (flax's
    ``Conv1d_0``, ``Conv1d_1``, ``Conv1d_2``)."""

    def __init__(self, cin: int, features: int, kernel: int = 3,
                 dropout: float = 0.175, activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.dropout = dropout
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.conv0 = Conv1d(cin, features, kernel, **kw)
        self.conv1 = Conv1d(features, features, kernel, **kw)
        self.res = Conv1d(cin, features, 1, **kw)

    def forward(self, x: torch.Tensor,
                gen: torch.Generator | None = None) -> torch.Tensor:
        h = self.act(self.conv0(x))
        if gen is not None and self.dropout > 0:
            h = dropout(h, self.dropout, gen)
        h = self.act(self.conv1(h))
        if gen is not None and self.dropout > 0:
            h = dropout(h, self.dropout, gen)
        return h + self.res(x)


class ClimSimCNN(nn.Module):
    """Input and output are channelized views (``data.transforms.
    channelize_input``), (B, 60, C_in) -> (B, 60, C_out).

    ``scalar_head``: "softplus" (the JAX package's default, a bias
    initialized at 0.5) or "relu" (the reference's exact head,
    hpo_train.py:197).  Submodules ``blocks.i``, ``head``, ``lin`` and
    ``pos`` (flax's ``ResBlock_i``, ``Conv1d_0``, ``Conv1d_1`` and
    ``Conv1d_2``).  ``forward(x, seed)`` drops units in ``train()`` mode,
    every mask drawn in turn from one generator seeded with ``seed``."""

    def __init__(self, spec: VarSpec, depth: int = 12, channels: int = 406,
                 kernel: int = 3, dropout: float = 0.175,
                 activation: str = "relu", scalar_head: str = "softplus",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        if scalar_head not in ("softplus", "relu"):
            raise ValueError(f"scalar_head {scalar_head!r}: softplus or "
                             "relu")
        self.spec = spec
        self.dropout = dropout
        self.scalar_head = scalar_head
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        c_in = len(spec.inputs)
        n_prof = len(spec.output_profile_vars)
        n_scal = len(spec.output_scalar_vars)
        self.blocks = nn.ModuleList(
            ResBlock(c_in if i == 0 else channels, channels, kernel,
                     dropout, activation, **kw) for i in range(depth))
        self.head = Conv1d(channels, n_prof + n_scal, 1, **kw)
        self.lin = Conv1d(n_prof + n_scal, n_prof, 1, **kw)
        self.pos = Conv1d(n_prof + n_scal, n_scal, 1,
                          bias_init_value=0.5 if scalar_head == "softplus"
                          else 0.0, **kw)

    def forward(self, x_ch: torch.Tensor,
                seed: int | None = None) -> torch.Tensor:
        gen = (step_generator(seed, x_ch.device)
               if self.training and self.dropout > 0 and seed is not None
               else None)
        h = x_ch
        for block in self.blocks:
            h = block(h, gen)
        h = F.elu(self.head(h))
        rel = self.pos(h)
        rel = torch.relu(rel) if self.scalar_head == "relu" else F.softplus(
            rel)
        return torch.cat([self.lin(h), rel], dim=-1)
