"""Heteroskedastic regression baseline (the counterpart of
``climsim_tpu.models.hsr``): per-output mean and log-precision from two
MLPs with LayerNorm.

Reference: baseline_models/HSR/training/hsr.py:14-81 -- each MLP is
layers x [dense -> LayerNorm -> dropout -> relu] + final dense; sampling is
mu + eps * prec^-0.5.  Training stages the loss (MSE, then the Gaussian
NLL; ``train.losses.hsr_loss``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..varspec import VarSpec
from .common import Dense, MLPTrunk, out_dtype, step_generator


class HSR(nn.Module):
    """Submodules ``mean_trunk``, ``mean_out``, ``logprec_trunk`` and
    ``logprec_out``, the flax names.  ``forward(x, seed)`` drops units in
    ``train()`` mode when ``dropout > 0``: one generator seeded with
    ``seed`` draws the mean trunk's masks, then the log-precision
    trunk's."""

    def __init__(self, spec: VarSpec, hidden: int = 1024, layers: int = 4,
                 dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.dropout = dropout
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        trunk = dict(hidden=(hidden,) * layers, activation="relu",
                     layernorm=True, dropout=dropout, **kw)
        self.mean_trunk = MLPTrunk(spec.input_len, **trunk)
        self.mean_out = Dense(hidden, spec.output_len, **kw)
        self.logprec_trunk = MLPTrunk(spec.input_len, **trunk)
        self.logprec_out = Dense(hidden, spec.output_len, **kw)

    def forward(self, x: torch.Tensor, seed: int | None = None):
        gen = (step_generator(seed, x.device)
               if self.training and self.dropout > 0 and seed is not None
               else None)
        od = out_dtype(self.compute_dtype)
        mean = self.mean_out(self.mean_trunk(x, gen)).to(od)
        logprec = self.logprec_out(self.logprec_trunk(x, gen)).to(od)
        return mean, logprec

    def sample(self, x: torch.Tensor, gen: torch.Generator,
               num_samples: int = 1) -> torch.Tensor:
        """Stochastic predictions (B, D_out, S): mean + exp(-logprec / 2)
        * eps, eps a unit normal drawn from ``gen`` (on x's device)."""
        mean, logprec = self(x)
        sigma = torch.exp(-0.5 * logprec)
        eps = torch.randn(*mean.shape, num_samples, generator=gen,
                          device=mean.device, dtype=mean.dtype)
        return mean[..., None] + sigma[..., None] * eps
