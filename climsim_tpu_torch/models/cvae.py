"""Conditional VAE baseline (the counterpart of
``climsim_tpu.models.cvae``).

Reference: baseline_models/cVAE/training/cvae.py --
  encoder [y, x] -> hidden stack -> (mu, log-std), z = mu + sigma*eps
  decoder [z, x] -> hidden stack -> (mean, std=exp(dense))
  loss = mean(0.5*(y-mean)^2/std + log(std)) + beta * KL  (cvae.py:193)
  KL = mean(sigma^2 + mu^2 - log(sigma) - 1/2)            (cvae.py:47)
Sampling draws z from the standard-normal prior and adds output noise
(cvae.py:127-151).  The JAX module runs its trunks deterministically in
every call, so ``dropout`` here sizes nothing but the trunks' setting.
"""

from __future__ import annotations

import torch
from torch import nn

from ..varspec import VarSpec
from .common import Dense, MLPTrunk, out_dtype


class CVAE(nn.Module):
    """Submodules ``enc_trunk``, ``enc_mean``, ``enc_logstd``,
    ``dec_trunk``, ``dec_mean`` and ``dec_logstd``, the flax names."""

    def __init__(self, spec: VarSpec, latent: int = 8, hidden: int = 512,
                 layers: int = 2, dropout: float = 0.0,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.latent = latent
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        trunk = dict(hidden=(hidden,) * layers, activation="relu",
                     layernorm=True, dropout=dropout, **kw)
        d_in, d_out = spec.input_len, spec.output_len
        self.enc_trunk = MLPTrunk(d_out + d_in, **trunk)
        self.enc_mean = Dense(hidden, latent, **kw)
        self.enc_logstd = Dense(hidden, latent, **kw)
        self.dec_trunk = MLPTrunk(latent + d_in, **trunk)
        self.dec_mean = Dense(hidden, d_out, **kw)
        self.dec_logstd = Dense(hidden, d_out, **kw)

    def encode(self, y: torch.Tensor, x: torch.Tensor):
        h = self.enc_trunk(torch.cat([y, x], dim=-1))
        od = out_dtype(self.compute_dtype)
        return self.enc_mean(h).to(od), self.enc_logstd(h).to(od)

    def decode(self, z: torch.Tensor, x: torch.Tensor):
        h = self.dec_trunk(torch.cat([z, x], dim=-1))
        od = out_dtype(self.compute_dtype)
        return self.dec_mean(h).to(od), torch.exp(self.dec_logstd(h).to(od))

    def forward(self, y: torch.Tensor, x: torch.Tensor,
                eps: torch.Tensor | None = None):
        """The training pass: (y_mean, y_std, kl).  z = mu + sigma * eps,
        or mu where ``eps`` is None (the JAX module's ``rng=None``)."""
        mu, logstd = self.encode(y, x)
        sigma = torch.exp(logstd)
        z = mu if eps is None else mu + sigma * eps
        kl = torch.mean(sigma ** 2 + mu ** 2 - logstd - 0.5)
        y_mean, y_std = self.decode(z, x)
        return y_mean, y_std, kl

    def sample(self, x: torch.Tensor, gen: torch.Generator,
               num_samples: int = 1, random: bool = True) -> torch.Tensor:
        """Prior-conditional samples (B, D_out, S): z from the unit normal
        prior (zeros when not ``random``), decoded, plus output noise
        std * eps; every draw from ``gen`` (on x's device)."""
        out = []
        for _ in range(num_samples):
            shape = (x.shape[0], self.latent)
            z = (torch.randn(shape, generator=gen, device=x.device)
                 if random else x.new_zeros(shape))
            mean, std = self.decode(z.to(x.dtype), x)
            if random:
                mean = mean + std * torch.randn(
                    mean.shape, generator=gen, device=x.device,
                    dtype=mean.dtype)
            out.append(mean)
        return torch.stack(out, dim=-1)
