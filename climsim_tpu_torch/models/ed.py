"""Deterministic encoder-decoder MLP baseline (the counterpart of
``climsim_tpu.models.ed``).

Reference: baseline_models/ED/training/ClimSIM_ED_1_3_train.py:55-90 --
encoder 463-463-231-115-57-28-latent (relu), decoder mirror, final dense
with ELU; trained with Adam + MSE, step LR schedule (/5 every 7 epochs).
The ELU runs on the final Dense's output in ``compute_dtype`` and the
result is widened after it, the JAX module's order of casts.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..varspec import VarSpec
from .common import Dense, MLPTrunk, out_dtype


class EncoderDecoder(nn.Module):
    """Submodules ``encoder``, ``decoder`` (MLPTrunks) and ``out``, the
    flax names."""

    def __init__(self, spec: VarSpec, intermediate: int = 463,
                 latent: int = 5,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        m = intermediate
        enc = (m, m, m // 2, m // 4, m // 8, m // 16, latent)
        dec = (m // 16, m // 8, m // 4, m // 2, m, m)
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.encoder = MLPTrunk(spec.input_len, enc, "relu", **kw)
        self.decoder = MLPTrunk(latent, dec, "relu", **kw)
        self.out = Dense(m, spec.output_len, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.decoder(self.encoder(x))
        return F.elu(self.out(h)).to(out_dtype(self.compute_dtype))
