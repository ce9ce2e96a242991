"""MLP emulators.

``ClimSimMLP`` -- the NeurIPS'23 offline MLP baseline (v1): a dense trunk,
a pre-head dense + activation at the full output width, and the
linear/relu split head (baseline_models/MLP/training/HPO/baseline_v1/
hpo_baseline_v1.py:64-137); the counterpart of
``climsim_tpu.models.mlp.ClimSimMLP``.

``OnlineMLP`` -- the coupling-grade plain MLP (MLP_v2rh): dense stack with
ReLU on the trailing scalar outputs and optional stratosphere output
pruning (online_testing/baseline_models/MLP_v2rh/training/mlp.py:24-68);
the counterpart of ``climsim_tpu.models.mlp.OnlineMLP``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..varspec import VarSpec, var_len
from .common import ACTIVATIONS, Dense, LinReluHead, MLPTrunk, out_dtype


def _head_split(spec: VarSpec) -> tuple[int, int]:
    """(#linear, #relu) features: level-resolved blocks are linear, surface
    scalars are non-negative -> relu.  Requires profile-before-scalar output
    layout, true for every ClimSim varspec."""
    lin = sum(var_len(v) for v in spec.output_profile_vars)
    rel = sum(var_len(v) for v in spec.output_scalar_vars)
    return lin, rel


class ClimSimMLP(nn.Module):
    """Trunk, then ``prehead`` Dense + activation, then ``LinReluHead``."""

    def __init__(self, spec: VarSpec,
                 hidden: Sequence[int] = (768, 640, 512, 640, 640),
                 activation: str = "relu",
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.act = ACTIVATIONS[activation]
        lin, rel = _head_split(spec)
        self.trunk = MLPTrunk(spec.input_len, hidden, activation,
                              compute_dtype, device, generator)
        self.prehead = Dense(hidden[-1], lin + rel, compute_dtype, device,
                             generator)
        self.head = LinReluHead(lin + rel, lin, rel, compute_dtype, device,
                                generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.act(self.prehead(self.trunk(x))))


class OnlineMLP(nn.Module):
    """Plain MLP with relu-clamped surface scalars and optional output
    stratosphere pruning."""

    def __init__(self, spec: VarSpec,
                 hidden: Sequence[int] = (1024, 1024, 1024, 1024),
                 activation: str = "relu", output_prune: bool = False,
                 strato_lev_out: int = 12,
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.compute_dtype = compute_dtype
        self.lin, rel = _head_split(spec)
        self.trunk = MLPTrunk(spec.input_len, hidden, activation,
                              compute_dtype, device, generator)
        self.out = Dense(hidden[-1], self.lin + rel, compute_dtype, device,
                         generator)
        self.output_prune = output_prune
        mask = np.ones(spec.output_len, np.float32)
        for v in spec.output_profile_vars:
            if v == "ptend_t":
                continue
            s = spec.output_slices[v].start
            mask[s:s + strato_lev_out] = 0.0
        self.register_buffer("prune_mask", torch.as_tensor(mask, device=device),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.out(self.trunk(x))
        y = torch.cat([y[:, :self.lin], torch.relu(y[:, self.lin:])],
                      dim=-1).to(out_dtype(self.compute_dtype))
        if self.output_prune:
            y = y * self.prune_mask
        return y
