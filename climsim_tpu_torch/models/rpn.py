"""Randomized-prior-network ensemble baseline (the counterpart of
``climsim_tpu.models.rpn``).

Reference: baseline_models/RPN/training/rpn_model_v1_data.py:42-163 --
each member is (trainable MLP + frozen randomly-initialized prior MLP),
summed at the output; layers [in, 768, 640, 512, 640, 640, out] with
leaky-relu(0.15).

Where JAX vmaps one member's network over stacked parameters, the port
keeps the members' parameters stacked, (E, in, out) a layer (the flax
kernel layout with the member axis in front), and runs every layer as one
batched product under ``Dense``'s casts: operands rounded to
``compute_dtype``, float32 sums, the bias added in float32, the result
stored in ``compute_dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..varspec import VarSpec
from .common import Dense, MLPTrunk, leaky_relu15, lecun_normal_, out_dtype


class RPNNet(nn.Module):
    """One member: a leaky-relu trunk and the ``out`` Dense."""

    def __init__(self, spec: VarSpec,
                 hidden: Sequence[int] = (768, 640, 512, 640, 640),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.trunk = MLPTrunk(spec.input_len, hidden, "leakyrelu", **kw)
        self.out = Dense(hidden[-1], spec.output_len, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out(self.trunk(x)).to(out_dtype(self.compute_dtype))


class StackedMLP(nn.Module):
    """E networks of ``RPNNet``'s shape, parameters ``weights.i`` (E, in,
    out) and ``biases.i`` (E, out), each member's layer drawn as
    ``Dense`` draws it."""

    def __init__(self, ensemble_size: int, widths: Sequence[int],
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.weights = nn.ParameterList()
        self.biases = nn.ParameterList()
        for i, o in zip(widths[:-1], widths[1:]):
            w = torch.empty(ensemble_size, i, o, device=device)
            for m in range(ensemble_size):
                lecun_normal_(w[m], i, generator)
            self.weights.append(nn.Parameter(w))
            self.biases.append(nn.Parameter(torch.zeros(
                ensemble_size, o, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (E, B, D) member by member, or (B, D) shared by all ->
        (E, B, O) in ``out_dtype``."""
        cd = self.compute_dtype
        od = out_dtype(cd)
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            y = torch.matmul(x.to(cd).to(od), w.to(cd).to(od))
            x = (y + b.to(od)[:, None, :]).to(cd)
            if i < last:
                x = leaky_relu15(x)
        return x.to(od)


class RPNEnsemble(nn.Module):
    """The trainable members (``net``) and their frozen priors
    (``prior``), summed at the output."""

    def __init__(self, spec: VarSpec, ensemble_size: int = 32,
                 hidden: Sequence[int] = (768, 640, 512, 640, 640),
                 compute_dtype: torch.dtype = torch.bfloat16, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.spec = spec
        self.ensemble_size = ensemble_size
        widths = (spec.input_len, *hidden, spec.output_len)
        kw = dict(compute_dtype=compute_dtype, device=device,
                  generator=generator)
        self.net = StackedMLP(ensemble_size, widths, **kw)
        self.prior = StackedMLP(ensemble_size, widths, **kw)
        self.prior.requires_grad_(False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """All members on member-specific batches: (E, B, D) -> (E, B, O)
        (a shared (B, D) batch broadcasts)."""
        return self.net(x) + self.prior(x)

    def posterior(self, x: torch.Tensor) -> torch.Tensor:
        """All members on a shared batch: (B, D) -> samples (B, O, E)."""
        return torch.movedim(self(x), 0, -1)
