"""RPN ensemble training (the counterpart of
``climsim_tpu.train.rpn_recipe``).

Reference pattern: rpn_model_v1_data.py:114-144 -- an Adam step over 32
members, each member on its own bootstrap batch; exponential-decay LR 5e-4
x 0.99 every 1000 steps; frozen randomized priors added at the output.

JAX vmaps one member's Adam step over the stacked parameters.  Here the
members' parameters are stacked tensors (``models.rpn.RPNEnsemble``) and
one ``torch.optim.Adam`` steps them on the sum of the members' MSE losses:
the members share no parameter, so member e's gradient is that of its own
loss, and Adam is elementwise, so the update equals E separate Adams.  The
input transform (kernel 1 on the card) runs once a step on the (E * B, D)
rows.

With ``rules`` (a model axis of size 1, ``climsim_tpu/run.py:150``) every
rank holds all the members, rank 0's after the broadcast, and trains them
on its slice of each member's bootstrap batch (``BootstrapLoader``); the
gradients and the losses go through one all-reduce (a mean over the
ranks) before Adam, so every rank takes the same update.  Validation
(``eval_losses``, ``posterior``) runs whole on every rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data import transforms as T
from ..models.rpn import RPNEnsemble
from ..norms import NormStats
from ..varspec import VarSpec
from . import schedules


class RPNTrainer:
    """The ensemble (``ensemble.net`` trained, ``ensemble.prior`` frozen),
    its Adam (``opt_state``) and ``step``, the updates made so far
    (optax's count).  Losses stay on the device: a step never waits for
    the card."""

    def __init__(self, ensemble: RPNEnsemble, schedule: Callable,
                 input_transform: Callable, target_transform: Callable,
                 rules=None):
        if rules is not None:
            rules.params(ensemble)
        self.rules = rules
        self.ensemble = ensemble
        self.opt_state = torch.optim.Adam(ensemble.net.parameters(), lr=0.0,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.schedule = schedule
        self.input_transform = input_transform
        self.target_transform = target_transform
        self.step = 0

    def _losses(self, x: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """(E,) mean squared errors of the members' predictions on x."""
        pred = self.ensemble(x)
        return torch.mean((self.target_transform(yb) - pred) ** 2,
                          dim=(-2, -1))

    def train_step(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """One update on (E, B, D) member-specific bootstrap batches;
        returns the (E,) losses before it."""
        e, b, d = xb.shape
        x = self.input_transform(xb.reshape(e * b, d)).reshape(e, b, d)
        opt = self.opt_state
        opt.zero_grad(set_to_none=True)
        losses = self._losses(x, yb)
        losses.sum().backward()
        if self.rules is not None:
            params = [p for p in self.ensemble.net.parameters()
                      if p.grad is not None]
            *grads, losses = self.rules.mean([p.grad for p in params]
                                             + [losses])
            for p, g in zip(params, grads):
                p.grad.copy_(g)
        lr = float(np.float32(self.schedule(self.step)))
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        self.step += 1
        return losses.detach()

    def posterior(self, x_raw: torch.Tensor) -> torch.Tensor:
        """Every member on a shared raw batch: (B, D) -> (B, O, E)."""
        with torch.no_grad():
            return self.ensemble.posterior(self.input_transform(x_raw))

    def eval_losses(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """Each member's loss on one shared validation batch (B, D)."""
        with torch.no_grad():
            return self._losses(self.input_transform(xb), yb)


def rpn_trainer(spec: VarSpec, stats: NormStats, sample_x, rng,
                ensemble_size: int = 32,
                hidden=(768, 640, 512, 640, 640),
                init_lr: float = 5e-4, decay_steps: int = 1000,
                decay_rate: float = 0.99,
                cfg: T.TransformConfig | None = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                rules=None, device="cuda") -> RPNTrainer:
    """``rng``: an int seed or a torch.Generator; the ensemble is drawn on
    the host from it and moved to ``device`` (``rules.device`` with
    ``rules``)."""
    if rules is not None:
        device = rules.device
    del sample_x   # shapes come from the spec
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    ens = RPNEnsemble(spec, ensemble_size, tuple(hidden), compute_dtype,
                      generator=gen).to(device)
    return RPNTrainer(ens, schedules.exponential(init_lr, decay_steps,
                                                 decay_rate),
                      T.make_input_transform(spec, stats, cfg, device),
                      T.make_target_transform(spec, stats, cfg, device),
                      rules)
