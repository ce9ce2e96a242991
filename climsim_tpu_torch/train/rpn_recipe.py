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

With ``rules`` over a (data, model) mesh
(``climsim_tpu/train/rpn_recipe.py:57-60``, ``ens_sharding``) the members
split over the model axis: every rank draws the whole ensemble from the
seed on the host and keeps its contiguous E / model_size members, their
priors and their Adam state, so a member's weights never depend on where
it lives.  Each trains on its slice of its members' bootstrap batches
(``BootstrapLoader``), and the gradients and the losses go through one
all-reduce over the data group (a mean over the ranks that hold the same
members) before Adam: no member talks to another.  The step's (E,)
losses, ``eval_losses`` (E,) and ``posterior`` (B, O, E) gather the
members over the model group, so each equals the 1-process result on
every rank.  Validation runs on the whole batch on every rank.
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
    (optax's count).  Under ``rules`` the ensemble holds this rank's
    members, ``first`` the global index of the first of them, and
    ``ensemble_size`` counts them all.  Losses stay on the device: a step
    never waits for the card."""

    def __init__(self, ensemble: RPNEnsemble, schedule: Callable,
                 input_transform: Callable, target_transform: Callable,
                 rules=None, first: int = 0,
                 ensemble_size: int | None = None):
        if rules is not None:
            rules.params(ensemble)
        self.rules = rules
        self.ensemble = ensemble
        self.first = first
        self.ensemble_size = ensemble_size or ensemble.ensemble_size
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

    def _gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return t if self.rules is None else self.rules.gather_model(t, dim)

    def train_step(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """One update on (E, B, D) member-specific bootstrap batches (this
        rank's members and rows under ``rules``); returns every member's
        loss before it, (E,)."""
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
        return self._gather(losses.detach())

    def posterior(self, x_raw: torch.Tensor) -> torch.Tensor:
        """Every member on a shared raw batch: (B, D) -> (B, O, E)."""
        with torch.no_grad():
            return self._gather(self.ensemble.posterior(
                self.input_transform(x_raw)), -1)

    def eval_losses(self, xb: torch.Tensor, yb: torch.Tensor) -> torch.Tensor:
        """Each member's loss on one shared validation batch (B, D):
        (E,)."""
        with torch.no_grad():
            return self._gather(self._losses(self.input_transform(xb), yb))


def keep_members(ens: RPNEnsemble, lo: int, hi: int) -> RPNEnsemble:
    """``ens`` cut to members [lo, hi), in place: every stacked parameter
    of the trained net and of the prior keeps those rows (copies, so the
    whole ensemble's memory is freed)."""
    for p in ens.parameters():
        p.data = p.data[lo:hi].clone()
    ens.ensemble_size = hi - lo
    return ens


def rpn_trainer(spec: VarSpec, stats: NormStats, sample_x, rng,
                ensemble_size: int = 32,
                hidden=(768, 640, 512, 640, 640),
                init_lr: float = 5e-4, decay_steps: int = 1000,
                decay_rate: float = 0.99,
                cfg: T.TransformConfig | None = None,
                compute_dtype: torch.dtype = torch.bfloat16,
                rules=None, device="cuda") -> RPNTrainer:
    """``rng``: an int seed or a torch.Generator; the whole ensemble is
    drawn on the host from it, and this rank's members (all of them
    without ``rules``) are moved to ``device`` (``rules.device`` with
    ``rules``)."""
    lo, hi = 0, ensemble_size
    if rules is not None:
        device = rules.device
        lo, hi = rules.split(ensemble_size)
    del sample_x   # shapes come from the spec
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator().manual_seed(int(rng))
    ens = RPNEnsemble(spec, ensemble_size, tuple(hidden), compute_dtype,
                      generator=gen)
    if hi - lo < ensemble_size:
        keep_members(ens, lo, hi)
    return RPNTrainer(ens.to(device),
                      schedules.exponential(init_lr, decay_steps, decay_rate),
                      T.make_input_transform(spec, stats, cfg, device),
                      T.make_target_transform(spec, stats, cfg, device),
                      rules, lo, ensemble_size)
