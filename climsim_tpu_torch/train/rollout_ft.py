"""Differentiable multi-step rollout fine-tuning for coupled emulators.

The counterpart of ``climsim_tpu.train.rollout_ft``.  The standard
stabilization for autoregressive emulators: after supervised 1-step
training, fine-tune on a K-step rollout loss so the model learns to damp
(rather than amplify) its own feedback errors.  The reference cannot do
this -- its host model is an external Fortran/C++ E3SM build coupled
through TorchScript (online_testing/README.md section 5), so gradients
stop at the coupling boundary.  Here the hybrid loop is a Python loop of
torch ops (``online.driver.HybridDriver.rollout``), so the rollout loss
differentiates through host dynamics, feature assembly, the wrapper's
constraints (kernels 1 and 4 under autograd on the card) and K emulator
applications end to end.  ``HybridDriver(remat=True)`` keeps one step's
activations at a time.

Loss: per-variable level-normalized MSE between the hybrid and reference
trajectories (t, q1, qn, u) over the K steps, from a batch of
on-attractor initial states.  Matches the online criterion it optimizes
for (online_testing/evaluation/monthly-online-rmse-visualization.ipynb:
weighted state RMSE vs the reference run).

The port's wrappers close over their model, so the drivers take no
``params`` and ``make_finetune_step`` takes the parameters it updates.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import recipes, schedules
from .step import Optimizer, _clip_by_global_norm

_FT_KEYS = ("t", "q1", "qn", "u")


def trajectory_stds(traj: dict) -> dict:
    """Per-level std of each fine-tune variable over a reference
    trajectory dict ((steps, cols, 60) arrays or tensors) -- the loss
    normalizer, float32 numpy as the JAX function returns it."""
    return {k: np.asarray(torch.as_tensor(traj[k]).detach().cpu())
            .reshape(-1, traj[k].shape[-1]).std(axis=0).astype(np.float32)
            + 1e-12 for k in _FT_KEYS}


def make_rollout_loss(hybrid_driver, reference_driver, k_steps: int,
                      stds: dict) -> Callable:
    """Build loss_fn(state0, start_step=0) -> scalar tensor.

    ``state0`` is a ColumnState batch of initial conditions; both drivers
    roll it forward ``k_steps`` from the absolute forcing step
    ``start_step`` (with a diurnal host forcing the K-step window must
    replay the solar phase the state lives at), and the level-normalized
    trajectory MSE is averaged over the fine-tune variables.  The
    reference runs under ``torch.no_grad()``: its gradient is exactly zero
    in the JAX function too, whose reference does not depend on
    ``params``.  The weights 1 / std are cast once to the trajectory's
    dtype and device.
    """
    inv = {k: 1.0 / np.asarray(stds[k]) for k in _FT_KEYS}
    w_by: dict = {}

    def weights(like: torch.Tensor) -> dict:
        key = (like.dtype, like.device)
        if key not in w_by:
            w_by[key] = {k: torch.as_tensor(v).to(like)
                         for k, v in inv.items()}
        return w_by[key]

    def loss_fn(state0, start_step: int = 0) -> torch.Tensor:
        _, h = hybrid_driver.rollout(state0, k_steps, start_step=start_step)
        with torch.no_grad():
            _, r = reference_driver.rollout(state0, k_steps,
                                            start_step=start_step)
        w = weights(h["t"])
        terms = [(((h[k] - r[k]) * w[k]) ** 2).mean() for k in _FT_KEYS]
        return sum(terms) / len(terms)

    return loss_fn


def make_finetune_step(hybrid_driver, reference_driver, k_steps: int,
                       stds: dict, params, learning_rate: float = 1e-4,
                       total_steps: int = 300, clip: float = 1.0):
    """Returns (step_fn, opt_state).

    step_fn(state0, start_step=0) -> loss is one fine-tune update of
    ``params`` (the hybrid's model parameters, e.g.
    ``model.parameters()``, updated in place): the K-step differentiable
    rollout loss, the global-norm clip, AdamW on a cosine schedule --
    optax's ``chain(clip_by_global_norm(clip), adamw(cosine_decay_schedule(
    learning_rate, total_steps)))`` (weight decay 1e-4, optax's default).
    Update i takes the rate of count i, from 0, as optax counts, in the
    parameters' dtype (float32, or float64 as JAX with x64).  A
    parameter the loss does not reach gets a zero gradient, so weight
    decay moves it, as in optax.  The loss it returns is the one before
    the update, detached; ``step_fn.grad_norm`` holds the update's global
    gradient norm before the clip (a device scalar), and ``p.grad`` the
    clipped gradient; ``opt_state`` is the torch optimizer.
    """
    loss_fn = make_rollout_loss(hybrid_driver, reference_driver, k_steps,
                                stds)
    params = list(params)
    # the rate in the parameters' precision: optax's float32, or float64
    # where JAX runs with x64 (the float64 parity path)
    f64 = params[0].dtype == torch.float64
    opt = Optimizer(recipes._OPTIMIZERS["adamw"],
                    schedules.cosine(learning_rate, max(total_steps, 1),
                                     dtype=np.float64 if f64 else np.float32),
                    clip)
    opt_state = opt.init(params)
    count = [0]

    def step_fn(state0, start_step: int = 0) -> torch.Tensor:
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(state0, start_step)
        loss.backward()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        step_fn.grad_norm = _clip_by_global_norm([p.grad for p in params],
                                                 opt.clip)
        lr = float(opt.schedule(count[0]))
        for group in opt_state.param_groups:
            group["lr"] = lr
        opt_state.step()
        count[0] += 1
        return loss.detach()

    return step_fn, opt_state
