"""Train, eval and predict steps (the counterpart of
``climsim_tpu.train.step``).

JAX jits one step and donates the state's buffers; here the step runs
eagerly and updates the parameters and the optimizer's moments in place.
optax's ``adam(schedule)`` becomes ``torch.optim.Adam``: before each
update the group's learning rate is set to ``schedule(count) *
lr_scale``, where ``count`` is the number of updates made before this one,
as optax counts.  Both put eps (1e-8) outside the square root.

The state's ``rng`` is a host ``torch.Generator``: each step draws the
step's dropout seed from it (JAX splits its key, ``step.py:55``), so the
generator advances once a step and the card never waits for it.

Distribution (the JAX ``rules=`` argument) waits for its slice; passing
rules raises.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


def _no_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError("sharding rules are not ported yet")


@dataclass(frozen=True)
class Optimizer:
    """What optax's GradientTransformation is to the JAX step: ``init``
    builds the torch optimizer (the optimizer state) over the parameters,
    ``schedule(count)`` gives the learning rate of update ``count``, and
    ``clip``, when set, scales the gradients to that global norm first
    (optax.clip_by_global_norm)."""

    make: Callable[[list], torch.optim.Optimizer]
    schedule: Callable[[int], Any]
    clip: float | None = None

    def init(self, params) -> torch.optim.Optimizer:
        return self.make(list(params))


@dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int                  # updates made so far (optax's count)
    rng: torch.Generator       # host generator of the steps' dropout seeds
    lr_scale: float = 1.0      # host-controlled multiplier (plateau)


def create_train_state(params: torch.nn.Module, optimizer: Optimizer,
                       rng: torch.Generator, rules=None) -> TrainState:
    _no_rules(rules)
    return TrainState(params=params,
                      opt_state=optimizer.init(params.parameters()),
                      step=0, rng=rng, lr_scale=1.0)


def _clip_by_global_norm(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / |g| where the
    global norm exceeds max_norm."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)


def make_train_step(loss_fn: Callable, optimizer: Optimizer, rules=None):
    """loss_fn(model, seed, xb, yb) -> (scalar loss, aux dict), where
    ``seed`` is the step's dropout seed (an int; None in evaluation).

    Returns step(state, xb, yb) -> (state, metrics); the state is updated
    in place (where JAX donated it) and returned.  Metrics stay on the
    device: the step never waits for the card.
    """
    _no_rules(rules)

    def step(state: TrainState, xb, yb):
        model, opt = state.params, state.opt_state
        opt.zero_grad(set_to_none=True)
        seed = int(torch.randint(2**62, (), generator=state.rng))
        loss, aux = loss_fn(model, seed, xb, yb)
        loss.backward()
        if optimizer.clip is not None:
            _clip_by_global_norm(
                [p.grad for p in model.parameters() if p.grad is not None],
                optimizer.clip)
        # lr_scale multiplies the learning rate, which is the same as
        # scaling Adam's update, as the JAX step does (step.py:62); scaling
        # the gradients instead would do nothing under Adam
        lr = float(np.float32(optimizer.schedule(state.step))) * state.lr_scale
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in (("loss", loss),
                                                   *aux.items())}

    return step


def make_eval_step(loss_fn: Callable, rules=None):
    _no_rules(rules)

    def evaluate(model, xb, yb):
        with torch.no_grad():
            loss, aux = loss_fn(model, None, xb, yb)
        return {"loss": loss, **aux}

    return evaluate


def make_predict_fn(apply_fn: Callable, rules=None,
                    batch_size: int | None = None):
    """Batched full-split inference returning host numpy."""
    _no_rules(rules)

    def predict(model, inputs, bs: int | None = batch_size):
        bs = bs or inputs.shape[0]
        outs = []
        with torch.no_grad():
            for s in range(0, inputs.shape[0], bs):
                xb = torch.as_tensor(np.asarray(inputs[s:s + bs]))
                outs.append(apply_fn(model, xb).float().cpu().numpy())
        return np.concatenate(outs, axis=0)

    return predict
