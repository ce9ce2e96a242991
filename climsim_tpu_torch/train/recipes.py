"""Training recipes: model + transforms + loss + optimizer wired into train
and eval steps (the counterpart of ``climsim_tpu.train.recipes``).

Each recipe returns a ``Trainer`` whose ``train_step``/``eval_step`` take
*raw* (un-normalized) batches: the input transform (the
``fused_input_transform`` kernel on the card) and the target scaling run
inside the step.

Ported so far: ``_common`` (the deterministic flat-output path, MSE/MAE/
Huber with optional block weights and ``input_post``), ``mlp_trainer``
and ``online_mlp_trainer``.  The energy and water penalties need the
physics slice and raise until then.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from climsim_tpu.norms import NormStats
from climsim_tpu.varspec import VarSpec

from ..data import transforms as T
from . import losses, schedules
from .step import (Optimizer, TrainState, create_train_state,
                   make_eval_step, make_predict_fn, make_train_step)


@dataclass
class Trainer:
    model: Any
    state: TrainState
    train_step: Callable
    eval_step: Callable
    predict: Callable           # model, raw inputs -> normalized preds
    sample: Callable | None = None
    input_transform: Callable | None = None
    apply: Callable | None = None   # (model, x_raw) -> preds


class _OptaxRMSprop(torch.optim.Optimizer):
    """optax.rmsprop's defaults, which torch's RMSprop does not have: nu =
    decay * nu + (1 - decay) * g^2, update = g / sqrt(nu + eps) (eps
    inside the square root)."""

    def __init__(self, params, lr=1e-3, decay=0.9, eps=1e-8):
        super().__init__(params, {"lr": lr, "decay": decay, "eps": eps})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                nu = self.state[p].setdefault("nu", torch.zeros_like(p))
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.addcmul_(p.grad, torch.rsqrt(nu + group["eps"]),
                           value=-group["lr"])


_OPTIMIZERS = {
    # optax's defaults: betas (0.9, 0.999), eps 1e-8 outside the root
    "adam": lambda ps: torch.optim.Adam(ps, lr=0.0, betas=(0.9, 0.999),
                                        eps=1e-8),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=0.0, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=1e-4),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.0),
    "rmsprop": lambda ps: _OptaxRMSprop(ps, lr=0.0),
}


def _optimizer(schedule, optimizer_name: str = "adam",
               clip: float | None = None) -> Optimizer:
    if optimizer_name not in _OPTIMIZERS:
        # radam's rectification term is not written out yet
        raise NotImplementedError(f"optimizer {optimizer_name!r}: have "
                                  f"{sorted(_OPTIMIZERS)}")
    return Optimizer(_OPTIMIZERS[optimizer_name], schedule, clip)


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _common(model, spec, stats, cfg, rules, rng, sample_batch,
            loss_kind="mse", block_weights=None, schedule=None,
            optimizer_name="adam", deterministic_loss=False,
            energy_weight: float = 0.0, water_weight: float = 0.0,
            grid=None, input_post: Callable | None = None, device="cpu"):
    """Wire a deterministic flat-output model already initialized (from
    ``rng``) on the host; it moves to ``device``.

    input_post: optional feature-space transform applied AFTER
    normalization (e.g. the UTLS subset for MLP v2).
    """
    if energy_weight > 0.0 or water_weight > 0.0:
        raise NotImplementedError("the energy and water losses wait for "
                                  "the physics slice")
    del sample_batch, grid  # shapes come from the spec; no init trace
    in_t_full = T.make_input_transform(spec, stats, cfg, device)
    if input_post is None:
        in_t = in_t_full
    else:
        def in_t(x):
            return input_post(in_t_full(x))
    tgt_t = T.make_target_transform(spec, stats, cfg, device)
    weight = (losses.block_weight_vector(spec, block_weights, device)
              if block_weights else None)
    base_loss = losses.LOSS_FNS[loss_kind]
    if not deterministic_loss:
        raise NotImplementedError("stochastic losses (dropout) are not "
                                  "ported yet")

    def loss_fn(model_, gen, xb, yb):
        return base_loss(model_(in_t(xb)), tgt_t(yb), weight), {}

    model = model.to(device)
    opt = _optimizer(schedule, optimizer_name)
    # the state's generator: the JAX recipe's fold_in(rng, 1)
    seed = _generator(rng).initial_seed()
    state = create_train_state(
        model, opt, torch.Generator(device=device).manual_seed(seed + 1),
        rules)

    def apply_norm(model_, x_raw):
        return model_(in_t(x_raw.to(device)))

    return Trainer(
        model=model,
        state=state,
        train_step=make_train_step(loss_fn, opt, rules),
        eval_step=make_eval_step(loss_fn, rules),
        predict=make_predict_fn(apply_norm, rules),
        input_transform=in_t,
        apply=apply_norm,
    )


def mlp_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                rules=None, hidden=(768, 640, 512, 640, 640),
                activation="relu", steps_per_epoch=1000,
                cfg: T.TransformConfig | None = None,
                compute_dtype: torch.dtype = torch.bfloat16, device="cpu",
                **kw):
    """NeurIPS MLP baseline: cyclic LR + MSE (hpo_baseline_v1.py:106-137).

    ``rng`` is a torch.Generator or an int seed; the weights are drawn on
    the host from it.  ``compute_dtype`` is the model's (the JAX recipe
    leaves it at bf16); float32 gives the exact-parity path."""
    from ..models import ClimSimMLP

    model = ClimSimMLP(spec, hidden=tuple(hidden), activation=activation,
                       compute_dtype=compute_dtype,
                       generator=_generator(rng))
    sched = schedules.cyclic_triangular2(2.5e-4, 2.5e-3, 2 * steps_per_epoch)
    return _common(model, spec, stats, cfg, rules, rng, sample_batch,
                   loss_kind="mse", schedule=sched,
                   deterministic_loss=True, device=device, **kw)


def online_mlp_trainer(spec, stats, sample_batch, rng, rules=None,
                       hidden=(1024,) * 4, steps_per_epoch=1000, cfg=None,
                       loss_kind="mse", block_weights=None,
                       energy_weight=0.0, grid=None, lr=1e-3,
                       compute_dtype: torch.dtype = torch.bfloat16,
                       device="cpu", **kw):
    """The coupling MLP (MLP_v2rh): constant LR after half an epoch of
    linear warmup."""
    from ..models import OnlineMLP

    model = OnlineMLP(spec, hidden=tuple(hidden),
                      compute_dtype=compute_dtype, generator=_generator(rng))
    sched = schedules.warmup_then(schedules.constant(lr),
                                  steps_per_epoch // 2)
    return _common(model, spec, stats, cfg, rules, rng, sample_batch,
                   loss_kind=loss_kind, block_weights=block_weights,
                   schedule=sched, energy_weight=energy_weight, grid=grid,
                   deterministic_loss=True, device=device, **kw)
