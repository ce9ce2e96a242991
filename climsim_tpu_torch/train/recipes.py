"""Training recipes: model + transforms + loss + optimizer wired into train
and eval steps (the counterpart of ``climsim_tpu.train.recipes``).

Each recipe returns a ``Trainer`` whose ``train_step``/``eval_step`` take
*raw* (un-normalized) batches: the input transform (the
``fused_input_transform`` kernel on the card) and the target scaling run
inside the step.  Every recipe builds its model on the host from ``rng``
and moves it to ``device``, the card unless the caller asks for the CPU.

Ported so far: ``_common`` (flat-output models: MSE/MAE/Huber with
optional block weights, ``input_post``, the energy and water penalties,
dropout in training), ``mlp_trainer``, ``online_mlp_trainer``,
``unet_trainer``, ``classifier_labels`` and ``unet_classifier_trainer``.
The model runs in ``train()`` mode in a training step of a stochastic
loss and in ``eval()`` mode everywhere else.
"""

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from ..data import transforms as T
from ..norms import NormStats
from ..varspec import VarSpec
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


def _set_mode(model, train: bool) -> None:
    if model.training != train:
        model.train(train)


def _common(model, spec, stats, cfg, rules, rng, sample_batch,
            loss_kind="mse", block_weights=None, schedule=None,
            optimizer_name="adam", deterministic_loss=False,
            energy_weight: float = 0.0, water_weight: float = 0.0,
            grid=None, input_post: Callable | None = None, device="cuda"):
    """Wire a flat-output model already initialized (from ``rng``) on the
    host; it moves to ``device``.

    input_post: optional feature-space transform applied AFTER
    normalization (e.g. the UTLS subset for MLP v2); the energy and water
    losses read ps and LHFLX from the full normalized features.
    """
    del sample_batch  # shapes come from the spec; no init trace
    in_t_full = T.make_input_transform(spec, stats, cfg, device)
    tgt_t = T.make_target_transform(spec, stats, cfg, device)
    weight = (losses.block_weight_vector(spec, block_weights, device)
              if block_weights else None)
    base_loss = losses.LOSS_FNS[loss_kind]
    penalties = energy_weight > 0.0 or water_weight > 0.0
    if penalties:
        if grid is None:
            raise ValueError("the energy and water losses need grid=")
        out_scale, hyai, hybi = (
            torch.as_tensor(np.asarray(a), dtype=torch.float32,
                            device=device)
            for a in (stats.out_scale, grid.hyai, grid.hybi))
        ps_i = spec.ps_index
        lh_i = spec.input_slices["pbuf_LHFLX"].start
        ps_sub, ps_div = float(stats.inp_sub[ps_i]), float(stats.inp_div[ps_i])
        lh_sub, lh_div = float(stats.inp_sub[lh_i]), float(stats.inp_div[lh_i])

    def in_t(x):
        x = in_t_full(x)
        return x if input_post is None else input_post(x)

    def loss_fn(model_, seed, xb, yb):
        x_full = in_t_full(xb)
        x = x_full if input_post is None else input_post(x_full)
        y = tgt_t(yb)
        train = seed is not None and not deterministic_loss
        _set_mode(model_, train)
        pred = model_(x, seed) if train else model_(x)
        loss = base_loss(pred, y, weight)
        aux = {}
        if penalties:
            ps_raw = x_full[:, ps_i] * ps_div + ps_sub
        if energy_weight > 0.0:
            e = losses.energy_loss(pred, y, ps_raw, hyai, hybi, out_scale,
                                   spec)
            aux["energy_loss"] = e
            loss = loss + energy_weight * e
        if water_weight > 0.0:
            lh_raw = x_full[:, lh_i] * lh_div + lh_sub
            w = losses.water_loss(pred, y, ps_raw, lh_raw, hyai, hybi,
                                  out_scale, spec)
            aux["water_loss"] = w
            loss = loss + water_weight * w
        return loss, aux

    model = model.to(device)
    opt = _optimizer(schedule, optimizer_name)
    # the state's generator: the JAX recipe's fold_in(rng, 1)
    seed = _generator(rng).initial_seed()
    state = create_train_state(model, opt,
                               torch.Generator().manual_seed(seed + 1), rules)

    def apply_norm(model_, x_raw):
        _set_mode(model_, False)
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
                compute_dtype: torch.dtype = torch.bfloat16, device="cuda",
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
                       device="cuda", **kw):
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


def unet_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                 rules=None, steps_per_epoch=1000,
                 cfg: T.TransformConfig | None = None, model_kw=None,
                 loss_kind="huber", block_weights=None, energy_weight=0.0,
                 grid=None, lr=1e-3, schedule_name="cosine",
                 total_epochs=30,
                 compute_dtype: torch.dtype = torch.bfloat16,
                 device="cuda", **kw):
    """Coupling-grade U-Net recipe (``climsim_tpu/train/recipes.py:334``;
    Unet_v4/v5 trainer semantics, train_unet_h5loader.py:209-268): Adam,
    {mse|mae|huber} with optional block weights and energy/water
    penalties, a ``schedules.build`` schedule; the v5 transform is
    ``v5_online_config()``.  With ``fused_gn_conv`` in ``model_kw`` on the
    card, every fused chain's shape is checked against the kernel's limits
    before the first step, at B = 1 and at ``sample_batch``'s batch size."""
    from ..models.unet import ClimSimUNet

    model = ClimSimUNet(spec, compute_dtype=compute_dtype,
                        generator=_generator(rng), **(model_kw or {}))
    _check_fused(model, device, sample_batch)
    cfg = cfg or (T.v5_online_config() if spec.name == "v5"
                  else T.TransformConfig())
    sched = schedules.build(schedule_name, steps_per_epoch, init_lr=lr,
                            decay_epochs=total_epochs)
    return _common(model, spec, stats, cfg, rules, rng, sample_batch,
                   loss_kind=loss_kind, block_weights=block_weights,
                   schedule=sched, energy_weight=energy_weight, grid=grid,
                   deterministic_loss=(model.dropout == 0.0), device=device,
                   **kw)


def _check_fused(model, device, sample_batch=None) -> None:
    """Every fused chain against kernel 5's plan on the card, at B = 1 and
    at ``sample_batch``'s batch size (the trainer's batch)."""
    if model.fused_gn_conv and torch.device(device).type == "cuda":
        from ..ops.unet_fused import check_kernel_shapes

        batch = 1 if sample_batch is None else len(sample_batch[0])
        check_kernel_shapes(model.fused_chains(), device, batch)


def classifier_labels(x_raw, y_raw, spec: VarSpec, threshold_class1=1e-9,
                      threshold_class2=1e-11, dt=1200.0) -> torch.Tensor:
    """(B, 60) int64 labels of the v5 two-stage classifier from raw batches
    (``climsim_tpu/train/recipes.py:355``; climsim_datapip_classifier_h5.py
    :118-122): 0 where |dqn/dt| <= threshold_class2 (no tendency), 1 where
    qn + dqn * dt <= threshold_class1 (the cloud evaporates), else 2."""
    qn = x_raw[:, spec.input_slices["state_qn"]]
    dqn = y_raw[:, spec.output_slices["ptend_qn"]]
    labels = torch.where(qn + dqn * dt <= threshold_class1, 1, 2)
    return torch.where(torch.abs(dqn) <= threshold_class2, 0, labels)


def unet_classifier_trainer(spec: VarSpec, stats: NormStats, sample_batch,
                            rng, rules=None, steps_per_epoch=1000,
                            cfg: T.TransformConfig | None = None,
                            model_kw=None, lr=1e-3, threshold_class1=1e-9,
                            threshold_class2=1e-11,
                            compute_dtype: torch.dtype = torch.bfloat16,
                            device="cuda"):
    """3-class per-level cloud classifier of the v5 two-stage scheme
    (``climsim_tpu/train/recipes.py:370``; train_unet_h5loader_classifier
    .py:306-311): softmax cross-entropy over the (B * 60, 3) logits, the
    accuracy in ``aux``, Adam at a constant ``lr``."""
    from ..models.unet import ClimSimUNet

    del steps_per_epoch
    model = ClimSimUNet(spec, classifier=True, compute_dtype=compute_dtype,
                        generator=_generator(rng), **(model_kw or {}))
    _check_fused(model, device, sample_batch)
    cfg = cfg or T.v5_online_config()
    in_t = T.make_input_transform(spec, stats, cfg, device)

    def loss_fn(model_, seed, xb, yb):
        x = in_t(xb)
        labels = classifier_labels(xb.to(device), yb.to(device), spec,
                                   threshold_class1, threshold_class2)
        train = seed is not None and model_.dropout > 0
        _set_mode(model_, train)
        logits = model_(x, seed) if train else model_(x)   # (B, 60, 3)
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1))
        acc = (logits.argmax(dim=-1) == labels).float().mean()
        return ce, {"accuracy": acc}

    model = model.to(device)
    opt = _optimizer(schedules.constant(lr))
    seed = _generator(rng).initial_seed()
    state = create_train_state(model, opt,
                               torch.Generator().manual_seed(seed + 1), rules)

    def apply_prob(model_, x_raw):
        """(B, 60, 3) class probabilities."""
        _set_mode(model_, False)
        return torch.softmax(model_(in_t(x_raw.to(device))), dim=-1)

    return Trainer(model=model, state=state,
                   train_step=make_train_step(loss_fn, opt, rules),
                   eval_step=make_eval_step(loss_fn, rules),
                   predict=make_predict_fn(apply_prob, rules),
                   input_transform=in_t, apply=apply_prob)
