"""Training recipes: model + transforms + loss + optimizer wired into train
and eval steps (the counterpart of ``climsim_tpu.train.recipes``).

Each recipe returns a ``Trainer`` whose ``train_step``/``eval_step`` take
*raw* (un-normalized) batches: the input transform (the
``fused_input_transform`` kernel on the card) and the target scaling run
inside the step.  Every recipe builds its model on the host from ``rng``
and moves it to ``device``, the card unless the caller asks for the CPU.

All of them: ``_common`` (flat-output models: MSE/MAE/Huber with
optional block weights, ``input_post``, the energy and water penalties,
dropout in training), ``mlp_trainer``, ``mlp_v2_trainer``, ``ed_trainer``,
``online_mlp_trainer``, ``cnn_trainer``, ``hsr_trainer`` (with its
``stage2_step``), ``cvae_trainer``, ``unet_trainer``,
``classifier_labels`` and ``unet_classifier_trainer``; the RPN ensemble's
is ``train.rpn_recipe``.  The model runs in ``train()`` mode in a training
step of a stochastic loss and in ``eval()`` mode everywhere else.  The
JAX CNN recipe's cheaper ``rbg`` dropout generator (a TPU choice,
``climsim_tpu/train/recipes.py:181-193``) has no counterpart: every
recipe draws its masks from the step's seed on the device.
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
from ..models.common import step_generator
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
    stage2_step: Callable | None = None   # HSR: the NLL stage's step
    # the step's parts, for another step over them (step_shardmap's);
    # set by the flat-output recipes (_common)
    loss_fn: Callable | None = None
    optimizer: Optimizer | None = None


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


class _OptaxRAdam(torch.optim.Optimizer):
    """optax.radam, which torch's RAdam is not: optax rectifies where
    rho_t >= 5 (torch: > 5) and adds eps to the root of the bias-corrected
    nu (torch: to the root of the raw nu, scaled by sqrt(1 - b2^t) after).
    mu and nu are Adam's moments; with mu_hat = mu / (1 - b1^t) and nu_hat
    = nu / (1 - b2^t), the update is r_t * mu_hat / (sqrt(nu_hat) + eps)
    where rho_t >= 5, else mu_hat, times -lr."""

    def __init__(self, params, lr=1e-3, b1=0.9, b2=0.999, eps=1e-8,
                 threshold=5.0):
        super().__init__(params, {"lr": lr, "b1": b1, "b2": b2, "eps": eps,
                                  "threshold": threshold})

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["b1"], group["b2"]
            ro_inf = 2.0 / (1.0 - b2) - 1.0
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st.update(count=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                st["count"] += 1
                t = st["count"]
                st["mu"].mul_(b1).add_(p.grad, alpha=1 - b1)
                st["nu"].mul_(b2).addcmul_(p.grad, p.grad, value=1 - b2)
                mu_hat = st["mu"] / float(np.float32(1 - b1 ** t))
                ro = ro_inf - 2 * t * b2 ** t / (1 - b2 ** t)
                if ro >= group["threshold"]:
                    r = float(np.sqrt((ro - 4.0) * (ro - 2.0) * ro_inf / (
                        (ro_inf - 4.0) * (ro_inf - 2.0) * ro)))
                    nu_hat = st["nu"] / float(np.float32(1 - b2 ** t))
                    mu_hat = r * mu_hat / (torch.sqrt(nu_hat) + group["eps"])
                p.add_(mu_hat, alpha=-group["lr"])


_OPTIMIZERS = {
    # optax's defaults: betas (0.9, 0.999), eps 1e-8 outside the root
    "adam": lambda ps: torch.optim.Adam(ps, lr=0.0, betas=(0.9, 0.999),
                                        eps=1e-8),
    "adamw": lambda ps: torch.optim.AdamW(ps, lr=0.0, betas=(0.9, 0.999),
                                          eps=1e-8, weight_decay=1e-4),
    "sgd": lambda ps: torch.optim.SGD(ps, lr=0.0),
    "rmsprop": lambda ps: _OptaxRMSprop(ps, lr=0.0),
    "radam": lambda ps: _OptaxRAdam(ps, lr=0.0),
}


def _optimizer(schedule, optimizer_name: str = "adam",
               clip: float | None = None) -> Optimizer:
    if optimizer_name not in _OPTIMIZERS:
        raise KeyError(f"optimizer {optimizer_name!r}: have "
                       f"{sorted(_OPTIMIZERS)}")
    return Optimizer(_OPTIMIZERS[optimizer_name], schedule, clip)


def _generator(rng) -> torch.Generator:
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))


def _state(model, opt: Optimizer, rng, rules) -> TrainState:
    """The train state, its generator of step seeds seeded with ``rng``'s
    seed + 1 (the JAX recipes' fold_in(rng, 1))."""
    seed = _generator(rng).initial_seed()
    return create_train_state(model, opt,
                              torch.Generator().manual_seed(seed + 1), rules)


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
    state = _state(model, opt, rng, rules)

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
        loss_fn=loss_fn,
        optimizer=opt,
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


def mlp_v2_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                   rules=None, hidden=(768, 640, 512, 640, 640),
                   activation="relu", steps_per_epoch=1000,
                   cfg: T.TransformConfig | None = None, utls_lo: int = 5,
                   utls_hi: int = 21,
                   compute_dtype: torch.dtype = torch.bfloat16,
                   device="cuda", **kw):
    """MLP v2 baseline: v2 features with ozone/CH4/N2O cut to the UTLS
    levels [utls_lo, utls_hi) -> 425 inputs -> 368 outputs, v1's cyclic-LR
    MSE recipe (hpo_baseline_v2.py:58-60,154-177).  The subset runs after
    normalization, so raw batches keep the full v2 layout."""
    from ..models import ClimSimMLP

    idx = T.utls_feature_indices(spec, lo=utls_lo, hi=utls_hi)
    model = ClimSimMLP(spec, hidden=tuple(hidden), activation=activation,
                       compute_dtype=compute_dtype,
                       generator=_generator(rng), in_features=len(idx))
    sched = schedules.cyclic_triangular2(2.5e-4, 2.5e-3, 2 * steps_per_epoch)
    return _common(model, spec, stats, cfg, rules, rng, sample_batch,
                   loss_kind="mse", schedule=sched, deterministic_loss=True,
                   input_post=T.make_subset_transform(idx, device),
                   device=device, **kw)


def ed_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
               rules=None, steps_per_epoch=1000,
               cfg: T.TransformConfig | None = None,
               compute_dtype: torch.dtype = torch.bfloat16, device="cuda",
               **kw):
    """ED: Adam 1e-4, /5 every 7 epochs (ClimSIM_ED_1_3_train.py:92-126),
    at the published widths (the JAX recipe takes no others)."""
    from ..models import EncoderDecoder

    model = EncoderDecoder(spec, compute_dtype=compute_dtype,
                           generator=_generator(rng))
    sched = schedules.step_decay(1e-4, 7 * steps_per_epoch, 0.2)
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


def cnn_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                rules=None, steps_per_epoch=1000,
                cfg: T.TransformConfig | None = None, depth=12,
                channels=406, dropout=0.175, loss_kind="mae",
                compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The CNN on the channelized view with the adjusted loss, Adam on a
    cyclic schedule (hpo_train.py:114-236)."""
    from ..models import ClimSimCNN

    model = ClimSimCNN(spec, depth=depth, channels=channels,
                       dropout=dropout, compute_dtype=compute_dtype,
                       generator=_generator(rng))
    in_t = T.make_input_transform(spec, stats, cfg, device)
    tgt_t = T.make_target_transform(spec, stats, cfg, device)
    sched = schedules.cyclic_triangular2(1e-4, 1e-3, 2 * steps_per_epoch)

    def loss_fn(model_, seed, xb, yb):
        x_ch = T.channelize_input(in_t(xb), spec)
        y_ch = T.channelize_target(tgt_t(yb), spec)
        _set_mode(model_, seed is not None)
        pred = model_(x_ch, seed)
        return losses.channel_adjusted(pred, y_ch, spec, loss_kind), {}

    model = model.to(device)
    opt = _optimizer(sched)

    def apply_norm(model_, x_raw):
        _set_mode(model_, False)
        y_ch = model_(T.channelize_input(in_t(x_raw.to(device)), spec))
        return T.dechannelize_output(y_ch, spec)

    return Trainer(model=model, state=_state(model, opt, rng, rules),
                   train_step=make_train_step(loss_fn, opt, rules),
                   eval_step=make_eval_step(loss_fn, rules),
                   predict=make_predict_fn(apply_norm, rules),
                   input_transform=in_t, apply=apply_norm)


def hsr_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                rules=None, hidden=1024, layers=4, dropout=0.0, lr=1e-4,
                steps_per_epoch=1000, cfg: T.TransformConfig | None = None,
                compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """HSR with the staged MSE -> NLL loss: ``train_step`` is the MSE
    stage's, ``stage2_step`` the NLL's (the caller switches at an epoch's
    end, after a third of the epochs); ``eval_step`` scores the NLL.
    Adam at a constant ``lr``."""
    from ..models import HSR

    del steps_per_epoch
    model = HSR(spec, hidden=hidden, layers=layers, dropout=dropout,
                compute_dtype=compute_dtype, generator=_generator(rng))
    in_t = T.make_input_transform(spec, stats, cfg, device)
    tgt_t = T.make_target_transform(spec, stats, cfg, device)

    def make_loss(mse_stage):
        def loss_fn(model_, seed, xb, yb):
            x, y = in_t(xb), tgt_t(yb)
            train = seed is not None and dropout > 0
            _set_mode(model_, train)
            mean, logprec = model_(x, seed if train else None)
            return losses.hsr_loss(mean, logprec, y, mse_stage), {}
        return loss_fn

    model = model.to(device)
    opt = _optimizer(schedules.constant(lr))

    def apply_norm(model_, x_raw):
        _set_mode(model_, False)
        return model_(in_t(x_raw.to(device)))[0]

    def sample(model_, x_raw, seed, num_samples=32):
        """(B, D_out, num_samples) from the step seed ``seed``."""
        _set_mode(model_, False)
        return model_.sample(in_t(x_raw.to(device)),
                             step_generator(seed, device), num_samples)

    # the MSE stage leaves the log-precision net without a gradient; the
    # two stages share one DDP wrapper, so both say so
    return Trainer(model=model, state=_state(model, opt, rng, rules),
                   train_step=make_train_step(make_loss(True), opt, rules,
                                              unused_parameters=True),
                   eval_step=make_eval_step(make_loss(False), rules),
                   predict=make_predict_fn(apply_norm, rules),
                   sample=sample, input_transform=in_t, apply=apply_norm,
                   stage2_step=make_train_step(make_loss(False), opt, rules,
                                               unused_parameters=True))


def _normal(seed: int | None, shape, device) -> torch.Tensor:
    """A cVAE step's unit normal noise: from the step's seed on the device
    in training; from a fixed seed (0) on the host in evaluation, so that
    the card and the CPU score alike (the JAX recipe's fixed PRNGKey(0),
    ``climsim_tpu/train/recipes.py:302-303``: the same semantics, other
    values)."""
    if seed is None:
        return torch.randn(shape, generator=torch.Generator().manual_seed(
            0)).to(device)
    return torch.randn(shape, generator=step_generator(seed, device),
                       device=device)


def cvae_trainer(spec: VarSpec, stats: NormStats, sample_batch, rng,
                 rules=None, latent=8, hidden=512, layers=2, beta=0.01,
                 lr=1e-4, steps_per_epoch=1000,
                 cfg: T.TransformConfig | None = None,
                 compute_dtype: torch.dtype = torch.bfloat16, device="cuda"):
    """The cVAE on the beta-weighted ELBO (``losses.cvae_loss``, the KL in
    ``aux``), Adam at a constant ``lr``; training and evaluation both
    sample z (``_normal``).  ``apply`` decodes z = 0."""
    from ..models import CVAE

    del steps_per_epoch
    model = CVAE(spec, latent=latent, hidden=hidden, layers=layers,
                 compute_dtype=compute_dtype, generator=_generator(rng))
    in_t = T.make_input_transform(spec, stats, cfg, device)
    tgt_t = T.make_target_transform(spec, stats, cfg, device)

    def loss_fn(model_, seed, xb, yb):
        x, y = in_t(xb), tgt_t(yb)
        _set_mode(model_, False)
        eps = _normal(seed, (x.shape[0], latent), device)
        y_mean, y_std, kl = model_(y, x, eps)
        return losses.cvae_loss(y_mean, y_std, kl, y, beta), {"kl": kl}

    model = model.to(device)
    opt = _optimizer(schedules.constant(lr))

    def apply_norm(model_, x_raw):
        _set_mode(model_, False)
        x = in_t(x_raw.to(device))
        return model_.decode(x.new_zeros(x.shape[0], latent), x)[0]

    def sample(model_, x_raw, seed, num_samples=32):
        """(B, D_out, num_samples) from the step seed ``seed``."""
        _set_mode(model_, False)
        return model_.sample(in_t(x_raw.to(device)),
                             step_generator(seed, device), num_samples)

    return Trainer(model=model, state=_state(model, opt, rng, rules),
                   train_step=make_train_step(loss_fn, opt, rules),
                   eval_step=make_eval_step(loss_fn, rules),
                   predict=make_predict_fn(apply_norm, rules),
                   sample=sample, input_transform=in_t, apply=apply_norm)


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
    state = _state(model, opt, rng, rules)

    def apply_prob(model_, x_raw):
        """(B, 60, 3) class probabilities."""
        _set_mode(model_, False)
        return torch.softmax(model_(in_t(x_raw.to(device))), dim=-1)

    return Trainer(model=model, state=state,
                   train_step=make_train_step(loss_fn, opt, rules),
                   eval_step=make_eval_step(loss_fn, rules),
                   predict=make_predict_fn(apply_prob, rules),
                   input_transform=in_t, apply=apply_prob)
