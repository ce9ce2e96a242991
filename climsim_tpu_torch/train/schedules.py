"""Learning-rate schedules (the counterpart of ``climsim_tpu.train.schedules``).

Each schedule maps the number of updates made so far to a learning rate,
computed in float32 as the JAX package computes it (numpy float32 scalars:
host arithmetic, no device op).  ``cosine``, ``constant`` and
``exponential`` are optax's schedules, written out with optax's formulas.
Reduce-on-plateau lives in the training loop, through the state's
``lr_scale``.
"""

from __future__ import annotations

import numpy as np

_F = np.float32


def cyclic_triangular2(init_lr: float, max_lr: float, step_size: int):
    """Triangular cyclic LR whose amplitude halves every cycle (tfa
    CyclicalLearningRate, scale_fn 1/2^(cycle-1): hpo_baseline_v1.py:106-113)."""

    def schedule(step):
        step = _F(step)
        cycle = np.floor(_F(1.0) + step / _F(2.0 * step_size))
        x = np.abs(step / _F(step_size) - _F(2.0) * cycle + _F(1.0))
        scale = _F(1.0) / (_F(2.0) ** (cycle - _F(1.0)))
        return (_F(init_lr) + _F(max_lr - init_lr)
                * np.maximum(_F(0.0), _F(1.0) - x) * scale)

    return schedule


def step_decay(init_lr: float, steps_per_drop: int, factor: float = 0.2):
    """/``1/factor`` every ``steps_per_drop`` updates (ED:
    ClimSIM_ED_1_3_train.py:96-121)."""

    def schedule(step):
        k = np.floor(_F(step) / _F(steps_per_drop))
        return _F(init_lr) * (_F(factor) ** k)

    return schedule


def warmup_then(base_schedule, warmup_steps: int, init_fraction: float = 0.0,
                mode: str = "linear"):
    """Wrap any schedule with a linear/cosine/constant warmup prefix."""

    def schedule(step):
        step = _F(step)
        target = base_schedule(np.maximum(step - _F(warmup_steps), _F(0.0)))
        span = _F(max(warmup_steps, 1))
        if mode == "linear":
            frac = _F(init_fraction) + _F(1 - init_fraction) * (step / span)
        elif mode == "cos":
            frac = _F(init_fraction) + _F(1 - init_fraction) * _F(0.5) * (
                _F(1.0) - np.cos(_F(np.pi) * step / span))
        else:  # constant
            frac = _F(init_fraction)
        return _F(target * frac) if step < warmup_steps else _F(target)

    return schedule


def cosine(init_lr: float, decay_steps: int, alpha: float = 0.0,
           dtype=_F):
    """optax.cosine_decay_schedule (exponent 1), computed in ``dtype``:
    float32 as optax computes it, float64 as it does under jax_enable_x64
    (the float64 parity path)."""
    if not decay_steps > 0:
        raise ValueError(f"cosine: decay_steps {decay_steps}, want > 0")
    f = dtype

    def schedule(step):
        t = np.minimum(f(step), f(decay_steps))
        decay = f(0.5) * (f(1.0) + np.cos(f(np.pi) * t / f(decay_steps)))
        return f(init_lr) * (f(1.0 - alpha) * decay + f(alpha))

    return schedule


def constant(lr: float):
    """optax.constant_schedule."""
    return lambda step: _F(lr)


def exponential(init_lr: float, decay_steps: int, decay_rate: float):
    """optax.exponential_decay without staircase, start or end value (RPN's
    exponential decay, rpn_model_v1_data.py:87)."""
    if decay_steps <= 0 or decay_rate == 0:
        return constant(init_lr)

    def schedule(step):
        step = _F(step)
        if step <= 0:
            return _F(init_lr)
        return _F(init_lr) * np.power(_F(decay_rate), step / _F(decay_steps))

    return schedule


def build(name: str, steps_per_epoch: int, **kw):
    """Config-driven factory, as the JAX package's."""
    if name == "cyclic":
        return cyclic_triangular2(
            kw.get("init_lr", 2.5e-4), kw.get("max_lr", 2.5e-3),
            kw.get("step_size", 2 * steps_per_epoch))
    if name == "step":
        return step_decay(kw.get("init_lr", 1e-4),
                          kw.get("epochs_per_drop", 7) * steps_per_epoch,
                          kw.get("factor", 0.2))
    if name == "cosine":
        return cosine(kw.get("init_lr", 1e-3),
                      kw.get("decay_epochs", 30) * steps_per_epoch,
                      kw.get("alpha", 0.0))
    if name == "exponential":
        return exponential(kw.get("init_lr", 5e-4),
                           kw.get("decay_steps", 1000),
                           kw.get("decay_rate", 0.99))
    if name == "constant":
        return constant(kw.get("init_lr", 1e-3))
    raise ValueError(f"unknown schedule {name!r}")
