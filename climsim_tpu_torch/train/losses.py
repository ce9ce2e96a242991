"""Training losses (the counterpart of ``climsim_tpu.train.losses``).

All of them: mse/mae/huber with optional per-variable block weights
(train_unet_h5loader.py:237-268), ``block_weight_vector``, the CNN's
channel-adjusted loss (hpo_train.py:114-122), the column energy and water
penalties of the U-Net trainers (``energy_loss``, ``water_loss``), the
staged HSR loss (hsr.py:128-134) and the cVAE's ELBO (cvae.py:187-199).
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import CP, GRAV, LV, RHO_H2O, pressure_thickness
from ..varspec import VarSpec, var_len


def block_weight_vector(spec: VarSpec, weights: dict[str, float],
                        device="cuda") -> torch.Tensor:
    """Expand {var or group: weight} into a per-feature float32 vector.

    Groups: '2d' covers all surface scalars (the reference's wd_2d,
    train_unet_h5loader.py:243-252); a variable's own entry wins."""
    w = np.ones(spec.output_len, dtype=np.float32)
    for v in spec.outputs:
        key = "2d" if var_len(v) == 1 else v
        if key in weights:
            w[spec.output_slices[v]] = weights[key]
        if v in weights:
            w[spec.output_slices[v]] = weights[v]
    return torch.as_tensor(w, device=device)


def _mean(e, weight):
    return torch.mean(e * weight if weight is not None else e)


def mse(pred, target, weight=None):
    return _mean((pred - target) ** 2, weight)


def mae(pred, target, weight=None):
    return _mean(torch.abs(pred - target), weight)


def huber(pred, target, weight=None, delta: float = 1.0):
    err = pred - target
    a = torch.abs(err)
    e = torch.where(a <= delta, 0.5 * err**2, delta * (a - 0.5 * delta))
    return _mean(e, weight)


LOSS_FNS = {"mse": mse, "mae": mae, "huber": huber}


def channel_adjusted(pred_ch, target_ch, spec: VarSpec, kind: str = "mae"):
    """The CNN's loss on the (B, 60, C) view: the profile channels' mean
    error weighted by their share of the flat output, the scalar channels'
    by theirs (hpo_train.py:114-122)."""
    n_prof = len(spec.output_profile_vars)
    d = spec.output_len
    err = (torch.abs(pred_ch - target_ch) if kind == "mae"
           else (pred_ch - target_ch) ** 2)
    w_prof = n_prof * 60 / d
    w_scal = (d - n_prof * 60) / d
    return (torch.mean(err[:, :, :n_prof]) * w_prof
            + torch.mean(err[:, :, n_prof:]) * w_scal)


def hsr_loss(mean, logprec, target, mse_stage: bool):
    """Stage 1 (the first third of training): MSE on the mean.  Stage 2:
    the Gaussian NLL prec * (y - mu)^2 - log(prec) (hsr.py:128-134)."""
    if mse_stage:
        return torch.mean((target - mean) ** 2)
    return torch.mean(torch.exp(logprec) * (target - mean) ** 2 - logprec)


def cvae_loss(y_mean, y_std, kl, target, beta: float = 0.01):
    """The reference's ELBO (cvae.py:193), which divides the squared error
    by std, not std^2: kept as it is."""
    recon = torch.mean(0.5 * (target - y_mean) ** 2 / y_std
                       + torch.log(y_std))
    return recon + beta * kl


def energy_loss(pred, target, ps, hyai, hybi, out_scale, spec: VarSpec):
    """Squared mismatch of the column-integrated moist static energy
    tendency between prediction and truth, in raw units (the dT and dq
    blocks un-scaled): ``climsim_tpu/train/losses.py:67``
    (loss_energy.py:41-60)."""
    sl_t = spec.output_slices["ptend_t"]
    sl_q = spec.output_slices["ptend_q0001"]
    dp = pressure_thickness(ps, hyai, hybi)

    def energy(y):
        return (CP * torch.sum(y[:, sl_t] / out_scale[sl_t] * dp, dim=1)
                + LV * torch.sum(y[:, sl_q] / out_scale[sl_q] * dp, dim=1))

    return torch.mean((energy(pred) - energy(target)) ** 2)


def water_loss(pred, target, ps, lhflx, hyai, hybi, out_scale,
               spec: VarSpec):
    """Squared mismatch of the column water budget between prediction and
    truth: the moisture tendencies integrated over dp / g plus PRECC times
    the density of water, in kg/m^2/s (``climsim_tpu/train/losses.py:103``;
    LHFLX drives both sides alike and cancels, so it is not read)."""
    del lhflx
    q_vars = [v for v in ("ptend_q0001", "ptend_q0002", "ptend_q0003",
                          "ptend_qn") if v in spec.output_slices]
    dp = pressure_thickness(ps, hyai, hybi)
    p = spec.output_slices["cam_out_PRECC"].start

    def column_water(y):
        col = 0.0
        for v in q_vars:
            sl = spec.output_slices[v]
            col = col + torch.sum((y[:, sl] / out_scale[sl]) * dp, dim=1)
        return col / GRAV + y[:, p] / out_scale[p] * RHO_H2O

    return torch.mean((column_water(pred) - column_water(target)) ** 2)
