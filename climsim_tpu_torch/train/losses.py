"""Training losses (the counterpart of ``climsim_tpu.train.losses``).

Ported so far: mse/mae/huber with optional per-variable block weights
(train_unet_h5loader.py:237-268), ``block_weight_vector``, and the column
energy and water penalties of the U-Net trainers (``energy_loss``,
``water_loss``).  The CNN's channel-adjusted loss and the HSR and cVAE
losses come with their models.
"""

from __future__ import annotations

import numpy as np
import torch

from ..physics import CP, GRAV, LV, P0, RHO_H2O
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


def _layer_dp(ps, hyai, hybi):
    """(B, 60) layer pressure thicknesses from surface pressure ``ps``."""
    p_int = P0 * hyai[None, :] + hybi[None, :] * ps[:, None]
    return p_int[:, 1:] - p_int[:, :-1]


def energy_loss(pred, target, ps, hyai, hybi, out_scale, spec: VarSpec):
    """Squared mismatch of the column-integrated moist static energy
    tendency between prediction and truth, in raw units (the dT and dq
    blocks un-scaled): ``climsim_tpu/train/losses.py:67``
    (loss_energy.py:41-60)."""
    sl_t = spec.output_slices["ptend_t"]
    sl_q = spec.output_slices["ptend_q0001"]
    dp = _layer_dp(ps, hyai, hybi)

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
    dp = _layer_dp(ps, hyai, hybi)
    p = spec.output_slices["cam_out_PRECC"].start

    def column_water(y):
        col = 0.0
        for v in q_vars:
            sl = spec.output_slices[v]
            col = col + torch.sum((y[:, sl] / out_scale[sl]) * dp, dim=1)
        return col / GRAV + y[:, p] / out_scale[p] * RHO_H2O

    return torch.mean((column_water(pred) - column_water(target)) ** 2)
