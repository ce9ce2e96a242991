"""Training losses (the counterpart of ``climsim_tpu.train.losses``).

Ported so far: mse/mae/huber with optional per-variable block weights
(train_unet_h5loader.py:237-268) and ``block_weight_vector``.  The CNN's
channel-adjusted loss, the energy and water penalties, and the HSR and
cVAE losses come with their models.
"""

from __future__ import annotations

import numpy as np
import torch

from climsim_tpu.varspec import VarSpec, var_len


def block_weight_vector(spec: VarSpec, weights: dict[str, float],
                        device="cpu") -> torch.Tensor:
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
