"""Synthetic ClimSim-like raw columns, the inputs of every cell.

Frozen copy of ``climsim_tpu_torch/data/synthetic.py`` at commit ad9d7d2:
the same numpy draws, so a seed gives the columns and targets the port's
own generator gives.  Value ranges follow the dataset statistics the
normalization assets encode (T ~ 190-310 K, q ~ 1e-7..2e-2 kg/kg decaying
with height, ps ~ 60-103 kPa, fluxes O(100 W/m^2)).  The v1, v4 and v5
layouts hold no ``state_rh`` beside ``state_q0001``, so the grid that the
original reads to make RH consistent with T and q is never used, and the
copy leaves it out.
"""

from __future__ import annotations

import numpy as np

from .varspec import NUM_LEVELS, Layout, var_len


def _profile_for(name: str, rng, n: int, lev_frac: np.ndarray) -> np.ndarray:
    """(n, 60) raw values of a level-resolved variable."""
    L = lev_frac[None, :]
    base = rng.standard_normal((n, NUM_LEVELS))
    if name == "state_t":
        return 300.0 - 95.0 * (1.0 - L) ** 1.2 + 3.0 * base
    if name in ("state_q0001",):
        return np.abs(2e-2 * L**3 + 1e-4 * L * np.abs(base)) + 1e-8
    if name in ("state_q0002", "state_q0003", "state_qn"):
        return np.abs(5e-5 * L**2 * np.abs(base)) * (rng.random((n, 60)) > 0.5)
    if name == "liq_partition":
        return np.clip(rng.random((n, NUM_LEVELS)), 0, 1)
    if name in ("state_u", "state_v"):
        return 10.0 * base
    if name == "pbuf_ozone":
        return np.abs(1e-6 * (1.2 - L) ** 2 + 1e-8 * base)
    if name in ("pbuf_CH4", "pbuf_N2O"):
        return np.abs(1e-6 + 1e-8 * base)
    if name == "state_rh":
        return np.clip(0.1 + 0.8 * L + 0.15 * base, 0.0, 1.3)
    if "prvphy" in name or "dyn" in name:
        scale = 1e-5 if "t" in name.split("_") else 1e-8
        return scale * base
    return base


def _scalar_for(name: str, rng, n: int) -> np.ndarray:
    u = rng.random(n)
    base = rng.standard_normal(n)
    if "ps" in name:
        return 6.0e4 + 4.3e4 * u
    if "SOLIN" in name:
        return np.maximum(0.0, 1360.0 * (u - 0.3))
    if "LHFLX" in name:
        return 80.0 + 60.0 * base
    if "SHFLX" in name:
        return 20.0 + 25.0 * base
    if "TAU" in name:
        return 0.05 * base
    if "COSZRS" in name:
        return np.clip(u * 1.4 - 0.2, 0, 1)
    if name.startswith("cam_in_A"):
        return np.clip(0.1 + 0.3 * u, 0, 1)
    if "LWUP" in name:
        return 300.0 + 80.0 * u
    if "FRAC" in name:
        return np.clip(u, 0, 1)
    if "SNOWH" in name:
        return np.abs(0.1 * base) * (u > 0.7)
    if name == "clat":
        return np.cos(np.pi * (u - 0.5))
    if name == "slat":
        return np.sin(np.pi * (u - 0.5))
    if name == "icol":
        return rng.integers(1, 385, n).astype(np.float64)
    return base


def synthetic_inputs(layout: Layout, n: int, seed: int = 0) -> np.ndarray:
    """Raw (un-normalized) inputs (n, input_len), float32."""
    rng = np.random.default_rng(seed)
    lev_frac = (np.arange(NUM_LEVELS) + 0.5) / NUM_LEVELS
    parts = []
    for v in layout.inputs:
        if var_len(v) == NUM_LEVELS:
            parts.append(_profile_for(v, rng, n, lev_frac))
        else:
            parts.append(_scalar_for(v, rng, n)[:, None])
    x = np.concatenate(parts, axis=1)
    if x.shape != (n, layout.input_len):
        raise ValueError(f"built {x.shape}, want {(n, layout.input_len)}")
    return x.astype(np.float32)


def synthetic_targets(layout: Layout, inputs: np.ndarray,
                      noise: float = 0.05, seed: int = 1) -> np.ndarray:
    """A fixed random two-layer map of the inputs plus noise, (n,
    output_len), scaled to the raw magnitudes of real tendencies."""
    n = inputs.shape[0]
    rng = np.random.default_rng(seed)
    d_in, d_out = layout.input_len, layout.output_len
    mu = inputs.mean(0, keepdims=True)
    sd = inputs.std(0, keepdims=True) + 1e-6
    z = (inputs - mu) / sd
    w1 = rng.standard_normal((d_in, 64)) / np.sqrt(d_in)
    w2 = rng.standard_normal((64, d_out)) / np.sqrt(64)
    core = np.tanh(z @ w1) @ w2
    core += noise * rng.standard_normal((n, d_out))

    scale = np.empty(d_out)
    for v, sl in layout.output_slices.items():
        if v == "ptend_t":
            s = 1e-4
        elif v.startswith("ptend_q"):
            s = 1e-8
        elif v in ("ptend_u", "ptend_v"):
            s = 1e-5
        elif v in ("cam_out_PRECC", "cam_out_PRECSC"):
            s = 1e-8
        else:
            s = 100.0
        scale[sl] = s
    y = core * scale[None, :]
    for v in layout.scalars(layout.outputs):
        sl = layout.output_slices[v]
        y[:, sl] = np.maximum(y[:, sl] + 2.0 * scale[sl], 0.0)
    return y.astype(np.float32)


def synthetic_split(layout: Layout, n: int, seed: int = 0,
                    noise: float = 0.05):
    """(inputs, targets) raw float32 arrays."""
    x = synthetic_inputs(layout, n, seed)
    return x, synthetic_targets(layout, x, noise, seed + 1)
