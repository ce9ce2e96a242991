"""Synthetic ClimSim-like raw columns for tests, demos and the chip smoke.

The counterpart of ``climsim_tpu.data.synthetic``: the same numpy
generators, so a seed gives the same columns and targets in both packages,
bit for bit.  Value
ranges follow the dataset statistics the normalization assets encode
(T ~ 190-310 K tropospheric profile, q ~ 1e-7..2e-2 kg/kg decaying with
height, ps ~ 60-103 kPa, fluxes O(100 W/m^2)).
"""

from __future__ import annotations

import numpy as np

from ..grid import Grid
from ..physics import relative_humidity_np
from ..varspec import NUM_LEVELS, VarSpec, var_len


def _profile_for(name: str, rng, n: int, lev_frac: np.ndarray) -> np.ndarray:
    """Generate (n, 60) raw values for a level-resolved variable."""
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
    return base  # unknown profile: unit noise


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
    if name.startswith("cam_in_A"):  # albedos
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


def synthetic_inputs(spec: VarSpec, n: int, grid: Grid | None = None,
                     seed: int = 0) -> np.ndarray:
    """Raw (un-normalized) inputs (n, input_len), float32."""
    rng = np.random.default_rng(seed)
    lev_frac = (np.arange(NUM_LEVELS) + 0.5) / NUM_LEVELS
    parts = []
    cache: dict[str, np.ndarray] = {}
    for v in spec.inputs:
        if var_len(v) == NUM_LEVELS:
            arr = _profile_for(v, rng, n, lev_frac)
        else:
            arr = _scalar_for(v, rng, n)[:, None]
        cache[v] = arr
        parts.append(arr)
    # make RH consistent with T/q when all three are present
    if ("state_rh" in cache and "state_t" in cache and grid is not None
            and "state_q0001" in cache):
        ps = cache["state_ps"][:, 0]
        pmid = grid.p0 * grid.hyam[None, :] + grid.hybm[None, :] * ps[:, None]
        cache["state_rh"][:] = np.clip(relative_humidity_np(
            cache["state_t"], cache["state_q0001"], pmid), 0, 1.3)
    x = np.concatenate(parts, axis=1)
    if x.shape != (n, spec.input_len):
        raise ValueError(f"built {x.shape}, want {(n, spec.input_len)}")
    return x.astype(np.float32)


def synthetic_targets(spec: VarSpec, inputs: np.ndarray, noise: float = 0.05,
                      seed: int = 1) -> np.ndarray:
    """Deterministic nonlinear function of inputs + noise, (n, output_len).

    A fixed random two-layer map from inputs to outputs, scaled to the raw
    magnitudes of real tendencies (dT/dt ~ 1e-4 K/s, dq/dt ~ 1e-8 kg/kg/s,
    surface fluxes O(100 W/m^2)) so normalization and weighting behave like
    they do on the real dataset.
    """
    n = inputs.shape[0]
    rng = np.random.default_rng(seed)
    d_in, d_out = spec.input_len, spec.output_len
    # standardize inputs feature-wise for a well-conditioned random map
    mu = inputs.mean(0, keepdims=True)
    sd = inputs.std(0, keepdims=True) + 1e-6
    z = (inputs - mu) / sd
    w1 = rng.standard_normal((d_in, 64)) / np.sqrt(d_in)
    w2 = rng.standard_normal((64, d_out)) / np.sqrt(64)
    core = np.tanh(z @ w1) @ w2  # (n, d_out), O(1)
    core += noise * rng.standard_normal((n, d_out))

    scale = np.empty(d_out)
    for v, sl in spec.output_slices.items():
        if v == "ptend_t":
            s = 1e-4
        elif v.startswith("ptend_q"):
            s = 1e-8
        elif v in ("ptend_u", "ptend_v"):
            s = 1e-5
        elif v in ("cam_out_PRECC", "cam_out_PRECSC"):
            s = 1e-8  # m/s
        else:
            s = 100.0  # radiative fluxes W/m^2
        scale[sl] = s
    y = core * scale[None, :]
    # positive-only surface outputs: shift-then-clip keeps them learnable by
    # a linear+relu head (plain abs() would fold the feature correlation)
    for v in spec.output_scalar_vars:
        sl = spec.output_slices[v]
        y[:, sl] = np.maximum(y[:, sl] + 2.0 * scale[sl], 0.0)
    return y.astype(np.float32)


def synthetic_split(spec: VarSpec, n: int, grid: Grid | None = None,
                    seed: int = 0, noise: float = 0.05):
    """(inputs, targets) raw float32 arrays; n should be a multiple of ncol
    for time x grid reshapes used by the metrics engine."""
    x = synthetic_inputs(spec, n, grid, seed)
    y = synthetic_targets(spec, x, noise, seed + 1)
    return x, y
