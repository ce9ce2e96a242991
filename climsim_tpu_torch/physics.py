"""Column physics constants and the numpy saturation/humidity mirrors.

The counterpart of ``climsim_tpu.physics``: the E3SM constants, the
float64 numpy functions the synthetic data needs, and the tensor functions
the U-Net v5 coupling wrapper needs (``liquid_fraction``,
``repartition_clouds``, ``qn_exponential_transform``).  The pressure
functions and the conservation residuals come with evaluation.

Semantics match the reference implementation:
  * constants      -> climsim_utils/data_utils.py:159-170 (E3SM shr_const_mod)
  * eliq/eice      -> climsim_utils/data_utils.py:18-43
  * relative humidity derivation -> climsim_utils/data_utils.py:627-638
"""

from __future__ import annotations

import numpy as np
import torch

# --- E3SM physical constants (shr_const_mod.F90 values) ----------------------
GRAV = 9.80616        # gravity [m/s^2]
CP = 1.00464e3        # specific heat of dry air [J/kg/K]
LV = 2.501e6          # latent heat of vaporization [J/kg]
LF = 3.337e5          # latent heat of fusion [J/kg]
LSUB = LV + LF        # latent heat of sublimation [J/kg]
RHO_AIR = 101325.0 / (6.02214e26 * 1.38065e-23 / 28.966) / 273.15  # ~1.29232
RHO_H2O = 1.0e3       # density of fresh water [kg/m^3]
RD = 287.0            # gas constant, dry air [J/kg/K]
RV = 461.0            # gas constant, water vapor [J/kg/K]
P0 = 1.0e5            # reference pressure [Pa]
DT_TIMESTEP = 1200.0  # E3SM-MMF coupling timestep [s]

T_FREEZE = 273.16     # freezing point [K]
T_ICE = 253.16        # all-ice threshold [K]

NUM_LEVELS = 60

# Saturation-pressure polynomial fits (hPa as written; x100 -> Pa).
_A_LIQ = (
    -0.976195544e-15, -0.952447341e-13, 0.640689451e-10, 0.206739458e-7,
    0.302950461e-5, 0.264847430e-3, 0.142986287e-1, 0.443987641, 6.11239921,
)
_A_ICE = (
    0.252751365e-14, 0.146898966e-11, 0.385852041e-9, 0.602588177e-7,
    0.615021634e-5, 0.420895665e-3, 0.188439774e-1, 0.503160820, 6.11147274,
)
# eice piecewise-domain constants: T breakpoints and low-T quadratic.
_C_ICE = (273.15, 185.0, -100.0, 0.00763685, 0.000151069, 7.48215e-07)


def liquid_fraction(t: torch.Tensor) -> torch.Tensor:
    """Linear liquid/ice partition ramp: 0 below 253.16K, 1 above 273.16K."""
    return torch.clamp((t - T_ICE) / (T_FREEZE - T_ICE), 0.0, 1.0)


def repartition_clouds(t_before, qc_before, qi_before, dt_tend, dqn_tend,
                       dt_seconds=DT_TIMESTEP):
    """Split a combined cloud-water tendency dqn into (dqc, dqi).

    Advances T and qn over one coupling step, re-partitions the new qn by the
    liquid fraction of the *new* temperature, and emits separate liquid/ice
    tendencies.  Mirrors v5_nn_wrapper.ipynb `forward` post-processing.
    """
    qn_before = qc_before + qi_before
    t_new = t_before + dt_tend * dt_seconds
    qn_new = qn_before + dqn_tend * dt_seconds
    liq_frac = liquid_fraction(t_new)
    qc_new = liq_frac * qn_new
    qi_new = (1.0 - liq_frac) * qn_new
    dqc = (qc_new - qc_before) / dt_seconds
    dqi = (qi_new - qi_before) / dt_seconds
    return dqc, dqi


def qn_exponential_transform(qn: torch.Tensor, lbd) -> torch.Tensor:
    """Cloud-water exponential transform x -> 1 - exp(-lbd * x).

    lbd is the per-level rate 1/mean(q | q>1e-7) (online_testing/
    data_preparation/normalization/cloud_exponential_transformation.ipynb).
    """
    return 1.0 - torch.exp(-qn * lbd)


# Numpy mirrors (float64) for host-side data generation and golden tests.
def eliq_np(t):
    a = np.array(_A_LIQ)
    return 100.0 * np.polyval(a, np.maximum(-80.0, t - T_FREEZE))


def eice_np(t):
    a = np.array(_A_ICE)
    dt = t - T_FREEZE
    warm = eliq_np(t)
    mid = 100.0 * np.polyval(a, dt)
    dt_c = np.maximum(_C_ICE[2], dt)
    cold = 100.0 * (_C_ICE[3] + dt_c * (_C_ICE[4] + dt_c * _C_ICE[5]))
    return np.where(t > _C_ICE[0], warm, np.where(t > _C_ICE[1], mid, cold))


def relative_humidity_np(t, q, pmid):
    omega = np.clip((t - T_ICE) / (T_FREEZE - T_ICE), 0.0, 1.0)
    esat = omega * eliq_np(t) + (1.0 - omega) * eice_np(t)
    return q / ((RD * esat) / (RV * pmid))
