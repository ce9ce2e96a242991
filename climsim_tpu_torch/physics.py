"""Column physics: saturation pressure, humidity, pressure grids,
conservation.

The counterpart of ``climsim_tpu.physics``: the E3SM constants, the
tensor functions (saturation pressure, relative humidity, the hybrid-sigma
pressures, the energy and water residuals, the cloud partition the U-Net
v5 coupling wrapper applies) and the float64 numpy mirrors the synthetic
data needs.  The tensor functions keep the dtype and device of their
inputs: hybrid coefficients given as numpy arrays are cast to them (pass
tensors cast once where a function runs every step).

Semantics match the reference implementation:
  * constants      -> climsim_utils/data_utils.py:159-170 (E3SM shr_const_mod)
  * eliq/eice      -> climsim_utils/data_utils.py:18-43
  * relative humidity derivation -> climsim_utils/data_utils.py:627-638
  * liquid partition ramp        -> climsim_utils/data_utils.py:648-654
  * interface pressure / dp      -> climsim_utils/data_utils.py:1049-1052
  * energy conversions           -> climsim_utils/data_utils.py:480-494
  * energy residual              -> online_testing/baseline_models/Unet_v5/
    training/loss_energy.py:41-60
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


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """Horner evaluation with static coefficients."""
    acc = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def _bound(x: torch.Tensor, v: float | torch.Tensor) -> torch.Tensor:
    return v if isinstance(v, torch.Tensor) else x.new_full((), v)


def maximum(x: torch.Tensor, v: float | torch.Tensor) -> torch.Tensor:
    """``jnp.maximum(x, v)``: torch.maximum against a tensor bound, which
    splits the gradient at a tie 0.5 / 0.5, as JAX does (``torch.clamp``
    gives x all of it).  The values are clamp's.  The port takes JAX's
    tie convention here and in ``clip`` only."""
    return torch.maximum(x, _bound(x, v))


def clip(x: torch.Tensor, lo: float | torch.Tensor,
         hi: float | torch.Tensor) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``, with its tie gradient (see ``maximum``)."""
    return torch.minimum(maximum(x, lo), _bound(x, hi))


def eliq(t: torch.Tensor) -> torch.Tensor:
    """Liquid saturation vapor pressure [Pa] from temperature [K]."""
    dt = maximum(t - T_FREEZE, -80.0)
    return 100.0 * _polyval(_A_LIQ, dt)


def eice(t: torch.Tensor) -> torch.Tensor:
    """Ice saturation vapor pressure [Pa] from temperature [K] (piecewise)."""
    dt = t - T_FREEZE
    warm = eliq(t)
    mid = 100.0 * _polyval(_A_ICE, dt)
    dt_c = maximum(dt, _C_ICE[2])
    cold = 100.0 * (_C_ICE[3] + dt_c * (_C_ICE[4] + dt_c * _C_ICE[5]))
    return torch.where(t > _C_ICE[0], warm,
                       torch.where(t > _C_ICE[1], mid, cold))


def liquid_fraction(t: torch.Tensor) -> torch.Tensor:
    """Linear liquid/ice partition ramp: 0 below 253.16K, 1 above 273.16K."""
    return clip((t - T_ICE) / (T_FREEZE - T_ICE), 0.0, 1.0)


def saturation_pressure(t: torch.Tensor) -> torch.Tensor:
    """Blended liquid/ice saturation pressure [Pa] used for RH."""
    omega = liquid_fraction(t)
    return omega * eliq(t) + (1.0 - omega) * eice(t)


def relative_humidity(t, q, pmid) -> torch.Tensor:
    """RH = q / qvs with qvs = Rd*esat/(Rv*pmid). Shapes broadcast."""
    qvs = (RD * saturation_pressure(t)) / (RV * pmid)
    return q / qvs


def _coef(a, like: torch.Tensor) -> torch.Tensor:
    """Hybrid coefficients in the dtype and on the device of ``like``
    (no copy where they already are)."""
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def interface_pressure(ps, hyai, hybi) -> torch.Tensor:
    """Interface pressures  p_i = P0*hyai + hybi*ps.

    ps: (...,) surface pressure [Pa]; hyai/hybi: (L+1,).
    Returns (..., L+1).
    """
    return P0 * _coef(hyai, ps) + _coef(hybi, ps) * ps[..., None]


def pressure_thickness(ps, hyai, hybi) -> torch.Tensor:
    """Layer pressure thickness dp (..., L) from surface pressure."""
    p = interface_pressure(ps, hyai, hybi)
    return p[..., 1:] - p[..., :-1]


def midlevel_pressure(ps, hyam, hybm) -> torch.Tensor:
    """Mid-level pressures p_m = P0*hyam + hybm*ps, (..., L)."""
    return P0 * _coef(hyam, ps) + _coef(hybm, ps) * ps[..., None]


# --- energy-unit conversion factors (common W/m^2 metric space) --------------
# Level-resolved tendencies additionally get dp/g and area weights; this map
# holds only the per-variable unit factor.
ENERGY_CONV = {
    "ptend_t": CP,
    "ptend_q0001": LV,
    "ptend_q0002": LV,
    "ptend_q0003": LV,
    "ptend_qn": LV,
    "ptend_wind": None,  # filled dynamically with the wind-speed tendency
    "cam_out_NETSW": 1.0,
    "cam_out_FLWDS": 1.0,
    "cam_out_PRECSC": LV * RHO_H2O,
    "cam_out_PRECC": LV * RHO_H2O,
    "cam_out_SOLS": 1.0,
    "cam_out_SOLL": 1.0,
    "cam_out_SOLSD": 1.0,
    "cam_out_SOLLD": 1.0,
}


def column_energy_residual(dt_tend, dq_tend, ps, hyai, hybi,
                           dt_true=None, dq_true=None) -> torch.Tensor:
    """Column-integrated moist-static-energy tendency [W/m^2].

    residual = cp * \\int dT dp/g ... expressed as the reference's energy loss
    does (without 1/g; the loss compares pred vs truth so the constant factor
    cancels): cp*sum(dT*dp) + Lv*sum(dq*dp).

    With dt_true/dq_true given, returns pred-minus-truth residual per sample.
    """
    dp = pressure_thickness(ps, hyai, hybi)
    e = (CP * torch.sum(dt_tend * dp, dim=-1)
         + LV * torch.sum(dq_tend * dp, dim=-1))
    if dt_true is None:
        return e
    e_true = (CP * torch.sum(dt_true * dp, dim=-1)
              + LV * torch.sum(dq_true * dp, dim=-1))
    return e - e_true


def column_water_residual(dq_tends, ps, hyai, hybi, precc, precsc,
                          lhflx) -> torch.Tensor:
    """Water conservation residual per column [kg/m^2/s]:

    sum over water species of \\int dq dp/g  should equal  E - P
    (evaporation = LHFLX/Lv, precipitation = (PRECC)*rho_h2o, PRECC in m/s).
    Mirrors the check in demo_notebooks/water_conservation.ipynb.
    dq_tends: iterable of (..., L) tendencies (qv, qc, qi or qv, qn).
    """
    dp = pressure_thickness(ps, hyai, hybi)
    col = sum(torch.sum(dq * dp, dim=-1) for dq in dq_tends) / GRAV
    evap = lhflx / LV
    precip = precc * RHO_H2O
    return col - (evap - precip)


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
