"""The port's tensor physics (climsim_tpu_torch.physics) against
climsim_tpu.physics on the same seeded numpy inputs.

Tolerances: float64 on both sides, 1e-12 relative (the ops are the same,
in the same order; XLA and torch may differ in the last place).  float32
on both sides (JAX given float32 arrays computes in float32 even with x64
on), 2e-6 relative: a few float32 roundings (2**-23 ~ 1.2e-7 each) of
the 9-term Horner chains.  The column residuals sum 60 levels and then
cancel (col - (E - P)), so they are held in units of their largest
value: 1e-12 (float64) and 2e-6 (float32) of max|residual|.
Temperatures run from 150 to 330 K, with the branch points of ``eice``
(185, 273.15 K) and of the liquid ramp (253.16, 273.16 K) included, so
all three branches of ``eice`` are reached."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import physics as JP
from climsim_tpu_torch import physics as PP
from climsim_tpu_torch.grid import load_default_grid

DTYPES = {"f64": (np.float64, 1e-12), "f32": (np.float32, 2e-6)}
EDGES = (150.0, 184.99, 185.0, 185.01, 253.16, 273.15, 273.16, 330.0)


def _inputs(dtype, b=32, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.uniform(150.0, 330.0, (b, 60))
    t[0, :len(EDGES)] = EDGES
    g = load_default_grid()
    a = dict(
        t=t, q=10.0 ** rng.uniform(-7, np.log10(2e-2), (b, 60)),
        ps=rng.uniform(6.0e4, 1.03e5, b),
        hyai=g.hyai, hybi=g.hybi, hyam=g.hyam, hybm=g.hybm,
        dt=1e-4 * rng.standard_normal((b, 60)),
        dq=1e-7 * rng.standard_normal((b, 60)),
        dt_true=1e-4 * rng.standard_normal((b, 60)),
        dq_true=1e-7 * rng.standard_normal((b, 60)),
        dqc=1e-8 * rng.standard_normal((b, 60)),
        dqi=1e-8 * rng.standard_normal((b, 60)),
        precc=1e-8 * rng.random(b), precsc=1e-9 * rng.random(b),
        lhflx=100.0 * rng.random(b))
    return {k: v.astype(dtype) for k, v in a.items()}


def _close(got: torch.Tensor, want, rtol, scaled=False):
    want = np.asarray(want)
    assert got.dtype == getattr(torch, want.dtype.name)   # no promotion
    if scaled:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=rtol * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=0)


def _both(a):
    return ({k: jnp.asarray(v) for k, v in a.items()},
            {k: torch.from_numpy(v) for k, v in a.items()})


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_saturation_and_humidity(dtype):
    npdt, rtol = DTYPES[dtype]
    j, p = _both(_inputs(npdt))
    t = np.asarray(j["t"])
    assert (t <= 185.0).any() and ((t > 185.0) & (t <= 273.15)).any() \
        and (t > 273.15).any()
    for coeffs in (JP._A_LIQ, JP._A_ICE):
        _close(PP._polyval(coeffs, p["t"] - PP.T_FREEZE),
               JP._polyval(coeffs, j["t"] - JP.T_FREEZE), rtol)
    for name in ("eliq", "eice", "saturation_pressure", "liquid_fraction"):
        _close(getattr(PP, name)(p["t"]), getattr(JP, name)(j["t"]), rtol)
    pmid = JP.midlevel_pressure(j["ps"], j["hyam"], j["hybm"])
    _close(PP.relative_humidity(p["t"], p["q"], torch.tensor(
        np.asarray(pmid))), JP.relative_humidity(j["t"], j["q"], pmid), rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pressure_functions(dtype):
    npdt, rtol = DTYPES[dtype]
    a = _inputs(npdt)
    j, p = _both(a)
    for name, coefs in (("interface_pressure", ("hyai", "hybi")),
                        ("pressure_thickness", ("hyai", "hybi")),
                        ("midlevel_pressure", ("hyam", "hybm"))):
        want = getattr(JP, name)(j["ps"], *(j[c] for c in coefs))
        _close(getattr(PP, name)(p["ps"], *(p[c] for c in coefs)), want,
               rtol)
        # numpy coefficients are cast to the surface pressure's dtype
        _close(getattr(PP, name)(p["ps"], *(np.asarray(a[c], np.float64)
                                             for c in coefs)), want, rtol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_column_residuals(dtype):
    npdt, rtol = DTYPES[dtype]
    j, p = _both(_inputs(npdt))
    args = ("ps", "hyai", "hybi")
    _close(PP.column_energy_residual(p["dt"], p["dq"], *(p[k] for k in args)),
           JP.column_energy_residual(j["dt"], j["dq"], *(j[k] for k in args)),
           rtol, scaled=True)
    _close(PP.column_energy_residual(p["dt"], p["dq"], *(p[k] for k in args),
                                     p["dt_true"], p["dq_true"]),
           JP.column_energy_residual(j["dt"], j["dq"], *(j[k] for k in args),
                                     j["dt_true"], j["dq_true"]),
           rtol, scaled=True)
    tail = ("precc", "precsc", "lhflx")
    _close(PP.column_water_residual(
        (p["dq"], p["dqc"], p["dqi"]), *(p[k] for k in args + tail)),
        JP.column_water_residual(
            (j["dq"], j["dqc"], j["dqi"]), *(j[k] for k in args + tail)),
        rtol, scaled=True)


def test_constants_and_energy_conversions():
    for name in ("GRAV", "CP", "LV", "LF", "LSUB", "RHO_AIR", "RHO_H2O", "RD",
                 "RV", "P0", "DT_TIMESTEP", "T_FREEZE", "T_ICE", "NUM_LEVELS",
                 "_A_LIQ", "_A_ICE", "_C_ICE"):
        assert getattr(PP, name) == getattr(JP, name), name
    assert PP.ENERGY_CONV == JP.ENERGY_CONV
