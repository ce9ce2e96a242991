"""Output weighting: model space -> common energy-unit (W/m^2) metric space.

Four transformations, in the reference's exact order (climsim_utils/
data_utils.py:1112-1362):
  [0] undo output scaling (y / out_scale)
  [1] weight level-resolved variables by dp/g
  [2] weight every variable by normalized cell area
  [3] convert units to W/m^2 (cp for dT, Lv for dq, Lv*rho_h2o for precip,
      |wind tendency| for u/v in the full-variable sets)

Instead of a god-object mutating per-split state, this module exposes one
pure function over a (time, ncol, features) view, in numpy float64 on the
host (the reference eval scripts' f64 upcast).  The port's copy of
``climsim_tpu/eval/weighting.py``; ``xp`` names the array module that
computes the wind-speed tendency, as there.
"""

from __future__ import annotations

import numpy as np

from .. import physics
from ..grid import Grid
from ..norms import NormStats
from ..varspec import VarSpec, var_len


def pressure_thickness_from_inputs(inputs, spec: VarSpec, grid: Grid,
                                   stats: NormStats | None, xp=np):
    """Recover per-sample dp (N, 60) from the (possibly normalized) ps column.

    Mirrors data_utils.set_pressure_grid (data_utils.py:1037-1086): ps is
    un-normalized with its own mean/range, then dp_k = p_{k+1} - p_k with
    p = P0*hyai + hybi*ps.
    """
    ps = inputs[:, spec.ps_index]
    if stats is not None:
        i = spec.ps_index
        ps = ps * stats.inp_div[i] + stats.inp_sub[i]
    p = grid.p0 * grid.hyai[None, :] + grid.hybi[None, :] * ps[:, None]
    return p[:, 1:] - p[:, :-1]


def weight_outputs(output, spec: VarSpec, grid: Grid, dp,
                   stats: NormStats | None = None, xp=np):
    """Apply the four-stage weighting.

    Args:
      output: (N, output_len) flattened predictions/targets, N = T * ncol in
        time-major order (reference reshape, data_utils.py:1126-1161).
      dp: (N, 60) pressure thickness (see above), or None for unweighted dp.
      stats: when given, stage [0] divides by stats.out_scale.
    Returns:
      dict var -> (T, ncol, 60) or (T, ncol) weighted arrays.
    """
    n = output.shape[0]
    ncol = grid.ncol
    t = n // ncol
    assert t * ncol == n, f"N={n} not a multiple of ncol={ncol}"

    out = {}
    sl = spec.output_slices

    # wind-speed tendency for the u/v energy conversion.  NOTE the reference
    # quirk: data_utils.py:1162-1163 computes sqrt(du^2 + dv^2) from the
    # still-SCALED outputs (the reshape block precedes the unscale at :1184),
    # so the conversion factor depends on the normalization.  Replicated
    # exactly -- the published metric tables were produced this way.
    wind_conv = None
    if "ptend_u" in sl and "ptend_v" in sl:
        du = output[:, sl["ptend_u"]].reshape(t, ncol, -1)
        dv = output[:, sl["ptend_v"]].reshape(t, ncol, -1)
        wind_conv = xp.sqrt(du**2 + dv**2)

    # [0] undo scaling on the flat layout in one shot
    if stats is not None:
        output = output / stats.out_scale[None, :]

    area = grid.area_wgt  # (ncol,)
    if dp is not None:
        dp3 = dp.reshape(t, ncol, -1)

    for v in spec.outputs:
        block = output[:, sl[v]]
        conv = physics.ENERGY_CONV.get(
            "ptend_wind" if v in ("ptend_u", "ptend_v") else v)
        if var_len(v) == 1:
            arr = block.reshape(t, ncol)
            arr = arr * area[None, :]
            arr = arr * conv
        else:
            arr = block.reshape(t, ncol, -1)
            if dp is not None:
                arr = arr * dp3 / physics.GRAV
            arr = arr * area[None, :, None]
            if v in ("ptend_u", "ptend_v"):
                arr = arr * wind_conv
            else:
                arr = arr * conv
        out[v] = arr
    return out


def weight_outputs_sampled(samples, spec: VarSpec, grid: Grid, dp,
                           stats: NormStats | None = None, xp=np):
    """Weighting for stochastic predictions (N, output_len, S): applies the
    deterministic weighting per sample slice.

    Fills the reference's missing ``output_weighting_CRPS`` (the reference
    calls a method that was never implemented, data_utils.py:1418-1430).
    Wind energy conversion uses each sample's own wind tendency.
    """
    n_samp = samples.shape[-1]
    per = [weight_outputs(samples[..., s], spec, grid, dp, stats, xp)
           for s in range(n_samp)]
    return {v: xp.stack([p[v] for p in per], axis=-1) for v in per[0]}
