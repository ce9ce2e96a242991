"""One-call offline scoring: the main_figure_generation pipeline as a
function.

Reference flow (evaluation/main_figure_generation.ipynb + quickstart):
load split -> set_pressure_grid -> reweight target/preds -> metrics tables.
Here: ``offline_score(...)`` does the whole chain in float64 on host, with
optional stochastic sample predictions for CRPS.  The port's copy of
``climsim_tpu/eval/scoring.py``.
"""

from __future__ import annotations

import numpy as np

from ..grid import Grid
from ..norms import NormStats
from ..varspec import VarSpec
from .metrics import metrics_per_index, metrics_table
from .weighting import (pressure_thickness_from_inputs, weight_outputs,
                        weight_outputs_sampled)


def offline_score(spec: VarSpec, grid: Grid, stats: NormStats | None,
                  inputs: np.ndarray, target: np.ndarray,
                  preds: dict[str, np.ndarray],
                  samplepreds: dict[str, np.ndarray] | None = None,
                  metric_names=("MAE", "RMSE", "R2", "bias"),
                  inputs_normalized: bool = True):
    """Score model predictions in the common W/m^2 metric space.

    Args:
      inputs: (N, D_in) split inputs (normalized iff inputs_normalized and
        stats given) -- used only to recover per-sample surface pressure.
      target: (N, D_out) normalized targets (or raw if stats is None).
      preds: model name -> (N, D_out) predictions in the same space.
      samplepreds: model name -> (N, D_out, S) stochastic samples (CRPS).

    Returns {model: per-variable metric table}, {model: per-index vectors}.
    """
    dp = pressure_thickness_from_inputs(
        inputs.astype(np.float64), spec, grid,
        stats if inputs_normalized else None)
    tw = weight_outputs(target.astype(np.float64), spec, grid, dp, stats)
    tables, per_index = {}, {}
    for name, p in preds.items():
        pw = weight_outputs(p.astype(np.float64), spec, grid, dp, stats)
        sw = None
        if samplepreds and name in samplepreds:
            sw = weight_outputs_sampled(
                samplepreds[name].astype(np.float64), spec, grid, dp, stats)
        names = metric_names + (("CRPS",) if sw is not None else ())
        tables[name] = metrics_table(pw, tw, names, sw)
        per_index[name] = metrics_per_index(pw, tw, spec, metric_names)
    return tables, per_index


def tables_to_dataframe(tables: dict):
    """{model: {var: {metric: value}}} -> tidy multi-index DataFrame."""
    import pandas as pd

    frames = {m: pd.DataFrame(t).T for m, t in tables.items()}
    return pd.concat(frames, names=["model", "variable"])
