"""Offline emulation-quality metrics: MAE, RMSE, R2, bias, CRPS.

Definitions match climsim_utils/data_utils.py:1432-1524 exactly:
  * all metrics reduce over time (axis 0) first, then average over the grid,
  * R2 = 1 - SSE/SST with SST about the per-(grid,level) time mean,
  * CRPS uses the sorted-sample ECDF identity with S samples:
      CRPS = E|X - y| - sum_k (x_(k+1) - x_(k)) * k * (S - k) / (S * (S-1))

The port's copy of ``climsim_tpu/eval/metrics.py``: numpy, float64 host
scoring (the reference's eval upcasts to f64).
"""

from __future__ import annotations

import numpy as np


def mae(pred, target, avg_grid=True):
    m = np.abs(pred - target).mean(axis=0)
    return m.mean(axis=0) if avg_grid else m


def rmse(pred, target, avg_grid=True):
    r = np.sqrt(((pred - target) ** 2).mean(axis=0))
    return r.mean(axis=0) if avg_grid else r


def r2(pred, target, avg_grid=True):
    sse = ((pred - target) ** 2).sum(axis=0)
    sst = ((target - target.mean(axis=0, keepdims=True)) ** 2).sum(axis=0)
    r = 1.0 - sse / sst
    return r.mean(axis=0) if avg_grid else r


def bias(pred, target, avg_grid=True):
    b = pred.mean(axis=0) - target.mean(axis=0)
    return b.mean(axis=0) if avg_grid else b


def crps(samplepreds, target, avg_grid=True):
    """ECDF-identity CRPS over the trailing sample axis.

    samplepreds: (T, ncol[, L], S); target: (T, ncol[, L]).
    """
    num = samplepreds.shape[-1]
    abs_err = np.mean(np.abs(samplepreds - target[..., None]), axis=(0, -1))
    srt = np.sort(samplepreds, axis=-1)
    diff = srt[..., 1:] - srt[..., :-1]
    count = np.arange(1, num) * np.arange(num - 1, 0, -1)
    shape = (1,) * (diff.ndim - 1) + (num - 1,)
    spread = (diff * count.reshape(shape)).sum(axis=-1).mean(axis=0)
    c = abs_err - spread / (num * (num - 1))
    return c.mean(axis=0) if avg_grid else c


METRIC_FNS = {"MAE": mae, "RMSE": rmse, "R2": r2, "bias": bias}


def metrics_table(preds_weighted: dict, target_weighted: dict,
                  metric_names=("MAE", "RMSE", "R2", "bias"),
                  samplepreds_weighted: dict | None = None):
    """Per-variable metric table (dict-of-dicts; convertible to DataFrame).

    preds_weighted/target_weighted: var -> weighted arrays from
    eval.weighting.weight_outputs.  Adds CRPS rows when sampled predictions
    are provided.  Mirrors data_utils.create_metrics_df (:1526-1607).
    """
    table: dict[str, dict[str, float]] = {}
    for v, tgt in target_weighted.items():
        row = {}
        for m in metric_names:
            if m == "CRPS":
                continue
            row[m] = float(np.mean(METRIC_FNS[m](preds_weighted[v], tgt)))
        if samplepreds_weighted is not None and v in samplepreds_weighted:
            row["CRPS"] = float(np.mean(crps(samplepreds_weighted[v], tgt)))
        table[v] = row
    return table


def metrics_per_index(preds_weighted: dict, target_weighted: dict, spec,
                      metric_names=("MAE", "RMSE", "R2", "bias")):
    """Per-output-feature metric vectors in flat layout order."""
    out = {m: [] for m in metric_names}
    for v in spec.outputs:
        tgt = target_weighted[v]
        for m in metric_names:
            vals = np.atleast_1d(METRIC_FNS[m](preds_weighted[v], tgt))
            out[m].append(vals)
    return {m: np.concatenate(vs) for m, vs in out.items()}


def to_dataframe(table: dict):
    import pandas as pd

    df = pd.DataFrame(table).T
    df.index.name = "variable"
    return df
