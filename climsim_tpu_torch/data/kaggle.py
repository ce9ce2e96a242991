"""Kaggle competition export (LEAP ClimSim Kaggle 2024 format).

Mirrors for_kaggle_users.py: un-normalized v2 features/targets as wide
CSV-compatible tables with per-level column names (``var_i``), the
``cam_in_SNOWHICE`` column dropped (strange values, :155), per-output
weights = 1/std (floor 1e-15) with the first 12 levels of the ablated
tendency variables zeroed (:65-80, :168-173), and a sample-submission
frame carrying the weights.
"""

from __future__ import annotations

import numpy as np

from ..varspec import VarSpec, get_varspec, var_len

ABLATED_VARS = ("ptend_q0001", "ptend_q0002", "ptend_q0003", "ptend_u",
                "ptend_v")
ABLATED_LEVELS = 12
DROP_INPUT_COLS = ("cam_in_SNOWHICE",)


def column_names(names) -> list[str]:
    out = []
    for v in names:
        if var_len(v) > 1:
            out.extend(f"{v}_{i}" for i in range(var_len(v)))
        else:
            out.append(v)
    return out


def ablated_column_names(spec: VarSpec | None = None) -> list[str]:
    return [f"{v}_{i}" for v in ABLATED_VARS for i in range(ABLATED_LEVELS)]


def make_train_frame(inputs_raw: np.ndarray, targets_raw: np.ndarray,
                     spec: VarSpec | None = None, prefix: str = "train"):
    """(N, 557) + (N, 368) raw v2 arrays -> pandas DataFrame in the Kaggle
    train.csv layout (sample_id index, SNOWHICE dropped)."""
    import pandas as pd

    spec = spec or get_varspec("v2")
    cols = column_names(spec.inputs) + column_names(spec.outputs)
    df = pd.DataFrame(
        np.concatenate([inputs_raw, targets_raw], axis=1),
        index=[f"{prefix}_{i}" for i in range(inputs_raw.shape[0])],
        columns=cols)
    df.index.name = "sample_id"
    return df.drop(columns=list(DROP_INPUT_COLS))


def output_weights(targets_raw: np.ndarray, spec: VarSpec | None = None):
    """Per-output-column weights: 1/std floored at 1e-15, ablated
    stratosphere tendency columns zeroed.  Returns (names, weights)."""
    spec = spec or get_varspec("v2")
    names = column_names(spec.outputs)
    std = targets_raw.std(axis=0, dtype=np.float64)
    w = 1.0 / np.maximum(std, 1e-15)
    ablate = set(ablated_column_names())
    for i, n in enumerate(names):
        if n in ablate:
            w[i] = 0.0
    return names, w


def make_submission_frame(index, targets_raw_or_weights, spec=None,
                          from_weights: bool = False):
    """Sample-submission frame: every row carries the column weights."""
    import pandas as pd

    spec = spec or get_varspec("v2")
    if from_weights:
        names = column_names(spec.outputs)
        w = targets_raw_or_weights
    else:
        names, w = output_weights(targets_raw_or_weights, spec)
    df = pd.DataFrame(np.tile(w, (len(index), 1)), index=index,
                      columns=names)
    df.index.name = "sample_id"
    return df
