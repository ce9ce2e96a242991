"""Small IO helpers (load_npy_file/load_h5_file parity,
data_utils.py:1019-1035)."""

from __future__ import annotations

import numpy as np


def load_npy_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return np.load(f)


def load_h5_file(path: str, key: str = "pred") -> np.ndarray:
    import h5py

    with h5py.File(path, "r") as hf:
        if key in hf:
            return np.asarray(hf[key])
        # fall back to the first dataset (shard files use 'data')
        first = next(iter(hf.keys()))
        return np.asarray(hf[first])
