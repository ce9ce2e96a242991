"""Streaming offline scoring for splits too large for host RAM.

The high-res dataset has 5.7B samples (website/dataset.md:10-12); the
in-memory scorer (eval/scoring.py) tops out at what fits in RAM.  This
module computes the exact same MAE/RMSE/R2/bias tables by accumulating
sufficient statistics over *time chunks*:

  per (grid, level):  n, sum|e|, sum e, sum e^2, sum y, sum y^2

R2 needs the SST about the per-gridpoint time mean -- accumulated exactly
via sum y / sum y^2 (parallel-variance identity), so a single pass over
chunks of whole timesteps reproduces the reference definition
(data_utils.py:1465-1481) bit-for-bit up to summation order.

Chunks must contain whole timesteps (multiples of ncol samples).  The
port's copy of ``climsim_tpu/eval/streaming.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..grid import Grid
from ..norms import NormStats
from ..varspec import VarSpec
from .weighting import pressure_thickness_from_inputs, weight_outputs


@dataclass
class _Acc:
    n: int = 0
    abs_err: np.ndarray | None = None
    err: np.ndarray | None = None
    err2: np.ndarray | None = None
    y: np.ndarray | None = None
    y2: np.ndarray | None = None

    def update(self, pred, target):
        e = pred - target
        parts = (np.abs(e).sum(0), e.sum(0), (e**2).sum(0),
                 target.sum(0), (target**2).sum(0))
        if self.abs_err is None:
            self.abs_err, self.err, self.err2, self.y, self.y2 = \
                [p.copy() for p in parts]
        else:
            for buf, p in zip((self.abs_err, self.err, self.err2,
                               self.y, self.y2), parts):
                buf += p
        self.n += pred.shape[0]

    def finalize(self) -> dict:
        n = self.n
        mae = self.abs_err / n
        bias = self.err / n
        rmse = np.sqrt(self.err2 / n)
        sst = self.y2 - self.y**2 / n
        r2 = 1.0 - self.err2 / np.where(sst == 0, np.nan, sst)
        return {
            "MAE": float(np.mean(mae.mean(axis=0))),
            "RMSE": float(np.mean(rmse.mean(axis=0))),
            "bias": float(np.mean(bias.mean(axis=0))),
            "R2": float(np.nanmean(r2.mean(axis=0))),
        }


class StreamingScorer:
    """Feed (inputs, target, {model: pred}) chunks; read tables at the end.

    Chunks are weighted exactly like the in-memory path (unscale -> dp/g
    -> area -> energy) before accumulation.
    """

    def __init__(self, spec: VarSpec, grid: Grid,
                 stats: NormStats | None, inputs_normalized: bool = True):
        self.spec = spec
        self.grid = grid
        self.stats = stats
        self.inputs_normalized = inputs_normalized
        self._accs: dict[str, dict[str, _Acc]] = {}
        self._crps: dict[str, dict[str, list]] = {}

    def update(self, inputs: np.ndarray, target: np.ndarray,
               preds: dict[str, np.ndarray],
               samplepreds: dict[str, np.ndarray] | None = None):
        assert inputs.shape[0] % self.grid.ncol == 0, \
            "chunks must contain whole timesteps"
        dp = pressure_thickness_from_inputs(
            inputs.astype(np.float64), self.spec, self.grid,
            self.stats if self.inputs_normalized else None)
        tw = weight_outputs(target.astype(np.float64), self.spec,
                            self.grid, dp, self.stats)
        for name, p in preds.items():
            pw = weight_outputs(p.astype(np.float64), self.spec,
                                self.grid, dp, self.stats)
            accs = self._accs.setdefault(name, {})
            for v, t_arr in tw.items():
                accs.setdefault(v, _Acc()).update(pw[v], t_arr)
        if samplepreds:
            from .metrics import crps
            from .weighting import weight_outputs_sampled

            for name, sp in samplepreds.items():
                sw = weight_outputs_sampled(
                    sp.astype(np.float64), self.spec, self.grid, dp,
                    self.stats)
                store = self._crps.setdefault(name, {})
                for v, s_arr in sw.items():
                    # CRPS is a per-(time, grid[, level]) quantity meaned
                    # over time -> accumulate chunk time-sums exactly
                    c = crps(s_arr, tw[v], avg_grid=False)
                    t_chunk = s_arr.shape[0]
                    if v in store:
                        store[v][0] += c * t_chunk
                        store[v][1] += t_chunk
                    else:
                        store[v] = [c * t_chunk, t_chunk]

    def tables(self) -> dict:
        out = {name: {v: acc.finalize() for v, acc in accs.items()}
               for name, accs in self._accs.items()}
        for name, store in self._crps.items():
            for v, (csum, t_total) in store.items():
                out.setdefault(name, {}).setdefault(v, {})["CRPS"] = float(
                    np.mean((csum / t_total).mean(axis=0)))
        return out
