"""Dataset statistics: per-variable, per-level moments and histograms.

Replaces the reference's dataset_statistics/ SLURM fan-out (one job per
variable x level, dataset_statistics/code/tendency_vvvv_llll.py) with a
single streaming pass: shards are consumed in chunks, Welford moments and
fixed-bin histograms accumulate per feature, and results group naturally
by variable/level through the VarSpec offsets.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..varspec import VarSpec, var_len


@dataclass
class RunningStats:
    """Vectorized Welford accumulator over feature columns."""

    dim: int
    count: int = 0
    mean: np.ndarray = None
    m2: np.ndarray = None
    minv: np.ndarray = None
    maxv: np.ndarray = None

    def __post_init__(self):
        self.mean = np.zeros(self.dim)
        self.m2 = np.zeros(self.dim)
        self.minv = np.full(self.dim, np.inf)
        self.maxv = np.full(self.dim, -np.inf)

    def update(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float64)
        n_b = chunk.shape[0]
        if n_b == 0:
            return
        b_mean = chunk.mean(axis=0)
        b_m2 = ((chunk - b_mean) ** 2).sum(axis=0)
        n_a = self.count
        n = n_a + n_b
        delta = b_mean - self.mean
        self.mean = self.mean + delta * (n_b / n)
        self.m2 = self.m2 + b_m2 + delta**2 * (n_a * n_b / n)
        self.minv = np.minimum(self.minv, chunk.min(axis=0))
        self.maxv = np.maximum(self.maxv, chunk.max(axis=0))
        self.count = n

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.m2 / max(self.count - 1, 1))


@dataclass
class HistogramAccumulator:
    """Fixed-bin per-feature histograms (range set on the first chunk or
    explicitly)."""

    dim: int
    bins: int = 100
    lo: np.ndarray | None = None
    hi: np.ndarray | None = None
    counts: np.ndarray = None

    def update(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float64)
        if self.lo is None:
            self.lo = chunk.min(axis=0)
            self.hi = chunk.max(axis=0)
            span = np.where(self.hi > self.lo, self.hi - self.lo, 1.0)
            self.hi = self.lo + span
            self.counts = np.zeros((self.dim, self.bins), np.int64)
        width = (self.hi - self.lo) / self.bins
        idx = np.clip(((chunk - self.lo) / width).astype(np.int64), 0,
                      self.bins - 1)
        for f in range(self.dim):
            self.counts[f] += np.bincount(idx[:, f], minlength=self.bins)

    def edges(self, feature: int) -> np.ndarray:
        return np.linspace(self.lo[feature], self.hi[feature],
                           self.bins + 1)


def compute_statistics(arrays, spec: VarSpec, which: str = "outputs",
                       bins: int = 0, chunk: int = 65536) -> dict:
    """Stream (iterable of or single) (N, D) arrays -> per-variable stats.

    Returns {var: {mean/std/min/max: (levels,) arrays, count: int,
                   histogram/edges: optional}}.
    """
    names = spec.outputs if which == "outputs" else spec.inputs
    slices = (spec.output_slices if which == "outputs"
              else spec.input_slices)
    dim = sum(var_len(v) for v in names)
    rs = RunningStats(dim)
    hist = HistogramAccumulator(dim, bins) if bins else None
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    for arr in arrays:
        for s in range(0, arr.shape[0], chunk):
            c = np.asarray(arr[s:s + chunk], np.float64)
            rs.update(c)
            if hist is not None:
                hist.update(c)
    out = {}
    for v in names:
        sl = slices[v]
        entry = {
            "mean": rs.mean[sl], "std": rs.std[sl],
            "min": rs.minv[sl], "max": rs.maxv[sl], "count": rs.count,
        }
        if hist is not None:
            entry["histogram"] = hist.counts[sl]
            entry["edges"] = np.stack([
                hist.edges(i) for i in range(sl.start, sl.stop)])
        out[v] = entry
    return out


def main(argv=None):
    """CLI: per-variable/level statistics over npy shards in one pass.

    python -m climsim_tpu.data.statistics --arrays train_target.npy \
        --varspec v1 --which outputs --bins 64 --out stats.npz

    Replaces the reference's per-variable x per-level SLURM fan-out
    (dataset_statistics/code/process_all_tendency.sh +
    tendency_vvvv_llll.py): the streaming accumulators make the split in
    one pass, so no job array is needed.
    """
    import argparse

    from ..varspec import get_varspec

    ap = argparse.ArgumentParser()
    ap.add_argument("--arrays", nargs="+", required=True,
                    help="npy shard(s), memory-mapped")
    ap.add_argument("--varspec", default="v1")
    ap.add_argument("--which", choices=["inputs", "outputs"],
                    default="outputs")
    ap.add_argument("--bins", type=int, default=0)
    ap.add_argument("--out", required=True, help="output .npz")
    args = ap.parse_args(argv)

    spec = get_varspec(args.varspec)
    arrays = [np.load(p, mmap_mode="r") for p in args.arrays]
    stats = compute_statistics(arrays, spec, args.which, bins=args.bins)
    flat = {}
    for v, entry in stats.items():
        for k, val in entry.items():
            flat[f"{v}/{k}"] = np.asarray(val)
    np.savez(args.out, **flat)
    for v, entry in stats.items():
        m, s = entry["mean"], entry["std"]
        print(f"{v}: mean[{m.min():.3e},{m.max():.3e}] "
              f"std[{s.min():.3e},{s.max():.3e}] n={entry['count']}")


if __name__ == "__main__":
    main()
