"""Batch metrics CLI -- score prediction files against a split.

The standalone equivalent of evaluation/ClimSim_metrics.many-trials.v2.py:
given split inputs/targets and one .npy prediction file per model/trial,
writes per-variable (level-averaged) and per-output-index CSV tables of
MAE/RMSE/R2/bias in W/m^2.

Scoring runs on the host, in numpy float64, as the reference's scripts
do; it takes no device.  The port's copy of ``climsim_tpu/eval/cli.py``:
the same files give byte-equal CSV tables.

Usage:
  python -m climsim_tpu_torch.eval.cli \
      --inputs scoring_input.npy --targets scoring_target.npy \
      --varspec v1 --norms asset \
      --pred mlp=preds_mlp.npy --pred cnn=preds_cnn.npy \
      --out-dir metrics/
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--inputs", required=True)
    ap.add_argument("--targets", required=True)
    ap.add_argument("--varspec", default="v1")
    ap.add_argument("--norms", default="asset",
                    help="'asset', 'none', or a NormStats .npz path")
    ap.add_argument("--pred", action="append", default=[],
                    help="name=path.npy (repeatable)")
    ap.add_argument("--samples", action="append", default=[],
                    help="name=path.npy with (N, D, S) samples for CRPS")
    ap.add_argument("--out-dir", default="metrics")
    ap.add_argument("--raw-inputs", action="store_true",
                    help="inputs are un-normalized")
    args = ap.parse_args(argv)

    from ..grid import load_default_grid
    from ..norms import NormStats, load_asset_norms
    from ..varspec import get_varspec
    from .scoring import offline_score

    spec = get_varspec(args.varspec)
    grid = load_default_grid()
    if args.norms == "asset":
        stats = load_asset_norms(args.varspec)
    elif args.norms == "none":
        stats = None
    else:
        stats = NormStats.from_npz(args.norms)

    inputs = np.load(args.inputs, mmap_mode="r")
    target = np.load(args.targets, mmap_mode="r")
    def parse_named(entries, flag):
        out = {}
        for spec_str in entries:
            name, sep, path = spec_str.partition("=")
            if not sep or not name or not path:
                ap.error(f"{flag} expects name=path.npy, got {spec_str!r}")
            out[name] = np.load(path, mmap_mode="r")
        return out

    preds = parse_named(args.pred, "--pred")
    samples = parse_named(args.samples, "--samples")

    tables, per_index = offline_score(
        spec, grid, stats, np.asarray(inputs), np.asarray(target),
        {k: np.asarray(v) for k, v in preds.items()},
        {k: np.asarray(v) for k, v in samples.items()} or None,
        inputs_normalized=not args.raw_inputs)

    os.makedirs(args.out_dir, exist_ok=True)
    for name, table in tables.items():
        var_path = os.path.join(args.out_dir, f"{name}_by_variable.csv")
        metrics = list(next(iter(table.values())))
        with open(var_path, "w") as f:
            f.write("variable," + ",".join(metrics) + "\n")
            for v, row in table.items():
                f.write(v + "," + ",".join(
                    f"{row[m]:.6g}" for m in metrics) + "\n")
        idx_path = os.path.join(args.out_dir, f"{name}_by_index.csv")
        pi = per_index[name]
        keys = list(pi)
        with open(idx_path, "w") as f:
            f.write("output_idx," + ",".join(keys) + "\n")
            for i in range(spec.output_len):
                f.write(str(i) + "," + ",".join(
                    f"{pi[k][i]:.6g}" for k in keys) + "\n")
        print(f"{name}: wrote {var_path}, {idx_path}")


if __name__ == "__main__":
    main()
