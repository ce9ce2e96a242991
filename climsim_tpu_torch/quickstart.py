"""Quickstart: train and score an MLP emulator end to end.

The counterpart of ``examples/quickstart.py``: a v1 split (synthetic, or
raw ``--inputs`` / ``--targets`` .npy shards, memory-mapped) -> norms
computed from it -> the v1 ``ClimSimMLP`` trained by ``fit`` over a
streaming ``BatchLoader`` -> predictions on a held-out block ->
``offline_score`` tables in W/m^2 beside two free baselines (predict zero,
predict the train mean) -> bar figures of MAE and R2.

  python -m climsim_tpu_torch.quickstart [--epochs 6] [--batch 1024]
      [--out-dir quickstart_out] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--inputs", help="train_input.npy (raw); default "
                    "synthetic")
    ap.add_argument("--targets", help="train_target.npy (raw)")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--rows", type=int, default=32 * 384,
                    help="rows of the synthetic split")
    ap.add_argument("--hidden", default="768,640,512,640,640",
                    help="hidden widths of the MLP")
    ap.add_argument("--out-dir", default="quickstart_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .data.pipeline import BatchLoader
    from .data.synthetic import synthetic_split
    from .data.transforms import make_target_transform
    from .eval.analysis import plot_metric_bars
    from .eval.scoring import offline_score
    from .grid import load_default_grid
    from .norms import compute_norms_from_data
    from .train import recipes
    from .train.loop import fit
    from .varspec import get_varspec

    spec = get_varspec("v1")
    grid = load_default_grid()
    if args.inputs:
        x = np.load(args.inputs, mmap_mode="r")
        y = np.load(args.targets, mmap_mode="r")
    else:
        x, y = synthetic_split(spec, n=args.rows, grid=grid, seed=0)
    stats = compute_norms_from_data(spec, x, y)

    n_val = 4 * 384
    x_tr, y_tr, x_val, y_val = x[:-n_val], y[:-n_val], x[-n_val:], y[-n_val:]
    x_val, y_val = np.asarray(x_val), np.asarray(y_val)
    steps = x_tr.shape[0] // args.batch
    hidden = tuple(int(h) for h in args.hidden.split(","))
    tr = recipes.mlp_trainer(spec, stats, None, 0, hidden=hidden,
                             steps_per_epoch=steps, device=args.device)
    train_loader = BatchLoader(x_tr, y_tr, args.batch, seed=0,
                               device=args.device)
    val_loader = BatchLoader(x_val, y_val, args.batch, shuffle=False,
                             device=args.device)
    state, hist = fit(tr.train_step, tr.eval_step, tr.state, train_loader,
                      val_loader, args.epochs)

    # the held-out block, beside two free baselines (as the notebook):
    # predict zero and predict the train mean
    preds = tr.predict(state.params, x_val, 2048)
    tgt_t = make_target_transform(spec, stats, device="cpu")
    y_val_n = tgt_t(torch.from_numpy(y_val)).numpy()
    y_tr_mean = tgt_t(torch.from_numpy(np.array(y_tr))).numpy().mean(
        axis=0, keepdims=True)
    x_val_n = (x_val - stats.inp_sub) / stats.inp_div
    tables, _ = offline_score(
        spec, grid, stats, x_val_n, y_val_n,
        {"mlp": preds, "zero": np.zeros_like(y_val_n),
         "train_mean": np.repeat(y_tr_mean, y_val_n.shape[0], 0)})

    os.makedirs(args.out_dir, exist_ok=True)
    for model, table in tables.items():
        print(f"\n=== {model} ===")
        for v, row in table.items():
            print(f"  {v:18s} MAE {row['MAE']:10.4f}  R2 {row['R2']:7.3f}")
    plot_metric_bars(tables, "MAE", os.path.join(args.out_dir, "mae.png"))
    plot_metric_bars(tables, "R2", os.path.join(args.out_dir, "r2.png"))
    print(f"\nfigures in {args.out_dir}/")
    return {"history": hist.rows, "tables": tables}


if __name__ == "__main__":
    main()
