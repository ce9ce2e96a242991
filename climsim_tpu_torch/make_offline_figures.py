"""Offline evaluation figure set -- the reference's headline figures.

The port's entry for ``scripts/make_offline_figures.py``: on the synthetic
split, the per-variable MAE and R2 grouped bars across the six baselines
and the pressure-latitude R2 skill maps of the heating (dT/dt) and
moistening (dq/dt) tendencies, from daily zonal means of the
*unweighted* scoring-space fields (the reference's plot_r2_analysis,
data_utils.py:1609-1690).

    python -m climsim_tpu_torch.make_offline_figures [--epochs 10]
        [--days 10] [--n-train 18432] [--outdir docs/figures]
        [--device cuda]

trains through ``run_all_baselines.train_and_score`` on the card and
renders ``offline_{mae,r2}_bars.torch.png`` and
``offline_r2_map_{t,q}.torch.png`` (never the JAX script's ``.png``
names), one printed line a file.  Every array the figures plot is
computed first (``main`` returns them); where matplotlib is not
installed nothing is drawn, and a printed line says so.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

SAMPLES_PER_DAY = 12  # scoring stride 6 at the 1200 s cadence
MAP_VARS = ("ptend_t", "ptend_q0001")


def figure_arrays(spec, grid, stats, x_sc, y_sc, preds):
    """The R2 maps' arrays: {variable: {model: (lev, lat) R2}} from daily
    zonal means, and the mean pressure by latitude (lev, lat)."""
    import torch

    from .data.transforms import make_target_transform
    from .eval.analysis import (daily_zonal_r2, mean_pressure_by_lat,
                                reshape_daily)

    tgt = make_target_transform(spec, stats, device="cpu")(
        torch.as_tensor(y_sc)).numpy().astype(np.float64)
    tz = dict(zip(MAP_VARS, reshape_daily(tgt, grid, spec=spec,
                                          variables=MAP_VARS)))
    r2maps = {v: {} for v in MAP_VARS}
    for name, p in preds.items():
        pz = reshape_daily(p.astype(np.float64), grid, spec=spec,
                           variables=MAP_VARS)
        for v, pd in zip(MAP_VARS, pz):
            r2maps[v][name] = daily_zonal_r2(pd, tz[v])
    ps_sl = spec.input_slices["state_ps"]
    ps_by_col = (x_sc[:, ps_sl].reshape(-1, grid.ncol)
                 .mean(axis=0).astype(np.float64))
    return r2maps, mean_pressure_by_lat(grid, ps_by_col)


def draw(tables, r2maps, grid, plat, outdir) -> list:
    """The four figures into ``outdir``; returns their paths, or [] where
    matplotlib is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return []
    from .eval.analysis import plot_metric_bars, plot_r2_maps

    os.makedirs(outdir, exist_ok=True)
    paths = []
    for metric, fname in (("MAE", "offline_mae_bars.torch.png"),
                          ("R2", "offline_r2_bars.torch.png")):
        paths.append(os.path.join(outdir, fname))
        plot_metric_bars(tables, metric, save_path=paths[-1])
    for v, fname in (("ptend_t", "offline_r2_map_t.torch.png"),
                     ("ptend_q0001", "offline_r2_map_q.torch.png")):
        paths.append(os.path.join(outdir, fname))
        plot_r2_maps(r2maps[v], grid, plat, save_path=paths[-1])
    return paths


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--days", type=int, default=10)
    ap.add_argument("--n-train", type=int, default=None,
                    help="training rows (default 48 x the grid's columns)")
    ap.add_argument("--outdir", default=os.path.join("docs", "figures"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from . import run_all_baselines
    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import compute_norms_from_data
    from .varspec import get_varspec

    t0 = time.time()
    spec = get_varspec("v1")
    grid = load_default_grid()
    n_train = args.n_train or 48 * grid.ncol
    n_score = args.days * SAMPLES_PER_DAY * grid.ncol
    x, y = synthetic_split(spec, n_train + n_score, grid=grid, seed=0,
                           noise=0.03)
    x_tr, y_tr = x[:n_train], y[:n_train]
    x_sc, y_sc = x[n_train:], y[n_train:]
    stats = compute_norms_from_data(spec, x_tr, y_tr)

    tables, info, preds, _samples = run_all_baselines.train_and_score(
        spec, grid, stats, x_tr, y_tr, x_sc, y_sc, epochs=args.epochs,
        device=args.device)
    r2maps, plat = figure_arrays(spec, grid, stats, x_sc, y_sc, preds)
    paths = draw(tables, r2maps, grid, plat, args.outdir)
    for p in paths:
        print(f"wrote {p}")
    if not paths:
        print("figures not drawn: matplotlib is not installed", flush=True)
    print(f"done in {time.time() - t0:.0f}s "
          f"(device: {run_all_baselines.card_line(args.device)})")
    return dict(tables=tables, train_info=info, r2maps=r2maps,
                pressure_lat=plat, figures=paths)


if __name__ == "__main__":
    main()
