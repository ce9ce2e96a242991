"""Scientific analysis & figures: daily averaging, pressure-latitude R2
maps, metric bar charts.

Mirrors data_utils.reshape_daily/plot_r2_analysis (data_utils.py:1609-1690)
and the grouped-bar headline figures of main_figure_generation.ipynb, as
pure functions (compute split from plotting so tests cover the math).
The port's copy of ``climsim_tpu/eval/analysis.py``; matplotlib is
imported only inside the plotting functions.
"""

from __future__ import annotations

import numpy as np

from ..grid import Grid


def reshape_daily(output: np.ndarray, grid: Grid, samples_per_day: int = 12,
                  spec=None, variables=("ptend_t", "ptend_q0001")):
    """Flat outputs -> daily zonal means of the requested profile vars.

    Returns one (lat, n_days, 60) array per variable.  Scoring stride 6
    gives 12 samples/day at the 1200 s cadence (data_utils.py:1609-1629).
    ``spec`` selects the variable layout; None keeps the v1 default (the
    reference hardcodes [:, :60]/[:, 60:120], which silently reads garbage
    for v2/v5 layouts -- passing the spec makes the slicing explicit).
    """
    if spec is None:
        from ..varspec import get_varspec

        spec = get_varspec("v1")
    n = output.shape[0]
    ncol = grid.ncol
    t = n // ncol
    days = t // samples_per_day

    def one(block):
        a = block.reshape(t, ncol, 60)[: days * samples_per_day]
        daily = a.reshape(days, samples_per_day, ncol, 60).mean(axis=1)
        zonal = np.stack([daily[:, idx, :].mean(axis=1)
                          for idx in grid.lat_indices()])
        return zonal  # (lat, days, 60)

    sl = spec.output_slices
    for v in variables:
        assert sl[v].stop - sl[v].start == 60, \
            f"{v} is not a profile variable in {spec.name}"
    return tuple(one(output[:, sl[v]]) for v in variables)


def daily_zonal_r2(pred_daily: np.ndarray, target_daily: np.ndarray):
    """R2 over the day axis per (lat, level) -- the press-lat skill map
    (plot_r2_analysis inner computation, data_utils.py:1644-1657)."""
    sse = ((pred_daily - target_daily) ** 2).sum(axis=1)
    sst = ((target_daily - target_daily.mean(axis=1, keepdims=True)) ** 2
           ).sum(axis=1)
    return 1.0 - sse / np.maximum(sst, 1e-30)  # (lat, 60)


def mean_pressure_by_lat(grid: Grid, ps_by_col: np.ndarray | float = 1.0e5):
    """(lat, 60) temporally/zonally averaged mid-level pressures for the
    plot y-axis (get_pressure_grid_plotting, data_utils.py:1088-1108)."""
    ps = np.asarray(ps_by_col)
    if ps.ndim == 0:
        ps = np.full(grid.ncol, float(ps))
    pmid = grid.p0 * grid.hyam[None, :] + grid.hybm[None, :] * ps[:, None]
    return np.stack([pmid[idx].mean(axis=0) for idx in grid.lat_indices()])


def plot_r2_maps(r2_by_model: dict, grid: Grid, pressure_lat: np.ndarray,
                 save_path: str | None = None):
    """Pressure-latitude R2 panels per model (matplotlib)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = list(r2_by_model)
    fig, axes = plt.subplots(1, len(models),
                             figsize=(6 * len(models), 5), squeeze=False)
    x = np.sin(np.radians(grid.unique_lats))
    for ax, name in zip(axes[0], models):
        coeff = r2_by_model[name].T  # (60, lat)
        y = pressure_lat.T / 100.0
        pc = ax.pcolormesh(x, y.mean(axis=1), np.clip(coeff, 0, 1),
                           cmap="Blues", vmin=0, vmax=1, shading="auto")
        ax.set_ylim(ax.get_ylim()[::-1])
        ax.set_title(name)
        ax.set_xlabel("sin(lat)")
    axes[0, 0].set_ylabel("pressure [hPa]")
    fig.colorbar(pc, ax=axes.ravel().tolist(), label="R$^2$")
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def plot_metric_bars(tables: dict, metric: str = "MAE",
                     save_path: str | None = None):
    """Grouped per-variable bar chart across models (headline figure)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    models = list(tables)
    varnames = list(next(iter(tables.values())))
    x = np.arange(len(varnames))
    width = 0.8 / len(models)
    fig, ax = plt.subplots(figsize=(1.2 * len(varnames) + 2, 4))
    for i, m in enumerate(models):
        vals = [tables[m][v][metric] for v in varnames]
        ax.bar(x + i * width, vals, width, label=m)
    ax.set_xticks(x + 0.4 - width / 2)
    ax.set_xticklabels(varnames, rotation=45, ha="right")
    ax.set_ylabel(metric)
    ax.legend()
    if save_path:
        fig.savefig(save_path, dpi=150, bbox_inches="tight")
    plt.close(fig)
    return fig


def set_plot_params(font_size: int = 32, linewidth: int = 2):
    """Publication plot defaults (data_utils.set_plot_params :999-1017)."""
    import matplotlib.pyplot as plt

    plt.close("all")
    plt.rcParams.update(plt.rcParamsDefault)
    plt.rc("font", family="sans")
    plt.rcParams.update({
        "font.size": font_size,
        "lines.linewidth": linewidth,
        "axes.labelsize": font_size,
        "axes.titlesize": font_size,
        "xtick.labelsize": font_size,
        "ytick.labelsize": font_size,
        "legend.fontsize": font_size,
        "axes.linewidth": linewidth,
    })
