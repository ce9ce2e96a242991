"""Online (coupled-run) diagnostics.

Reproduces the metrics of online_testing/evaluation/*.ipynb over rollout
trajectories from the hybrid driver (or real model output):
  * time-mean RMSE of prognostic fields vs a reference run, mass (dp/g) and
    area weighted (monthly-online-rmse-visualization.ipynb cells 5-7)
  * zonal-mean bias maps (lat x level)
  * error growth curve within a window (error-growth notebook)
  * precipitation statistics (mean/p99 of PRECC)

All functions take (T, B, L) or (T, B) arrays; float64 numpy for scoring.
The port's copy of ``climsim_tpu/eval/online_diags.py``; a rollout of
``climsim_tpu_torch.online.driver`` reaches it through ``.cpu().numpy()``.
"""

from __future__ import annotations

import numpy as np

from ..grid import Grid


def _weights(grid: Grid, ps: np.ndarray | float = 1.0e5):
    """(B, L) mass weights dp/g times normalized area (B, 1)."""
    ps = np.asarray(ps)
    if ps.ndim == 0:
        ps = np.full(grid.ncol, float(ps))
    p = grid.p0 * grid.hyai[None, :] + grid.hybi[None, :] * ps[:, None]
    dp = (p[:, 1:] - p[:, :-1]) / 9.80616
    return dp * grid.area_wgt[:, None]


def weighted_rmse(traj: np.ndarray, ref: np.ndarray, grid: Grid,
                  ps=1.0e5) -> float:
    """Mass+area weighted global RMSE over a trajectory window.

    traj/ref: (T, B, L) level-resolved or (T, B) scalar fields.
    """
    err2 = (traj - ref) ** 2
    if err2.ndim == 3:
        w = _weights(grid, ps)[None, :, :]
        return float(np.sqrt((err2 * w).sum() / (w.sum() * err2.shape[0])))
    w = grid.area_wgt[None, :]
    return float(np.sqrt((err2 * w).sum() / (w.sum() * err2.shape[0])))


def window_mean_rmse(traj: np.ndarray, ref: np.ndarray, grid: Grid,
                     window: int, ps=1.0e5) -> np.ndarray:
    """Weighted RMSE between *time-averaged* fields per window.

    The reference's monthly online RMSE is computed on monthly-mean (h0)
    output fields, not on instantaneous states
    (monthly-online-rmse-visualization.ipynb cells 5-7: the h0 monthly
    means of the hybrid run vs the MMF ensemble).  Time-averaging over a
    month collapses chaotic internal variability, so this metric exposes
    the model's *systematic* bias -- the quantity that decides
    coupling-grade -- where the instantaneous RMSE saturates at the
    attractor spread for any model, good or bad.

    Returns an array of one RMSE per complete window.
    """
    n_win = traj.shape[0] // window
    out = []
    for i in range(n_win):
        a = traj[i * window:(i + 1) * window].mean(axis=0, dtype=np.float64)
        b = ref[i * window:(i + 1) * window].mean(axis=0, dtype=np.float64)
        out.append(weighted_rmse(a[None], b[None], grid, ps))
    return np.array(out)


def window_means_from_segment_sums(seg_sums: np.ndarray,
                                   segs_per_win: int,
                                   window: int) -> np.ndarray:
    """(n_segs, ..., B, L) per-segment TIME SUMS -> (n_win, ..., B, L)
    window-mean fields, f64 accumulation.

    The device-resident evaluation (scripts/online_eval.py) reduces each
    rollout segment to a time-sum on device so full trajectories never
    cross the host link; window means assembled from those sums are
    exactly the trajectory window means ``window_mean_rmse`` consumes
    (tests/test_online.py::test_window_means_from_segment_sums), keeping
    the production metric and the tested reference formulation one code
    path apart by construction.
    """
    n_win = seg_sums.shape[0] // segs_per_win
    s = seg_sums.astype(np.float64).reshape(
        (n_win, segs_per_win) + seg_sums.shape[1:])
    return s.sum(axis=1) / window


def gate_window_stats(h_win: np.ndarray, m_win: np.ndarray, grid: Grid,
                      ps=1.0e5):
    """Per-variable monthly gate statistics from window-mean fields.

    h_win: (n_win, V, B, L) hybrid window means; m_win: (n_win, V, M, B, L)
    per-member window means (V gate variables, M ensemble members).
    Returns (mm_rmse, mm_floor, ratios), each (V, n_win): the hybrid's
    weighted RMSE vs the ensemble mean, the mean pairwise member floor,
    and their ratio -- the reference's T/Q/U monthly online metric
    (monthly-online-rmse-visualization.ipynb cells 5-7, one panel per
    variable).  The coupling-grade PASS criterion is
    ``np.all(ratios <= 1.5)``: every variable in every window.
    """
    import itertools

    n_win, n_v, n_m = h_win.shape[0], h_win.shape[1], m_win.shape[2]
    pairs = list(itertools.combinations(range(n_m), 2))
    ens_win = m_win.mean(axis=2)
    mm_rmse = np.array([
        [weighted_rmse(h_win[i, v][None], ens_win[i, v][None], grid, ps)
         for i in range(n_win)] for v in range(n_v)])
    mm_floor = (np.array([
        [np.mean([weighted_rmse(m_win[i, v, a][None], m_win[i, v, b][None],
                                grid, ps) for a, b in pairs])
         for i in range(n_win)] for v in range(n_v)])
        if pairs else np.zeros((n_v, n_win)))
    return mm_rmse, mm_floor, mm_rmse / np.maximum(mm_floor, 1e-30)


def ensemble_window_floor(member_trajs, grid: Grid, window: int,
                          ps=1.0e5) -> np.ndarray:
    """Noise floor for the window-mean RMSE: mean pairwise window-mean
    RMSE between perturbed-IC reference members (per window)."""
    import itertools

    pairs = list(itertools.combinations(range(len(member_trajs)), 2))
    if not pairs:
        return np.zeros(member_trajs[0].shape[0] // window)
    vals = [window_mean_rmse(member_trajs[i], member_trajs[j], grid,
                             window, ps) for i, j in pairs]
    return np.mean(vals, axis=0)


def zonal_mean_bias(traj: np.ndarray, ref: np.ndarray, grid: Grid):
    """(lat, L) time-and-longitude mean bias, sorted by latitude."""
    bias = (traj - ref).mean(axis=0)  # (B, L)
    lats = grid.unique_lats
    out = np.stack([bias[idx].mean(axis=0) for idx in grid.lat_indices()])
    return lats, out


def error_growth(traj: np.ndarray, ref: np.ndarray, grid: Grid, ps=1.0e5):
    """Per-step weighted RMSE curve (T,) -- the 1-month error growth plot."""
    return np.array([
        weighted_rmse(traj[t:t + 1], ref[t:t + 1], grid, ps)
        for t in range(traj.shape[0])])


def precip_stats(precc: np.ndarray, grid: Grid) -> dict:
    """Mean and extreme precipitation rates, area-weighted (precipitation
    statistics notebook)."""
    w = grid.area_wgt[None, :] / grid.area_wgt.sum()
    return {
        "mean": float((precc * w).sum() / precc.shape[0]),
        "p99": float(np.quantile(precc, 0.99)),
        "max": float(precc.max()),
        "frac_negative": float((precc < 0).mean()),
    }


def drift(traj: np.ndarray, grid: Grid, ps=1.0e5) -> float:
    """Weighted global-mean drift between the first and last quarter of a
    rollout -- the cheap stability indicator for coupled runs."""
    t = traj.shape[0]
    q = max(t // 4, 1)
    w = _weights(grid, ps) if traj.ndim == 3 else grid.area_wgt[:, None]
    a = (traj[:q] * w).sum() / (w.sum() * q)
    b = (traj[-q:] * w).sum() / (w.sum() * q)
    return float(b - a)


def microphysics_checks(traj_qn: np.ndarray, traj_t: np.ndarray,
                        precc: np.ndarray | None = None) -> dict:
    """Microphysics-constraint diagnostics over a rollout
    (microphysics-constraints notebook): negative-condensate rate,
    supercooled-liquid occurrence above the all-ice threshold, cloud
    fraction, precipitation negativity.
    """
    out = {
        "frac_negative_qn": float((traj_qn < 0).mean()),
        "frac_cloudy": float((traj_qn > 1e-7).mean()),
        "qn_max": float(traj_qn.max()),
        # cloud water persisting below 253.16 K should be ice-only; count
        # grid points where qn exists at T far below the ramp
        "frac_cold_cloud": float(((traj_qn > 1e-7)
                                  & (traj_t < 233.16)).mean()),
    }
    if precc is not None:
        out["frac_negative_precc"] = float((precc < 0).mean())
    return out


def ensemble_noise_floor(member_trajs, grid: Grid, ps=1.0e5) -> float:
    """Irreducible-noise floor from a reference ensemble: mean pairwise
    weighted RMSE between perturbed-seed reference runs (the reference
    compares online model error against 3 perturbed MMF members --
    monthly-online-rmse notebooks).  A model whose RMSE vs the ensemble
    mean sits at this floor is indistinguishable from internal variability.
    """
    import itertools

    pairs = list(itertools.combinations(range(len(member_trajs)), 2))
    if not pairs:
        return 0.0
    vals = [weighted_rmse(member_trajs[i], member_trajs[j], grid, ps)
            for i, j in pairs]
    return float(np.mean(vals))
