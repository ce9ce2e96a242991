"""The port's scoring (climsim_tpu_torch.eval, the Grid's evaluation
properties, the norms fitted to data) against climsim_tpu's on the same
seeded numpy inputs.

The eval modules are copies of the JAX package's numpy code, run in
float64 on the host: every function's output must be equal
(``assert_array_equal``, NaN where NaN), the CLI's CSV files byte-equal,
and ``compute_norms_from_data(qn_transform=True)`` and
``compute_exponential_lambda`` bit-equal.  Each function of the copied
modules has a case in ``CASES``; ``test_torch_package.py`` checks that
none is missing."""

import filecmp
import os

import numpy as np
import pandas as pd
import pytest

import climsim_tpu.eval.analysis as JA
import climsim_tpu.eval.metrics as JM
import climsim_tpu.eval.online_diags as JD
import climsim_tpu.eval.scoring as JS
import climsim_tpu.eval.streaming as JT
import climsim_tpu.eval.weighting as JW
import climsim_tpu_torch.eval.analysis as PA
import climsim_tpu_torch.eval.metrics as PM
import climsim_tpu_torch.eval.online_diags as PD
import climsim_tpu_torch.eval.scoring as PS
import climsim_tpu_torch.eval.streaming as PT
import climsim_tpu_torch.eval.weighting as PW
from climsim_tpu import grid as JG
from climsim_tpu import norms as JN
from climsim_tpu import varspec as JV
from climsim_tpu_torch import grid as PG
from climsim_tpu_torch import norms as PN
from climsim_tpu_torch import varspec as PV

# the copied modules, JAX package's -> the port's
MODULES = {"metrics": (JM, PM), "weighting": (JW, PW), "scoring": (JS, PS),
           "streaming": (JT, PT), "online_diags": (JD, PD),
           "analysis": (JA, PA)}
# plotting: matplotlib figures, not compared (analysis.py keeps the
# import inside them)
PLOTTING = {"plot_r2_maps", "plot_metric_bars", "set_plot_params"}
T_STEPS = 2                                       # time steps of 384 columns


def _env(pkg):
    """(grid, varspec module, norms module) of one package."""
    return ((JG, JV, JN) if pkg == "jax" else (PG, PV, PN))


def _split(version, seed=0, normalized=True):
    """Seeded (inputs, target, pred, samples) of T_STEPS x 384 rows: the
    inputs' ps column normalized by the version's asset norms, values of a
    normalized scale elsewhere."""
    spec = JV.get_varspec(version)
    stats = JN.load_asset_norms(version)
    rng = np.random.default_rng(seed)
    n = T_STEPS * 384
    x = rng.normal(size=(n, spec.input_len))
    ps = rng.uniform(6.0e4, 1.03e5, n)
    i = spec.ps_index
    x[:, i] = (ps - stats.inp_sub[i]) / stats.inp_div[i] if normalized else ps
    y = rng.normal(size=(n, spec.output_len))
    pred = y + 0.3 * rng.normal(size=y.shape)
    samples = pred[..., None] + 0.2 * rng.normal(size=y.shape + (3,))
    return x, y, pred, samples


def _equal(got, want):
    """Equal, recursively through dicts, lists, tuples and DataFrames."""
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif isinstance(want, pd.DataFrame):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    else:
        np.testing.assert_array_equal(got, want)


def _call(pkg, fn, *args, **kw):
    """Call function ``fn`` of the eval module named by the first part of
    ``fn`` in one package, with pkg-specific objects built by ``args``:
    a callable argument is given (grid module, varspec, norms)."""
    mod, name = fn.split(".")
    m = MODULES[mod][0 if pkg == "jax" else 1]
    env = _env(pkg)
    args = [a(*env) if callable(a) else a for a in args]
    kw = {k: (v(*env) if callable(v) else v) for k, v in kw.items()}
    return getattr(m, name)(*args, **kw)


GRID = lambda g, v, n: g.load_default_grid()
SPEC = lambda ver: (lambda g, v, n: v.get_varspec(ver))
STATS = lambda ver: (lambda g, v, n: n.load_asset_norms(ver))


def _traj(seed=0, t=8, ncol=384):
    rng = np.random.default_rng(seed)
    return (250.0 + 20.0 * rng.normal(size=(t, ncol, 60)),
            250.0 + 20.0 * rng.normal(size=(t, ncol, 60)))


def _metric_cases():
    x, y, pred, samples = _split("v1")
    y3, p3 = y.reshape(T_STEPS, 384, -1), pred.reshape(T_STEPS, 384, -1)
    s3 = samples.reshape(T_STEPS, 384, -1, 3)
    tw = {"a": y3[..., :60], "b": y3[..., 60]}
    pw = {"a": p3[..., :60], "b": p3[..., 60]}
    sw = {"a": s3[..., :60, :], "b": s3[..., 60, :]}
    spec = JV.get_varspec("v1")
    tw_full = JW.weight_outputs(y, spec, JG.load_default_grid(), None)
    pw_full = JW.weight_outputs(pred, spec, JG.load_default_grid(), None)
    cases = {}
    for m in ("mae", "rmse", "r2", "bias"):
        for avg in (True, False):
            cases[f"metrics.{m}[avg_grid={avg}]"] = (
                f"metrics.{m}", (p3, y3), {"avg_grid": avg})
    for avg in (True, False):
        cases[f"metrics.crps[avg_grid={avg}]"] = (
            "metrics.crps", (s3, y3), {"avg_grid": avg})
    cases["metrics.metrics_table"] = ("metrics.metrics_table", (pw, tw), {})
    cases["metrics.metrics_table[crps]"] = (
        "metrics.metrics_table", (pw, tw),
        {"metric_names": ("MAE", "RMSE", "R2", "bias", "CRPS"),
         "samplepreds_weighted": sw})
    cases["metrics.metrics_per_index"] = (
        "metrics.metrics_per_index", (pw_full, tw_full, SPEC("v1")), {})
    cases["metrics.to_dataframe"] = (
        "metrics.to_dataframe", (JM.metrics_table(pw, tw),), {})
    return cases


def _weighting_cases():
    cases = {}
    for ver in ("v1", "v5"):
        x, y, pred, samples = _split(ver)
        xr = _split(ver, normalized=False)[0]
        cases[f"weighting.pressure_thickness_from_inputs[{ver}]"] = (
            "weighting.pressure_thickness_from_inputs",
            (x, SPEC(ver), GRID, STATS(ver)), {})
        cases[f"weighting.pressure_thickness_from_inputs[{ver}, raw]"] = (
            "weighting.pressure_thickness_from_inputs",
            (xr, SPEC(ver), GRID, None), {})
        dp = JW.pressure_thickness_from_inputs(
            x, JV.get_varspec(ver), JG.load_default_grid(),
            JN.load_asset_norms(ver))
        for st in ("stats", "none"):
            stats = STATS(ver) if st == "stats" else None
            cases[f"weighting.weight_outputs[{ver}, {st}]"] = (
                "weighting.weight_outputs",
                (pred, SPEC(ver), GRID, dp, stats), {})
            cases[f"weighting.weight_outputs_sampled[{ver}, {st}]"] = (
                "weighting.weight_outputs_sampled",
                (samples, SPEC(ver), GRID, dp, stats), {})
        cases[f"weighting.weight_outputs[{ver}, no dp]"] = (
            "weighting.weight_outputs", (pred, SPEC(ver), GRID, None), {})
    return cases


def _scoring_cases():
    x, y, pred, samples = _split("v1")
    preds = {"m": pred, "n": y + 0.1}
    cases = {
        "scoring.offline_score": (
            "scoring.offline_score",
            (SPEC("v1"), GRID, STATS("v1"), x, y, preds), {}),
        "scoring.offline_score[crps]": (
            "scoring.offline_score",
            (SPEC("v1"), GRID, STATS("v1"), x, y, preds),
            {"samplepreds": {"m": samples}}),
        "scoring.offline_score[raw inputs, no stats]": (
            "scoring.offline_score",
            (SPEC("v1"), GRID, None, _split("v1", normalized=False)[0], y,
             preds), {"inputs_normalized": False}),
        "scoring.tables_to_dataframe": (
            "scoring.tables_to_dataframe",
            (JS.offline_score(JV.get_varspec("v1"), JG.load_default_grid(),
                              JN.load_asset_norms("v1"), x, y, preds)[0],),
            {}),
    }
    return cases


def _diag_cases():
    traj, ref = _traj()
    rng = np.random.default_rng(5)
    ps = rng.uniform(6.0e4, 1.03e5, 384)
    precc = 1e-8 * rng.normal(size=(8, 384)) + 5e-9
    qn = 1e-5 * rng.normal(size=(8, 384, 60))
    members = [traj + 0.5 * rng.normal(size=traj.shape) for _ in range(3)]
    h_win = rng.normal(size=(2, 3, 384, 60))
    m_win = rng.normal(size=(2, 3, 3, 384, 60))
    seg = rng.normal(size=(4, 3, 384, 60))
    return {
        "online_diags._weights": ("online_diags._weights", (GRID,), {}),
        "online_diags._weights[ps]": ("online_diags._weights", (GRID, ps),
                                      {}),
        "online_diags.weighted_rmse": (
            "online_diags.weighted_rmse", (traj, ref, GRID), {}),
        "online_diags.weighted_rmse[ps]": (
            "online_diags.weighted_rmse", (traj, ref, GRID, ps), {}),
        "online_diags.weighted_rmse[2d]": (
            "online_diags.weighted_rmse", (traj[..., 0], ref[..., 0], GRID),
            {}),
        "online_diags.window_mean_rmse": (
            "online_diags.window_mean_rmse", (traj, ref, GRID, 3), {}),
        "online_diags.window_means_from_segment_sums": (
            "online_diags.window_means_from_segment_sums", (seg, 2, 24), {}),
        "online_diags.gate_window_stats": (
            "online_diags.gate_window_stats", (h_win, m_win, GRID), {}),
        "online_diags.ensemble_window_floor": (
            "online_diags.ensemble_window_floor", (members, GRID, 4), {}),
        "online_diags.zonal_mean_bias": (
            "online_diags.zonal_mean_bias", (traj, ref, GRID), {}),
        "online_diags.error_growth": (
            "online_diags.error_growth", (traj, ref, GRID), {}),
        "online_diags.precip_stats": (
            "online_diags.precip_stats", (precc, GRID), {}),
        "online_diags.drift": ("online_diags.drift", (traj, GRID), {}),
        "online_diags.microphysics_checks": (
            "online_diags.microphysics_checks", (qn, traj, precc), {}),
        "online_diags.microphysics_checks[no precc]": (
            "online_diags.microphysics_checks", (qn, traj), {}),
        "online_diags.ensemble_noise_floor": (
            "online_diags.ensemble_noise_floor", (members, GRID), {}),
    }


def _analysis_cases():
    rng = np.random.default_rng(7)
    out = {}
    for ver in ("v1", "v5"):
        spec = JV.get_varspec(ver)
        y = rng.normal(size=(24 * 384, spec.output_len))
        out[f"analysis.reshape_daily[{ver}]"] = (
            "analysis.reshape_daily", (y, GRID),
            {"spec": SPEC(ver)} if ver != "v1" else {})
    pd_, td = rng.normal(size=(2, 10, 4, 60))
    out["analysis.daily_zonal_r2"] = ("analysis.daily_zonal_r2", (pd_, td),
                                      {})
    out["analysis.mean_pressure_by_lat"] = (
        "analysis.mean_pressure_by_lat", (GRID,), {})
    out["analysis.mean_pressure_by_lat[ps]"] = (
        "analysis.mean_pressure_by_lat",
        (GRID, rng.uniform(6.0e4, 1.03e5, 384)), {})
    return out


CASES = {**_metric_cases(), **_weighting_cases(), **_scoring_cases(),
         **_diag_cases(), **_analysis_cases()}


def run_case(case: str):
    fn, args, kw = CASES[case]
    want = _call("jax", fn, *args, **kw)
    got = _call("port", fn, *args, **kw)
    _equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_eval_copies_equal_jax(case):
    run_case(case)


def test_streaming_scorer_equals_jax():
    """StreamingScorer over chunks of 384 columns, with CRPS samples: the
    same tables as the JAX package's (its agreement with the in-memory
    scorer is tests/test_metrics.py's)."""
    x, y, pred, samples = _split("v1")
    tables = {}
    for pkg in ("jax", "port"):
        g, v, n = _env(pkg)
        mod = MODULES["streaming"][0 if pkg == "jax" else 1]
        sc = mod.StreamingScorer(v.get_varspec("v1"), g.load_default_grid(),
                                 n.load_asset_norms("v1"))
        for s in range(0, x.shape[0], 384):
            sc.update(x[s:s + 384], y[s:s + 384], {"m": pred[s:s + 384]},
                      {"m": samples[s:s + 384]})
        tables[pkg] = sc.tables()
    _equal(tables["port"], tables["jax"])


def test_cli_writes_the_jax_clis_csv(tmp_path):
    """The same .npy files through both CLIs: byte-equal CSV tables."""
    from climsim_tpu.eval import cli as jcli
    from climsim_tpu_torch.eval import cli as pcli

    x, y, pred, samples = _split("v1")
    files = {}
    for name, a in (("in", x), ("tgt", y), ("m", pred), ("s", samples)):
        files[name] = str(tmp_path / f"{name}.npy")
        np.save(files[name], a)
    for mod, out in ((jcli, "jax"), (pcli, "port")):
        mod.main(["--inputs", files["in"], "--targets", files["tgt"],
                  "--varspec", "v1", "--pred", f"m={files['m']}",
                  "--samples", f"m={files['s']}",
                  "--out-dir", str(tmp_path / out)])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == ["m_by_index.csv", "m_by_variable.csv"]
    assert sorted(os.listdir(tmp_path / "port")) == names
    _, mismatch, errors = filecmp.cmpfiles(tmp_path / "jax",
                                           tmp_path / "port", names,
                                           shallow=False)
    assert mismatch == [] and errors == []


def test_grid_properties_equal_jax():
    jg, pg = JG.load_default_grid(), PG.load_default_grid()
    assert (pg.ncol, pg.num_levels) == (jg.ncol, jg.num_levels) == (384, 60)
    np.testing.assert_array_equal(pg.area_wgt, jg.area_wgt)
    np.testing.assert_array_equal(pg.unique_lats, jg.unique_lats)
    _equal(pg.lat_indices(), jg.lat_indices())
    sub = pg.replace(lat=pg.lat[:16], area=pg.area[:16])
    assert isinstance(sub, PG.Grid) and sub.ncol == 16
    np.testing.assert_array_equal(sub.area_wgt,
                                  jg.replace(lat=jg.lat[:16],
                                             area=jg.area[:16]).area_wgt)
    assert pg.ncol == 384   # replace leaves the grid as it was


@pytest.mark.parametrize("version", ["v1", "v2_rh", "v4", "v5"])
def test_norms_from_data_with_cloud_rates_equal_jax(version):
    """compute_norms_from_data(qn_transform=True) bit-equal to JAX's: the
    cloud rates (qn for v5, qc and qi for v2_rh and v4) and the cloud
    inputs' sub/div in transformed space; v1 has no cloud input."""
    from climsim_tpu.data.synthetic import synthetic_split

    spec = JV.get_varspec(version)
    x, y = synthetic_split(spec, 768, JG.load_default_grid(), seed=4)
    want = JN.compute_norms_from_data(spec, x, y, qn_transform=True)
    got = PN.compute_norms_from_data(PV.get_varspec(version), x, y,
                                     qn_transform=True)
    for f in ("inp_sub", "inp_div", "out_scale", "lbd_qn", "lbd_qc",
              "lbd_qi"):
        a, b = getattr(want, f), getattr(got, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a)
    fields = {"v1": (), "v2_rh": ("lbd_qc", "lbd_qi"),
              "v4": ("lbd_qc", "lbd_qi"), "v5": ("lbd_qn",)}[version]
    assert [f for f in ("lbd_qn", "lbd_qc", "lbd_qi")
            if getattr(got, f) is not None] == list(fields)


def test_exponential_lambda_equals_jax():
    """Cloudy and cloud-free levels (the 1e7 fill)."""
    rng = np.random.default_rng(3)
    q = 1e-5 * rng.random((200, 60)) * (rng.random((200, 60)) < 0.3)
    q[:, :5] = 0.0
    q = q.astype(np.float32)
    want = JN.compute_exponential_lambda(q)
    got = PN.compute_exponential_lambda(q)
    np.testing.assert_array_equal(got, want)
    assert (got[:5] == 1e7).all()
