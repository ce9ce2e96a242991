"""The port's online evaluation entry (``climsim_tpu_torch.online_eval``)
and ``probe_mean``, on the CPU (``--device cpu``), against the JAX
script (``scripts/online_eval.py``, run as tests/test_online.py runs it).

* The flows of tests/test_online.py:195-253 (every optional training
  phase; the two-stage scheme) and a flow with ``--ft-steps 2 --ft-k 2``
  whose fine-tune must move the parameters; the oracle's mean contract
  (tests/test_online.py:256-305).
* ``make_oracle_wrapper`` and ``build_balanced_forcing`` equal to the JAX
  functions on the same inputs: rtol 1e-5 (float32), atol 1e-5 of the
  field's largest value (the tanh map is steep, gain 64: float32 sums
  that differ in order move an output by up to a few 1e-6 of its scale).
* The evaluation half against JAX: the JAX script runs tiny with
  ``--cache``, on flax U-Net weights written to its params cache (so it
  trains nothing): flax's init, whose blocks sit near their skips, with
  the output conv at full xavier scale, the shape of a briefly trained
  model.  It computes the norm stats and the tendency correction; the
  port's ``main`` with the same flags and cache loads those stats, params
  (through the porter) and correction and runs the ensemble, the hybrid
  and the diagnostics.  Measured on this CPU at 4 steps: the floor 1.9e-6
  relative from JAX's, the monthly-mean RMSEs within 2.3e-6, the micro
  statistics within 7e-6, the cloud fraction one level of the 92,160
  apart (1.1e-5), the Q and U member floors (values near 1e-7 and 1e-4)
  within 5.7e-4: JAX keeps q1 in float64 under x64, the port in float32.
  The system is chaotic by design (gain 64), so the gaps grow with the
  steps: at 12 steps the T floor's windows 2.6e-5, the Q and U floors'
  3.2e-3, the largest water residual 3.7e-4.  Held at 4 steps: floor,
  RMSEs and micro statistics rtol 1e-4, the Q and U floors rtol 1e-3, the
  fractions atol 2 / 92,160.
* ``probe_mean`` on that cache prints both diagnoses.
"""

import importlib.util
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import load_default_grid as jax_grid
from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.online import driver as JD
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch import online_eval as P
from climsim_tpu_torch import probe_mean
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.online import driver as PD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC4, SPEC5 = get_varspec("v4"), get_varspec("v5")
GRID = load_default_grid()
TINY = ["--steps", "4", "--window", "2", "--batch", "64", "--channels", "8",
        "--spinup-days", "0"]
EVAL_FLAGS = TINY + ["--train-steps", "4", "--bias-correct", "2",
                     "--bias-iters", "1"]
HALF_RTOL, QU_FLOOR_RTOL = 1e-4, 1e-3
FRACTIONS = ("frac_negative_qn", "frac_cloudy", "frac_cold_cloud")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These networks are tiny: one intra-op thread does their work at a
    third of the CPU time of eight, and keeps a loaded host's cores for
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "online_eval_for_port", os.path.join(ROOT, "scripts",
                                             "online_eval.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flow_checks(out, tmp_path, sfx=""):
    assert np.isfinite(out["floor"]) and out["floor"] > 0
    assert len(out["win_rmse"]) == 2
    assert all(np.isfinite(r) for r in out["win_rmse"])
    assert os.path.exists(out["report"]) and out["figures"]
    for f in ("online_error_growth", "online_zonal_bias",
              "online_monthly_rmse", "online_precip"):
        assert os.path.exists(str(tmp_path / "figures" / f"{f}{sfx}.torch.png")), f


def test_online_eval_flow(tmp_path):
    """Train -> wrap -> hybrid rollout vs the perturbed-IC oracle ensemble
    -> report + figures, with DAgger, the fresh-Adam polish and the
    tendency correction."""
    out = P.main(TINY + ["--train-steps", "4", "--dagger-rounds", "1",
                         "--dagger-steps", "2", "--dagger-collect", "2",
                         "--polish-steps", "2", "--polish-lr", "1e-4",
                         "--bias-correct", "2", "--bias-iters", "1",
                         "--device", "cpu", "--out", str(tmp_path)])
    _flow_checks(out, tmp_path)
    assert out["scheme"] == "regressor" and out["cls_acc"] is None
    assert set(out["phase_seconds"]) >= {"5 (ensemble)", "6 (hybrid)"}


def test_online_eval_two_stage_flow(tmp_path, capsys):
    out = P.main(["--steps", "4", "--window", "2", "--train-steps", "2",
                  "--batch", "32", "--channels", "8", "--spinup-days", "0",
                  "--scheme", "two_stage", "--cls-train-steps", "2",
                  "--device", "cpu", "--out", str(tmp_path)])
    assert out["scheme"] == "two_stage"
    assert np.isfinite(out["cls_acc"]) and 0.0 <= out["cls_acc"] <= 1.0
    assert out["report"].endswith("ONLINE_EVAL_two_stage.torch.md")
    assert np.isfinite(out["micro"]["frac_negative_qn"])
    _flow_checks(out, tmp_path, "_two_stage")
    txt = open(out["report"]).read()
    assert "two-stage" in txt and "classifier" in txt
    # which pool the classifier trained on is printed
    assert "classifier: training on the clean collection" in \
        capsys.readouterr().out
    with pytest.raises(SystemExit):
        P.parse_args(["--scheme", "two_stage", "--ft-steps", "2"])


def test_online_eval_finetune_flow(tmp_path):
    """--ft-steps 2 --ft-k 2 through HybridDriver(remat=True): the cached
    fine-tuned parameters differ from the supervised ones they start
    from."""
    cache = tmp_path / "cache"
    flags = TINY + ["--train-steps", "4", "--ft-steps", "2", "--ft-k", "2",
                    "--cache", str(cache), "--device", "cpu",
                    "--out", str(tmp_path)]
    out = P.main(flags)
    _flow_checks(out, tmp_path)
    first, last = out["ft_loss"]
    assert np.isfinite(first) and np.isfinite(last) and first > 0
    args = P.parse_args(flags)
    paths = P.cache_paths(args, P.collection_steps(
        args, P.geometry(args)[3], GRID.ncol))
    with open(P._torch_path(paths["params"]), "rb") as f:
        before = pickle.load(f)["state_dict"]
    with open(P._torch_path(paths["ft"]), "rb") as f:
        after = pickle.load(f)["state_dict"]
    assert set(before) == set(after)
    moved = [k for k in before if not np.array_equal(before[k], after[k])]
    assert len(moved) >= len(before) - 1, sorted(set(before) - set(moved))
    # a rerun takes every phase from the cache
    again = P.main(flags)
    assert again["ft_loss"] == out["ft_loss"]
    np.testing.assert_allclose(again["win_rmse"], out["win_rmse"],
                               rtol=1e-6)


def test_oracle_systematic_mean_contract():
    """mean_gain 0 is the anomaly-only system; at mean_gain 3 the top 15
    output levels stay mean-free, the output shifts by exactly the
    returned profiles, and q's systematic drying is non-positive."""
    out = {}
    for g in (0.0, 3.0):
        _, oracle_v5, fit_std, prof = P.make_oracle_wrapper(
            SPEC5, SPEC4, tend_scale=0.1, gain=64.0, mean_gain=g,
            device="cpu")
        x = synthetic_inputs(SPEC5, 4 * GRID.ncol, GRID, seed=0)
        x[:, SPEC5.input_slices["icol"]] = (
            np.arange(x.shape[0]) % GRID.ncol + 1)[:, None]
        fit_std(x)
        out[g] = oracle_v5(torch.from_numpy(x)).numpy(), prof
    y0, prof0 = out[0.0]
    y3, prof3 = out[3.0]
    assert prof0 == {}
    assert set(prof3) == {"ptend_t", "ptend_q0001", "ptend_u"}
    for v, p in prof3.items():
        sl = SPEC5.output_slices[v]
        np.testing.assert_array_equal(p[:15], 0.0)
        assert np.abs(p[24:]).max() > 0
        np.testing.assert_allclose(
            y3[:, sl] - y0[:, sl], np.broadcast_to(p, y0[:, sl].shape),
            atol=1e-7)
    assert (prof3["ptend_q0001"] <= 0).all()


def _close(got, want, rtol=1e-5, atol_rel=1e-5, msg=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol_rel * np.abs(want).max(),
                               err_msg=msg)


def test_oracle_and_forcing_match_jax():
    mod = jax_script()
    x = synthetic_inputs(SPEC5, 4 * GRID.ncol, GRID, seed=0)
    x[:, SPEC5.input_slices["icol"]] = (
        np.arange(x.shape[0]) % GRID.ncol + 1)[:, None]
    x4 = synthetic_inputs(SPEC4, 2 * GRID.ncol, GRID, seed=11)
    jw, jo, jfit, jprof = mod.make_oracle_wrapper(
        SPEC5, SPEC4, tend_scale=0.1, gain=64.0, mean_gain=3.0)
    pw, po, pfit, pprof = P.make_oracle_wrapper(
        SPEC5, SPEC4, tend_scale=0.1, gain=64.0, mean_gain=3.0,
        device="cpu")
    jfit(x)
    pfit(x)
    assert set(jprof) == set(pprof)
    for k in jprof:
        np.testing.assert_array_equal(jprof[k], pprof[k])
    x5 = synthetic_inputs(SPEC5, 96, GRID, seed=12)
    _close(po(torch.from_numpy(x5)), jo(jnp.asarray(x5)), msg="oracle_v5")
    _close(pw(torch.from_numpy(x4)), jw(None, jnp.asarray(x4)),
           msg="wrapper")
    # the balanced forcing, on a state moved off the climatology
    sj = JD.initial_state(x4[:GRID.ncol], jax_grid())
    sp = PD.initial_state(x4[:GRID.ncol], GRID, device="cpu")
    fj = mod.build_balanced_forcing(sj, jprof, 2.0, 1.5, jax_grid())
    fp = P.build_balanced_forcing(sp, pprof, 2.0, 1.5, GRID, "cpu")
    moved = PD.map_state(lambda a: a, sp)
    moved = PD.ColumnState(**{**moved.__dict__, "t": sp.t + 1.5,
                              "u": sp.u - 2.0})
    mj = JD.ColumnState(**{k: jnp.asarray(v.numpy())
                           for k, v in moved.__dict__.items()})
    for step in (0, 17, 40):
        _close(fp(moved, step), fj(mj, jnp.asarray(step)),
               msg=f"forcing at {step}")


# -- the evaluation half against JAX ---------------------------------------
@pytest.fixture(scope="module")
def jax_cache(tmp_path_factory):
    """The JAX script's run on flax U-Net weights written to its params
    cache: (the cache, its result, the params file, the stats file)."""
    root = tmp_path_factory.mktemp("oe_half")
    cache = root / "cache"
    flags = EVAL_FLAGS + ["--cache", str(cache)]
    args = P.parse_args(flags)
    paths = P.cache_paths(args, P.collection_steps(
        args, P.geometry(args)[3], GRID.ncol))
    fm = FlaxUNet(spec=SPEC5, model_channels=8, channel_mult=(1, 2, 2),
                  num_blocks=2, attn_resolutions=(16,), output_prune=True)
    tree = jax.tree.map(np.asarray, fm.init(
        jax.random.PRNGKey(3), jnp.zeros((2, SPEC5.input_len)))["params"])
    k = tree["out_conv"]["Conv_0"]["kernel"]
    lim = np.sqrt(6.0 / ((k.shape[1] + k.shape[2]) * k.shape[0]))
    tree["out_conv"]["Conv_0"]["kernel"] = np.random.default_rng(5).uniform(
        -lim, lim, k.shape).astype(np.float32)
    os.makedirs(cache)
    with open(paths["params"], "wb") as f:
        pickle.dump({"params": {"params": tree}, "loss": 0.0,
                     "n_samples": 0}, f)
    out = jax_script().main(flags + ["--out", str(root / "jax")])
    return flags, out, root, paths


def test_evaluation_half_matches_jax(jax_cache):
    flags, want, root, paths = jax_cache
    got = P.main(flags + ["--device", "cpu", "--out", str(root / "port")])
    # the port trained and fitted nothing: it wrote no file of its own
    assert not [f for f in os.listdir(os.path.dirname(paths["params"]))
                if ".torch." in f]
    assert got["verdict"] == want["verdict"]
    gaps = {"floor": abs(got["floor"] / want["floor"] - 1)}
    np.testing.assert_allclose(got["floor"], want["floor"], rtol=HALF_RTOL)
    np.testing.assert_allclose(got["win_rmse"], want["win_rmse"],
                               rtol=HALF_RTOL)
    gaps["win_rmse"] = float(np.max(np.abs(
        np.asarray(got["win_rmse"]) / np.asarray(want["win_rmse"]) - 1)))
    for v in ("t", "q1", "u"):
        np.testing.assert_allclose(
            got["floors_by_var"][v], want["floors_by_var"][v],
            rtol=HALF_RTOL if v == "t" else QU_FLOOR_RTOL, err_msg=v)
    n = 4 * GRID.ncol * 60
    for k, w in want["micro"].items():
        if k in FRACTIONS:
            np.testing.assert_allclose(got["micro"][k], w, rtol=0,
                                       atol=2 / n, err_msg=k)
        else:
            np.testing.assert_allclose(got["micro"][k], w, rtol=HALF_RTOL,
                                       err_msg=k)
            gaps[k] = abs(got["micro"][k] / w - 1)
    print("evaluation half, relative gaps to JAX:",
          {k: f"{v:.2e}" for k, v in gaps.items()})


def test_probe_mean_on_the_jax_cache(jax_cache, capsys, monkeypatch):
    _, _, _, paths = jax_cache
    monkeypatch.setattr(probe_mean, "SEG", 12)
    probe_mean.main([paths["params"], paths["stats"], "--channels", "8",
                     "--spinup-days", "0", "--hybrid-days", "0.2",
                     "--device", "cpu"])
    out = capsys.readouterr().out
    assert "(a) supervised mean-tendency error" in out
    assert "(b) coupled per-level state bias" in out
    for v in ("ptend_t", "ptend_q0001", "ptend_u", "T [K]", "q1", "u"):
        assert v in out
    assert "nan" not in out.lower()
