"""The port's HPO (train.hpo, a byte copy of the JAX module, and
python -m climsim_tpu_torch.run_hpo_sweep) on the CPU.

The counterparts of tests/test_ingest_hpo.py:129-222 run on the port's
copy; the sweep's trial function gives the JAX script's loss on the same
data, hp, weights and batch indices within rtol 1e-5 (float32 compute,
the mlp_trainer parity of tests/test_torch_train.py); and one whole
sweep runs on the host: 4 trials, 2 worker processes, one SIGKILLed while
it holds a claim, a stale timeout of 3 s."""

import functools
import importlib.util
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.train import recipes as JR
from climsim_tpu_torch import run_hpo_sweep as PS
from climsim_tpu_torch.data.synthetic import synthetic_split
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.train import hpo
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.utils.migrate import port_flax_mlp
from climsim_tpu_torch.varspec import get_varspec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_hpo_random_search(tmp_path):
    def trial(hp):
        return (hp["x"] - 0.3) ** 2 + (hp["y"] - 0.7) ** 2

    def sampler(rng):
        return {"x": float(rng.random()), "y": float(rng.random())}

    idx, best = hpo.random_search(trial, sampler, 50, str(tmp_path / "o"))
    assert best["score"] < 0.1


def test_hpo_oracle_multiworker(tmp_path):
    oracle = hpo.DirectoryOracle(str(tmp_path / "o2"))
    oracle.publish([{"v": i} for i in range(20)])
    done1 = hpo.run_worker(oracle, lambda hp: float(hp["v"]), max_trials=7)
    done2 = hpo.run_worker(oracle, lambda hp: float(hp["v"]))
    assert done1 == 7
    assert done1 + done2 == 20
    idx, best = oracle.best()
    assert idx == 0 and best["score"] == 0.0
    assert hpo.run_worker(oracle, lambda hp: 0.0) == 0


def test_hpo_stale_claim_takeover(tmp_path):
    """A claim with no result is retried once its marker is stale, within
    the retry budget (max_retries_per_trial=1, hpo_baseline_v1.py:232)."""
    oracle = hpo.DirectoryOracle(str(tmp_path))
    oracle.publish([{"lr": i} for i in range(3)])
    assert oracle.claim(1)
    old = time.time() - 3600
    os.utime(str(tmp_path / "claim_1"), (old, old))
    ran = []
    hpo.run_worker(oracle, lambda hp: ran.append(hp["lr"]) or 0.0)
    assert sorted(ran) == [0, 2]
    ran2 = []
    n = hpo.run_worker(oracle, lambda hp: ran2.append(hp["lr"]) or 0.0,
                       stale_timeout=1.0)
    assert ran2 == [1] and n == 1
    assert len(oracle.results()) == 3

    oracle2 = hpo.DirectoryOracle(str(tmp_path / "b"))
    oracle2.publish([{"lr": 0}])
    assert oracle2.claim(0)
    os.utime(str(tmp_path / "b" / "claim_0"), (old, old))
    assert oracle2.claim(0, stale_timeout=1.0)
    os.utime(str(tmp_path / "b" / "claim_0.retry1"), (old, old))
    assert not oracle2.claim(0, stale_timeout=1.0)
    assert oracle2.claim(0, stale_timeout=1.0, max_retries=2)


def test_hpo_hyperband():
    calls = []

    def trial(hp, resource):
        calls.append(resource)
        return (hp["x"] - 0.5) ** 2 + 1.0 / resource

    best_hp, best_score = hpo.hyperband(
        trial, lambda rng: {"x": float(rng.random())},
        directory="", max_resource=9, eta=3, seed=0)
    assert abs(best_hp["x"] - 0.5) < 0.25
    assert max(calls) == 9


def test_mlp_trial_sampler():
    rng = np.random.default_rng(0)
    hp = hpo.sample_mlp_trial(hpo.mlp_search_space(), rng)
    assert 2 <= len(hp["hidden"]) <= 12
    assert all(128 <= u <= 1024 and u % 128 == 0 for u in hp["hidden"])
    assert hp["activation"] in ("relu", "elu", "leakyrelu")
    # the sweep's reduced space draws what the JAX script's draws
    j = _jax_script()
    for s in range(5):
        assert PS.sample_trial(np.random.default_rng(s)) == j.sample_trial(
            np.random.default_rng(s))


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_run_hpo_sweep", os.path.join(ROOT, "scripts",
                                          "run_hpo_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def sweep_data(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hpo") / "data.npz")
    x, y = synthetic_split(get_varspec("v1"), 1024, load_default_grid(),
                           seed=0, noise=0.02)
    np.savez(path, x=x, y=y)
    return path


@pytest.mark.parametrize("seed", [0, 2, 4])
def test_trial_fn_matches_the_jax_script(sweep_data, seed, monkeypatch):
    """The same trial (hp from the same draw: adam, radam or rmsprop), the
    same weights (the JAX recipe's, ported), both at float32 compute: the
    port's score is the JAX script's within rtol 1e-5."""
    monkeypatch.setattr("climsim_tpu.models.ClimSimMLP", functools.partial(
        FlaxClimSimMLP, compute_dtype=jnp.float32))
    real = PR.mlp_trainer

    def from_jax(spec, stats, sample, rng, **kw):
        jt = JR.mlp_trainer(spec, stats, sample, jax.random.PRNGKey(0),
                            **{k: v for k, v in kw.items() if k != "device"})
        pt = real(spec, stats, sample, rng, compute_dtype=torch.float32,
                  **kw)
        pt.model.load_state_dict(port_flax_mlp(
            jax.tree.map(np.asarray, jt.state.params)))
        return pt

    monkeypatch.setattr(PR, "mlp_trainer", from_jax)
    hp = PS.sample_trial(np.random.default_rng(seed))
    ours = PS.make_trial_fn(sweep_data, 3, device="cpu")(hp)
    want = _jax_script().make_trial_fn(sweep_data, 3)(hp)
    assert np.isfinite(ours)
    np.testing.assert_allclose(ours, want, rtol=1e-5)


def test_sweep_end_to_end_with_a_killed_worker(tmp_path):
    """publish -> 2 worker processes (the victim SIGKILLed holding its
    claim) -> every trial has a result, the orphan taken over and
    completed -> Hyperband -> retrain_best -> the report, in the work
    directory."""
    out = PS.main(["--device", "cpu", "--trials", "4", "--workers", "2",
                   "--steps", "2", "--n-data", "512", "--stale-timeout", "3",
                   "--kill-after", "0.5", "--dir", str(tmp_path)])
    assert len(out["results"]) == 4 and out["takeovers"]
    assert all(np.isfinite(r["score"]) for r in out["results"].values())
    assert {r["worker"] for r in out["results"].values()} == {1}
    assert all(r["kernel1_launches"] == 0 for r in out["results"].values())
    assert np.isfinite(out["hyperband_score"])
    assert np.isfinite(out["final_score"])
    assert out["report"] == str(tmp_path / "HPO.md")
    text = (tmp_path / "HPO.md").read_text()
    assert "claim_N.retryK" in text and "retrain_best" in text
