"""The port's experiment runner (``python -m climsim_tpu_torch.run``)
against the JAX package's ``run_experiment`` on the CPU: the same preset,
the same synthetic split, the same initial weights (each trainer the JAX
runner builds is ported into the one the port's runner builds), float32
compute on both sides.  Per-epoch train and validation losses within the
train steps' tolerance, rtol 1e-5 (test_torch_train.py).  Then the port's
own behaviour: the branches it refuses, a warm restart, the manifest and
the CLI."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import climsim_tpu.run as JRUN
from climsim_tpu.config import PRESETS as JPRESETS
from climsim_tpu.train import rpn_recipe as JRR
from climsim_tpu_torch import run as PRUN
from climsim_tpu_torch.config import PRESETS
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train import rpn_recipe as PRR
from climsim_tpu_torch.utils import migrate as PM
from test_torch_zoo_train import f32_model

F32 = torch.float32
SMALL = ("data.num_synthetic=512", "data.batch_size=64",
         "train.num_data_shards=1")
CASES = {
    "cnn_v1": ("ClimSimCNN", PM.port_flax_cnn, 'model_kw={"depth": 2, '
               '"channels": 16, "dropout": 0.0}', "train.epochs=2"),
    "hsr_v1": ("HSR", PM.port_flax_hsr, 'model_kw={"hidden": 32, '
               '"layers": 2}', "train.epochs=3"),
    "rpn_v1": (None, None, 'model_kw={"ensemble_size": 3, "hidden": '
               '[32, 24]}', "train.epochs=2"),
    "cvae_v1": ("CVAE", PM.port_flax_cvae, 'model_kw={"latent": 4, '
                '"hidden": 32, "layers": 2}', "train.epochs=2",
                "train.seeds=[0, 5]"),
}


def _jax_run(monkeypatch, preset, overrides, model):
    """The JAX runner's history, and the initial parameters (numpy) of
    every trainer it built, in order."""
    built = []
    if model is None:
        monkeypatch.setattr(JRR, "RPNEnsemble", functools.partial(
            JRR.RPNEnsemble, compute_dtype=jnp.float32))
        orig = JRR.rpn_trainer

        def rpn(*a, **kw):
            tr = orig(*a, **kw)
            built.append(tuple(jax.tree.map(np.asarray, p)
                               for p in (tr.params, tr.prior)))
            return tr

        monkeypatch.setattr(JRR, "rpn_trainer", rpn)
    else:
        f32_model(monkeypatch, model)
        orig = JRUN.build_trainer

        def build(*a, **kw):
            tr = orig(*a, **kw)
            built.append(jax.tree.map(np.asarray, tr.state.params))
            return tr

        monkeypatch.setattr(JRUN, "build_trainer", build)
    out = JRUN.run_experiment(JPRESETS[preset].override(*overrides),
                              verbose=False)
    return out["history"].rows, built


def _feed_cvae_noise(monkeypatch, seeds, steps, batch, latent):
    """The eps of the JAX runner's cVAE replicas (replica k's state key
    fold_in(PRNGKey(seeds[k]), 1), split once a step; PRNGKey(0) in
    evaluation), fed to the port's replicas in the order its loop draws
    them: a step's replicas in turn."""
    keys = [jax.random.fold_in(jax.random.PRNGKey(s), 1) for s in seeds]
    queue = []
    for _ in range(steps):
        for k in range(len(keys)):
            keys[k], sub = jax.random.split(keys[k])
            queue.append(np.array(jax.random.normal(sub, (batch, latent),
                                                    jnp.float32)))

    def normal(seed, shape, device):
        if seed is None:
            return torch.from_numpy(np.asarray(jax.random.normal(
                jax.random.PRNGKey(0), tuple(shape), jnp.float32)).copy())
        return torch.from_numpy(queue.pop(0))

    monkeypatch.setattr(PR, "_normal", normal)


@pytest.mark.parametrize("preset", sorted(CASES))
def test_run_experiment_matches_jax(monkeypatch, preset):
    model, porter, *overrides = CASES[preset]
    overrides = (*SMALL, *overrides)
    jrows, built = _jax_run(monkeypatch, preset, overrides, model)
    trees = list(built)
    if model is None:
        orig = PRR.rpn_trainer

        def rpn(*a, **kw):
            tr = orig(*a, compute_dtype=F32, **kw)
            tr.ensemble.load_state_dict(PM.port_flax_rpn(*trees.pop(0)))
            return tr

        monkeypatch.setattr(PRUN, "rpn_trainer", rpn)
    else:
        name = {"ClimSimCNN": "cnn", "HSR": "hsr", "CVAE": "cvae"}[model]
        monkeypatch.setattr(PR, f"{name}_trainer", functools.partial(
            getattr(PR, f"{name}_trainer"), compute_dtype=F32))
        orig = PRUN.build_trainer

        def build(*a, **kw):
            tr = orig(*a, **kw)
            tr.model.load_state_dict(porter(trees.pop(0)))
            return tr

        monkeypatch.setattr(PRUN, "build_trainer", build)
    cfg = PRESETS[preset].override(*overrides)
    if model == "CVAE":
        steps = (512 - 64) // 64 * cfg.train.epochs
        _feed_cvae_noise(monkeypatch, cfg.train.seeds, steps, 64, 4)
    out = PRUN.run_experiment(cfg, verbose=False, device="cpu")
    assert not trees   # every trainer JAX built was ported
    prows = out["history"].rows
    assert len(prows) == len(jrows) == cfg.train.epochs
    for p, j in zip(prows, jrows):
        assert p["epoch"] == j["epoch"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(p[k], j[k], rtol=1e-5, err_msg=k)
            assert np.isfinite(p[k])
    if preset == "hsr_v1":   # one MSE-stage epoch, then the NLL's
        assert [r["epoch"] for r in prows] == [0, 0, 1]
    if preset == "cvae_v1":
        assert out["trainer"].num_seeds == 2


def _tiny(*more):
    return PRESETS["mlp_v1"].override(
        'model_kw={"hidden": [16]}', "train.epochs=2",
        "data.num_synthetic=256", "data.batch_size=64", *more)


@pytest.mark.parametrize("override,error,match", [
    ('train.elastic=true model="hsr"', ValueError, "staged loss"),
    ("train.num_data_shards=2", ValueError, "needs 2 processes")])
def test_distributed_branches_raise(override, error, match):
    """train.elastic refuses HSR's staged loss, as the JAX runner does; a
    data-parallel run outside torchrun (world size 1) refuses to train on
    fewer ranks than asked."""
    with pytest.raises(error, match=match):
        PRUN.run_experiment(_tiny(*override.split()), verbose=False,
                            device="cpu")


@pytest.mark.parametrize("preset,extra", [("mlp_v1", "train.seeds=[0, 1]"),
                                          ("rpn_v1", "train.epochs=1")])
def test_restart_refused_off_the_fit_path(tmp_path, preset, extra):
    """The RPN and multi-seed branches would train from scratch: a warm
    restart there raises, as in the JAX runner."""
    cfg = PRESETS[preset].override(extra,
                                   f'train.restart_path="{tmp_path}"')
    with pytest.raises(ValueError, match="restart_path"):
        PRUN.run_experiment(cfg, verbose=False, device="cpu")


def test_warm_restart_and_manifest(tmp_path, monkeypatch):
    """A checkpointed run writes its manifest and checkpoints; a run
    restarted from the directory has the last checkpoint's weights in its
    live parameters before its first step, and starts below the first
    run's first epoch."""
    ck = tmp_path / "ck"
    out = PRUN.run_experiment(_tiny(f'train.checkpoint_dir="{ck}"'),
                              verbose=False, device="cpu")
    man = json.loads((ck / "run_manifest.json").read_text())
    assert man["config"]["model"] == "mlp" and man["device"] == "cpu"
    assert man["torch"] == torch.__version__
    saved = torch.load(ck / "last.pt", weights_only=True)
    loaded = []
    orig = PRUN._restart

    def restart(tr, path, verbose):
        live = list(tr.model.parameters())
        orig(tr, path, verbose)
        assert all(a is b for a, b in zip(live, tr.model.parameters()))
        loaded.append({k: v.clone() for k, v in
                       tr.model.state_dict().items()})

    monkeypatch.setattr(PRUN, "_restart", restart)
    out2 = PRUN.run_experiment(_tiny(f'train.restart_path="{ck}"',
                                     "train.epochs=1"),
                               verbose=False, device="cpu")
    assert set(loaded[0]) == set(saved)
    for k, v in saved.items():
        torch.testing.assert_close(loaded[0][k], v, rtol=0, atol=0)
    assert out2["history"].rows[0]["train_loss"] < \
        out["history"].rows[0]["train_loss"]


def test_cli_runs_a_preset(capsys):
    out = PRUN.main(["--device", "cpu", "--preset", "ed_v1",
                     "train.epochs=1", "data.num_synthetic=256",
                     "data.batch_size=64"])
    assert len(out["history"].rows) == 1
    assert "epoch 0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        PRUN.main([])


def test_bench_cnn_arms_and_its_refusal(capsys, monkeypatch):
    """bench_cnn builds each arm's trainer (a step on the CPU here is
    finite; the float32 arm's convolutions are float32) and, without a
    card, refuses and prints no result."""
    from climsim_tpu_torch import bench_cnn

    for arm, kw in bench_cnn.ARMS.items():
        tr, xb, yb = bench_cnn.build_arm(arm, "cpu", batch=4, depth=1)
        blk = tr.model.blocks[0]
        assert blk.conv0.weight.shape[0] == kw["channels"]
        assert blk.dropout == kw.get("dropout", 0.175)
        assert blk.conv0.compute_dtype == (
            torch.float32 if arm == "float32 convs" else torch.bfloat16)
        _, m = tr.train_step(tr.state, xb, yb)
        assert np.isfinite(float(m["loss"]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_cnn.main([]) != 0
    assert "arms" not in capsys.readouterr().out


def test_bench_cnn_trace_parts_and_its_refusal(capsys, monkeypatch):
    """--trace files each aten op of a cnn_v1 step under one part (the k = 3
    convolutions forward and backward, the 1x1 convolutions' products, the
    casts and copies, dropout, Adam) and, without a card, refuses and
    prints no result."""
    from climsim_tpu_torch import bench_cnn

    want = {"aten::cudnn_convolution": "k = 3 convolutions",
            "aten::convolution_backward": "k = 3 convolutions",
            "aten::mm": "1x1 convolutions (products)",
            "aten::copy_": "casts and copies",
            "aten::_to_copy": "casts and copies",
            "aten::uniform_": "dropout",
            "aten::where": "dropout",
            "aten::_foreach_mul_": "Adam",
            "aten::elu": "the rest"}
    assert {op: bench_cnn._part(op) for op in want} == want
    report = bench_cnn.trace_report({
        "step_ms": 3.0, "kernels_ms": 3.5,
        "by_part": {"k = 3 convolutions": 2.0, "the rest": 1.0},
        "by_op": {"aten::convolution_backward": 2.0},
        "by_kernel": {"sm90_xmma": 2.0},
        "conv3": {"float32, transposed view (the model's)":
                  {"ms": 1.0, "tflop_s": 2.5}}})
    assert "66.7%" in report and "2.50 TFLOP/s" in report
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_cnn.main(["--trace"]) != 0
    assert "trace" not in capsys.readouterr().out
