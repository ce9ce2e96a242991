"""The port's training loop (climsim_tpu_torch.train.loop) against
climsim_tpu.train.loop.

``fit`` for two epochs of the v1 mlp_trainer at float32 compute, from the
same weights, on the same unshuffled batches, with validation, the
plateau controller, early stopping and a top-K checkpointer, through the
epoch runner and through the per-batch loop: each epoch's train and
validation loss within rtol 1e-5, the parameters within atol 2e-6 (the
train steps' tolerances, tests/test_torch_train.py), the top-K entries'
metrics within rtol 1e-5 and their steps equal.  The plateau and early
stopping controllers against JAX's on fixed loss sequences, exactly (the
same float64 arithmetic)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data.pipeline import DeviceResidentLoader as JaxLoader
from climsim_tpu.data.synthetic import synthetic_split
from climsim_tpu.grid import load_default_grid
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.train import loop as JL
from climsim_tpu.train import recipes as JR
from climsim_tpu.train.checkpoints import TopKCheckpointer as JaxTopK
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
from climsim_tpu_torch.train import loop as PL
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train.checkpoints import TopKCheckpointer
from climsim_tpu_torch.utils.migrate import port_flax_mlp

SPEC = get_varspec("v1")
HIDDEN = (32, 24)
B = 64


@pytest.fixture(scope="module")
def data():
    x, y = synthetic_split(SPEC, 8 * B, load_default_grid(), seed=0)
    return x[:6 * B], y[:6 * B], x[6 * B:], y[6 * B:]


@pytest.mark.parametrize("fused", [True, False])
def test_fit_matches_jax(data, monkeypatch, tmp_path, fused):
    xt, yt, xv, yv = data
    stats = load_asset_norms("v1")
    monkeypatch.setattr("climsim_tpu.models.ClimSimMLP", functools.partial(
        FlaxClimSimMLP, compute_dtype=jnp.float32))
    jt = JR.mlp_trainer(SPEC, stats, (xt, yt), jax.random.PRNGKey(0),
                        hidden=HIDDEN, steps_per_epoch=6)
    pt = PR.mlp_trainer(SPEC, stats, (xt, yt), 0, hidden=HIDDEN,
                        steps_per_epoch=6, compute_dtype=torch.float32,
                        device="cpu")
    pt.model.load_state_dict(port_flax_mlp(
        jax.tree.map(np.asarray, jt.state.params)))

    val = [(xv[:B], yv[:B]), (xv[B:], yv[B:])]
    js, jh = JL.fit(
        jt.train_step, jt.eval_step, jt.state,
        JaxLoader(xt, yt, B, shuffle=False),
        [tuple(map(jnp.asarray, b)) for b in val], epochs=2,
        ckpt=JaxTopK(str(tmp_path / "jax"), k=1),
        plateau=JL.PlateauController(patience=1),
        early=JL.EarlyStopping(patience=1), verbose=False, fused=fused)
    ps, ph = PL.fit(
        pt.train_step, pt.eval_step, pt.state,
        DeviceResidentLoader(xt, yt, B, shuffle=False, device="cpu"),
        [tuple(map(torch.from_numpy, b)) for b in val], epochs=2,
        ckpt=TopKCheckpointer(str(tmp_path / "port"), k=1),
        plateau=PL.PlateauController(patience=1),
        early=PL.EarlyStopping(patience=1), verbose=False, fused=fused)

    assert len(ph.rows) == len(jh.rows) == 2
    for got, want in zip(ph.rows, jh.rows):
        assert got["epoch"] == want["epoch"]
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert ps.step == int(js.step) == 12
    assert ps.lr_scale == float(js.lr_scale)
    want = port_flax_mlp(jax.tree.map(np.asarray, js.params))
    for k, v in ps.params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    (jm, jstep, _), = JaxTopK(str(tmp_path / "jax"), k=1)._entries
    (pm, pstep, name), = TopKCheckpointer(str(tmp_path / "port"),
                                          k=1)._entries
    np.testing.assert_allclose(pm, jm, rtol=1e-5)
    assert pstep == jstep == 12 and name == "ckpt_step12.pt"


LOSSES = [1.0, 0.9, 0.95, 0.95, 0.96, 0.8, 0.8 + 1e-13, 0.81, 0.82, 0.83,
          0.84, 0.7, 0.71, 0.72, 0.73, 0.74, 0.75]


@pytest.mark.parametrize("patience", [1, 2, 3])
def test_controllers_match_jax(patience):
    """The plateau's scale and both controllers' state after each loss of
    a fixed sequence (an improvement within 1e-12 does not count)."""
    jp = JL.PlateauController(patience=patience, factor=0.3, min_scale=0.05)
    pp = PL.PlateauController(patience=patience, factor=0.3, min_scale=0.05)
    je, pe = (JL.EarlyStopping(patience=patience),
              PL.EarlyStopping(patience=patience))
    stops = 0
    for v in LOSSES:
        assert pp.update(v) == jp.update(v)
        assert (pp.best, pp.bad_epochs) == (jp.best, jp.bad_epochs)
        stop = pe.should_stop(v)
        assert stop == je.should_stop(v)
        assert (pe.best, pe.bad_epochs) == (je.best, je.bad_epochs)
        stops += stop
    assert pp.scale < 1.0 and stops > 0


def test_history_csv_matches_jax(tmp_path):
    rows = [dict(epoch=i, train_loss=0.5 / (i + 1), val_loss=np.nan,
                 samples_per_sec=1e6 + i) for i in range(3)]
    jh, ph = JL.History(), PL.History()
    for r in rows:
        jh.log(**r)
        ph.log(**r)
    jh.save_csv(str(tmp_path / "jax.csv"))
    ph.save_csv(str(tmp_path / "port.csv"))
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()


def test_evaluate_weights_batches_by_size():
    """The batch-size-weighted mean of the losses, as JAX's evaluate."""
    batches = [(torch.zeros(n, 2), torch.full((n, 1), float(n)))
               for n in (3, 5)]

    def eval_step(params, xb, yb):
        return {"loss": yb.mean()}

    want = JL.evaluate(lambda p, xb, yb: {"loss": jnp.mean(yb)}, None,
                       [(b[0].numpy(), b[1].numpy()) for b in batches])
    assert PL.evaluate(eval_step, None, batches) == want == (9 + 25) / 8


def test_fit_refuses_a_chunked_loader():
    class Chunked:
        def make_chunk_runner(self, step):
            raise AssertionError("not reached")

    with pytest.raises(NotImplementedError, match="chunk"):
        PL.fit(None, None, None, Chunked(), None, epochs=1)
