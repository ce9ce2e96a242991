"""The port's streaming loaders (climsim_tpu_torch.data.pipeline
BatchLoader, ChunkedLoader, BootstrapLoader) and fit's chunk-runner
branch, on the CPU, against climsim_tpu.data.pipeline and
climsim_tpu.train.loop.

The loaders draw their indices from numpy's default_rng(seed), as the JAX
loaders do, so every batch must equal the JAX loader's bit for bit, also
after set_epoch.  fit over a ChunkedLoader against the JAX fit over its
ChunkedLoader, on a tiny mlp_trainer at float32 compute from the same
weights: each epoch's train and validation loss within rtol 1e-5, the
parameters within atol 2e-6 (tests/test_torch_loop.py's tolerances).
The chunk runner against the per-step loop on the same superbatches:
bit-equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import pipeline as JP
from climsim_tpu.data.synthetic import synthetic_split
from climsim_tpu.grid import load_default_grid
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.train import loop as JL
from climsim_tpu.train import recipes as JR
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data import pipeline as PP
from climsim_tpu_torch.train import loop as PL
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.utils.migrate import port_flax_mlp

N, D = 1000, 6
SPEC = get_varspec("v1")
HIDDEN = (32, 24)
B, K = 64, 2


def _data():
    """Row r carries r in column 0 (exact in float32) beside noise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[:, 0] = np.arange(N)
    y = rng.standard_normal((N, 3)).astype(np.float32)
    y[:, 0] = np.arange(N)
    return x, y


def _epochs(loader, n):
    return [[(np.asarray(a), np.asarray(b)) for a, b in loader]
            for _ in range(n)]


def _same(ours, ref):
    assert len(ours) == len(ref)
    for eo, er in zip(ours, ref):
        assert len(eo) == len(er) and len(eo) > 0
        for (xo, yo), (xr, yr) in zip(eo, er):
            assert xo.dtype == xr.dtype and xo.shape == xr.shape
            np.testing.assert_array_equal(xo, xr)
            np.testing.assert_array_equal(yo, yr)


@pytest.mark.parametrize("shuffle,drop", [(True, True), (False, True),
                                          (True, False)])
def test_batch_loader_equals_jax(shuffle, drop):
    x, y = _data()
    kw = dict(shuffle=shuffle, seed=3, drop_remainder=drop)
    ours = PP.BatchLoader(x, y, 96, device="cpu", **kw)
    ref = JP.BatchLoader(x, y, 96, **kw)
    assert ours.steps_per_epoch == ref.steps_per_epoch == (10 if drop
                                                           else 11)
    _same(_epochs(ours, 3), _epochs(ref, 3))


def test_batch_loader_set_epoch_equals_jax():
    x, y = _data()
    ours = PP.BatchLoader(x, y, 128, seed=5, device="cpu")
    ref = JP.BatchLoader(x, y, 128, seed=5)
    ours.set_epoch(2)
    ref.set_epoch(2)
    _same(_epochs(ours, 2), _epochs(ref, 2))
    first = _epochs(PP.BatchLoader(x, y, 128, seed=5, device="cpu"), 3)
    ours.set_epoch(1)
    _same(_epochs(ours, 2), first[1:])


def test_batch_loader_reads_a_memory_map(tmp_path):
    x, y = _data()
    np.save(tmp_path / "x.npy", x)
    np.save(tmp_path / "y.npy", y)
    xm = np.load(tmp_path / "x.npy", mmap_mode="r")
    ym = np.load(tmp_path / "y.npy", mmap_mode="r")
    _same(_epochs(PP.BatchLoader(xm, ym, 100, seed=1, device="cpu"), 2),
          _epochs(JP.BatchLoader(x, y, 100, seed=1), 2))


@pytest.mark.parametrize("k,b", [(2, 64), (4, 50), (3, 333)])
def test_chunked_loader_equals_jax(k, b):
    """(K, B, D) superbatches equal to JAX's; their rows are the rows of
    BatchLoader(batch_size=K*B)'s batches, and a partial superbatch is
    dropped."""
    x, y = _data()
    ours = PP.ChunkedLoader(x, y, b, steps_per_chunk=k, seed=7,
                            device="cpu")
    ref = JP.ChunkedLoader(x, y, b, steps_per_chunk=k, seed=7)
    assert ours.steps_per_epoch == ref.steps_per_epoch == \
        (N // (k * b)) * k
    got = _epochs(ours, 2)
    _same(got, _epochs(ref, 2))
    assert got[0][0][0].shape == (k, b, D)
    flat = _epochs(PP.BatchLoader(x, y, k * b, seed=7, device="cpu"), 2)
    for eo, ef in zip(got, flat):
        for (xc, _), (xf, _) in zip(eo, ef):
            np.testing.assert_array_equal(xc.reshape(-1, D), xf)
    ours.set_epoch(1)
    ref.set_epoch(1)
    _same(_epochs(ours, 1), _epochs(ref, 1))


def test_bootstrap_loader_equals_jax():
    x, y = _data()
    ours = PP.BootstrapLoader(x, y, 32, 3, subset_fraction=0.7, seed=4,
                              steps_per_epoch=5, device="cpu")
    ref = JP.BootstrapLoader(x, y, 32, 3, subset_fraction=0.7, seed=4,
                             steps_per_epoch=5)
    np.testing.assert_array_equal(ours.member_subsets, ref.member_subsets)
    got = _epochs(ours, 2)
    assert got[0][0][0].shape == (3, 32, D)
    _same(got, _epochs(ref, 2))
    ours.set_epoch(1)
    ref.set_epoch(1)
    _same(_epochs(ours, 2), _epochs(ref, 2))
    # each member draws only from its own subset
    for xb, _ in got[0]:
        for e in range(3):
            assert set(xb[e, :, 0].astype(int)) <= set(
                ours.member_subsets[e])


def test_loaders_refuse_rules_and_processes():
    x, y = _data()
    with pytest.raises(NotImplementedError):
        PP.BatchLoader(x, y, 8, rules=object(), device="cpu")
    with pytest.raises(NotImplementedError):
        PP.BatchLoader(x, y, 8, process_count=2, device="cpu")
    with pytest.raises(NotImplementedError):
        PP.ChunkedLoader(x, y, 8, rules=object(), device="cpu")
    with pytest.raises(ValueError):
        PP.BatchLoader(x, y[:-1], 8, device="cpu")


def test_producer_fault_is_raised_and_early_exit_stops_it():
    x, y = _data()
    ld = PP.BatchLoader(x, y, 100, seed=0, prefetch=1, device="cpu")
    it = iter(ld)
    next(it)
    it.close()   # leaves the loop early: the producer thread must end
    bad = PP.BatchLoader(x, y, 100, seed=0, device="cpu")
    bad.targets = y[:, :1].reshape(-1)   # 1-D: the gather fails
    with pytest.raises(ValueError):
        list(bad)
    assert len(list(ld)) == 10


def _trainers(xt, yt, monkeypatch):
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
    return jt, pt


@pytest.fixture(scope="module")
def split():
    x, y = synthetic_split(SPEC, 9 * B, load_default_grid(), seed=0)
    return x[:7 * B], y[:7 * B], x[7 * B:], y[7 * B:]


def test_fit_over_chunked_loader_matches_jax(split, monkeypatch):
    """Two epochs of fit over ChunkedLoader (B 64, K 2, 7 batches: three
    superbatches and a dropped remainder), shuffled, validated over a
    ChunkedLoader of the held-out rows (evaluate flattens superbatches)."""
    xt, yt, xv, yv = split
    jt, pt = _trainers(xt, yt, monkeypatch)
    js, jh = JL.fit(
        jt.train_step, jt.eval_step, jt.state,
        JP.ChunkedLoader(xt, yt, B, steps_per_chunk=K, seed=2),
        JP.ChunkedLoader(xv, yv, B // 2, steps_per_chunk=K, shuffle=False),
        epochs=2, verbose=False)
    ps, ph = PL.fit(
        pt.train_step, pt.eval_step, pt.state,
        PP.ChunkedLoader(xt, yt, B, steps_per_chunk=K, seed=2,
                         device="cpu"),
        PP.ChunkedLoader(xv, yv, B // 2, steps_per_chunk=K, shuffle=False,
                         device="cpu"),
        epochs=2, verbose=False)
    assert len(ph.rows) == len(jh.rows) == 2
    for got, want in zip(ph.rows, jh.rows):
        for k in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5)
    assert ps.step == int(js.step) == 12
    want = port_flax_mlp(jax.tree.map(np.asarray, js.params))
    for k, v in ps.params.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)


def test_evaluate_flattens_superbatches_as_jax(split, monkeypatch):
    """evaluate over a ChunkedLoader of the held-out rows, weighted by rows,
    against the JAX evaluate; and equal to evaluate over the same rows as
    (K*B)-row batches."""
    xt, yt, xv, yv = split
    jt, pt = _trainers(xt, yt, monkeypatch)
    want = JL.evaluate(jt.eval_step, jt.state.params, JP.ChunkedLoader(
        xv, yv, 48, steps_per_chunk=2, seed=1))
    got = PL.evaluate(pt.eval_step, pt.model, PP.ChunkedLoader(
        xv, yv, 48, steps_per_chunk=2, seed=1, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    flat = PL.evaluate(pt.eval_step, pt.model, PP.BatchLoader(
        xv, yv, 96, seed=1, device="cpu"))
    assert got == flat


@pytest.mark.parametrize("fused", [True, False])
def test_chunk_runner_equals_the_step_loop(split, fused):
    """fit over ChunkedLoader gives the parameters, bit for bit, of the
    per-step loop over the same superbatches (fused or not: superbatches
    always take the chunk runner), and its loss is the mean of the
    per-chunk means."""
    xt, yt, _, _ = split
    stats = load_asset_norms("v1")

    def trainer():
        return PR.mlp_trainer(SPEC, stats, (xt, yt), 3, hidden=HIDDEN,
                              steps_per_epoch=3, device="cpu")

    a, b = trainer(), trainer()
    la = PP.ChunkedLoader(xt, yt, B, steps_per_chunk=K, seed=9,
                          device="cpu")
    lb = PP.ChunkedLoader(xt, yt, B, steps_per_chunk=K, seed=9,
                          device="cpu")
    sa, ha = PL.fit(a.train_step, a.eval_step, a.state, la, None, epochs=2,
                    verbose=False, fused=fused)
    sb, means = b.state, []
    for _ in range(2):
        chunk = []
        for xc, yc in lb:
            losses = []
            for xb, yb in zip(xc, yc):
                sb, m = b.train_step(sb, xb, yb)
                losses.append(m["loss"])
            chunk.append(torch.stack(losses).mean())
        means.append(float(np.mean(torch.stack(chunk).double().numpy())))
    assert sa.step == sb.step == 12
    assert [r["train_loss"] for r in ha.rows] == means
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
