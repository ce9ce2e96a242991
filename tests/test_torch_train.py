"""The port's training stack (climsim_tpu_torch.train, models.ClimSimMLP,
data.synthetic, bench_train) against the JAX package on the CPU, from the
same numpy seeds.

Tolerances: schedules rtol 1e-6, atol 1e-7 * the peak (float32; cos
and pow may differ in the last place); losses rtol 1e-6; ClimSimMLP at
compute_dtype=float32 rtol 1e-5 / atol 1e-6, at bf16 atol 2e-2 * max|y|
(tests/test_pallas_kernels.py:172); the train steps at float32 compute:
losses rtol 1e-5 and parameters atol 2e-6 (float32 sums in another order,
through Adam's normalized update)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data.synthetic import synthetic_split as jax_split
from climsim_tpu.grid import load_default_grid
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.train import losses as JL
from climsim_tpu.train import recipes as JR
from climsim_tpu.train import schedules as JS
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.synthetic import synthetic_split
from climsim_tpu_torch.models import ClimSimMLP, build_model
from climsim_tpu_torch.models.common import MLPTrunk
from climsim_tpu_torch.train import losses as PL
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train import schedules as PS
from climsim_tpu_torch.utils.migrate import port_flax_mlp

SPEC = get_varspec("v1")
HIDDEN = (32, 24)

SCHEDULES = {
    "cyclic": lambda S: S.cyclic_triangular2(2.5e-4, 2.5e-3, 300),
    "step": lambda S: S.step_decay(1e-4, 700, 0.2),
    "cosine": lambda S: S.cosine(1e-3, 3000, 0.1),
    "exponential": lambda S: S.exponential(5e-4, 1000, 0.99),
    "warmup_linear": lambda S: S.warmup_then(S.constant(1e-3), 500),
    "warmup_cos": lambda S: S.warmup_then(S.cosine(1e-3, 3000), 500, 0.1,
                                          "cos"),
    "warmup_constant": lambda S: S.warmup_then(S.constant(1e-3), 500, 0.3,
                                               "constant"),
    "build_cosine": lambda S: S.build("cosine", 100, init_lr=2e-3,
                                      decay_epochs=20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax(name):
    steps = np.arange(0, 6000, 7)
    want = np.array([float(SCHEDULES[name](JS)(s)) for s in steps])
    got = [SCHEDULES[name](PS)(s) for s in steps]
    assert all(isinstance(v, np.float32) for v in got)
    # near a cosine's zero float32 resolves 1e-7 of the peak, not of the
    # value (the JAX test process runs x64, where optax's cosine is float64)
    np.testing.assert_allclose(np.array(got, np.float64), want, rtol=1e-6,
                               atol=1e-7 * want.max())


def test_unknown_schedule_raises():
    with pytest.raises(ValueError):
        PS.build("plateau", 10)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kind", ["mse", "mae", "huber"])
def test_losses_match_jax(kind, weighted):
    rng = np.random.default_rng(1)
    pred = rng.normal(size=(16, SPEC.output_len)).astype(np.float32) * 2
    tgt = rng.normal(size=(16, SPEC.output_len)).astype(np.float32)
    bw = {"ptend_t": 2.0, "2d": 0.5, "cam_out_PRECC": 3.0}
    wj = JL.block_weight_vector(SPEC, bw) if weighted else None
    wp = (PL.block_weight_vector(SPEC, bw, device="cpu") if weighted
          else None)
    want = float(JL.LOSS_FNS[kind](jnp.asarray(pred), jnp.asarray(tgt), wj))
    got = float(PL.LOSS_FNS[kind](torch.from_numpy(pred),
                                  torch.from_numpy(tgt), wp))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    if weighted:
        np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))


def test_synthetic_split_bit_equal():
    grid = load_default_grid()
    xj, yj = jax_split(SPEC, 384, grid, seed=3, noise=0.02)
    xp, yp = synthetic_split(SPEC, 384, grid, seed=3, noise=0.02)
    np.testing.assert_array_equal(xp, xj)
    np.testing.assert_array_equal(yp, yj)


def _flax_mlp(compute_dtype, x, seed=4):
    fl = FlaxClimSimMLP(spec=SPEC, hidden=HIDDEN, compute_dtype=compute_dtype)
    params = fl.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    # non-zero biases, so the porter's bias placement is checked too
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(
        a.shape).astype(np.float32) * (a.ndim == 1), params["params"])
    return fl, tree


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_climsim_mlp_matches_flax(dtype):
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(3).standard_normal(
        (16, SPEC.input_len)).astype(np.float32)
    fl, tree = _flax_mlp(jdt, x)
    want = np.asarray(fl.apply({"params": tree}, jnp.asarray(x)))
    m = build_model("mlp", SPEC, hidden=HIDDEN, compute_dtype=tdt)
    assert isinstance(m, ClimSimMLP)
    m.load_state_dict(port_flax_mlp({"params": tree}))
    with torch.no_grad():
        y = m(torch.from_numpy(x))
    assert y.dtype == torch.float32 and y.shape == (16, SPEC.output_len)
    if dtype == "f32":
        np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(y.numpy(), want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())
    assert (y[:, -8:] >= 0).all()


def test_porter_rejects_other_trees():
    with pytest.raises(KeyError):
        port_flax_mlp({"MLPTrunk_0": {}, "out": {}})


def test_trunk_refuses_what_is_not_ported():
    with pytest.raises(NotImplementedError):
        MLPTrunk(8, (4,), layernorm=True)
    with pytest.raises(NotImplementedError):
        MLPTrunk(8, (4,), dropout=0.1)


@pytest.fixture(scope="module")
def data():
    stats = load_asset_norms("v1")
    x, y = synthetic_split(SPEC, 6 * 64, load_default_grid(), seed=0)
    return x, y, stats


def _pair(data, monkeypatch, steps_per_epoch=3):
    """The JAX mlp_trainer at float32 compute and the port's, from the same
    weights."""
    x, y, stats = data
    monkeypatch.setattr("climsim_tpu.models.ClimSimMLP", functools.partial(
        FlaxClimSimMLP, compute_dtype=jnp.float32))
    jt = JR.mlp_trainer(SPEC, stats, (x, y), jax.random.PRNGKey(0),
                        hidden=HIDDEN, steps_per_epoch=steps_per_epoch)
    pt = PR.mlp_trainer(SPEC, stats, (x, y), 0, hidden=HIDDEN,
                        steps_per_epoch=steps_per_epoch,
                        compute_dtype=torch.float32, device="cpu")
    pt.model.load_state_dict(port_flax_mlp(
        jax.tree.map(np.asarray, jt.state.params)))
    return jt, pt


@pytest.mark.parametrize("n_steps,lr_scale", [(1, 1.0), (5, 0.5)])
def test_train_steps_match_jax(data, monkeypatch, n_steps, lr_scale):
    """One step, then five with the cyclic schedule climbing and the
    plateau multiplier at 0.5: losses and parameters against JAX's
    mlp_trainer, batch for batch."""
    x, y, _ = data
    jt, pt = _pair(data, monkeypatch)
    js = jt.state.replace(lr_scale=jnp.asarray(lr_scale, jnp.float32))
    pt.state.lr_scale = lr_scale
    ps = pt.state
    for i in range(n_steps):
        xb, yb = x[64 * i:64 * (i + 1)], y[64 * i:64 * (i + 1)]
        js, jm = jt.train_step(js, jnp.asarray(xb), jnp.asarray(yb))
        ps, pm = pt.train_step(ps, torch.from_numpy(xb), torch.from_numpy(yb))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert ps.step == n_steps == int(js.step)
    want = port_flax_mlp(jax.tree.map(np.asarray, js.params))
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    ev = pt.eval_step(pt.model, torch.from_numpy(x[:64]),
                      torch.from_numpy(y[:64]))
    jev = jt.eval_step(js.params, jnp.asarray(x[:64]), jnp.asarray(y[:64]))
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pt.predict(pt.model, x[:70], 32),
                               np.asarray(jt.predict(js.params, x[:70], 32)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["adamw", "sgd", "rmsprop"])
def test_optimizers_match_optax(name):
    """Two updates of each other optimizer against optax's defaults."""
    import optax

    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [rng.normal(size=(7, 5)).astype(np.float32) for _ in range(2)]
    sched = JS.constant(1e-2)
    opt = getattr(optax, name)(sched)
    pj, st = jnp.asarray(p0), None
    st = opt.init(pj)
    pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    popt = PR._optimizer(PS.constant(1e-2), name)
    topt = popt.init([pt])
    for g in grads:
        u, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
        pt.grad = torch.from_numpy(g.copy())
        for group in topt.param_groups:
            group["lr"] = float(popt.schedule(0))
        topt.step()
    np.testing.assert_allclose(pt.detach().numpy(), np.asarray(pj),
                               rtol=1e-5, atol=1e-7)


def test_clipped_adam_step_matches_optax():
    """_optimizer's clip (optax.clip_by_global_norm before adam) through
    make_train_step: two steps whose gradients exceed the norm."""
    import optax

    from climsim_tpu_torch.train.step import create_train_state, \
        make_train_step

    rng = np.random.default_rng(6)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    xs = [rng.normal(size=(3, 7)).astype(np.float32) for _ in range(2)]
    opt = JR._optimizer(JS.constant(1e-2), "adam", clip=0.5)
    pj = jnp.asarray(p0)
    st = opt.init(pj)
    for x in xs:
        g = jax.grad(lambda p: jnp.sum((jnp.asarray(x) @ p) ** 2))(pj)
        u, st = opt.update(g, st, pj)
        pj = optax.apply_updates(pj, u)

    model = torch.nn.Module()
    model.p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    popt = PR._optimizer(PS.constant(1e-2), "adam", clip=0.5)
    state = create_train_state(model, popt, torch.Generator())
    step = make_train_step(
        lambda m, gen, xb, yb: (((xb @ m.p) ** 2).sum(), {}), popt)
    for x in xs:
        state, _ = step(state, torch.from_numpy(x), None)
    np.testing.assert_allclose(model.p.detach().numpy(), np.asarray(pj),
                               rtol=1e-5, atol=1e-7)


def test_recipes_refuse_what_is_not_ported(data):
    x, y, stats = data
    with pytest.raises(NotImplementedError):
        PR._optimizer(PS.constant(1e-3), "radam")
    with pytest.raises(NotImplementedError):
        PR.mlp_trainer(SPEC, stats, (x, y), 0, hidden=(8,), rules=object(),
                       device="cpu")
    # the energy and water penalties are ported; they need the grid
    with pytest.raises(ValueError, match="grid"):
        PR.online_mlp_trainer(get_varspec("v2_rh"),
                              load_asset_norms("v2_rh"), None, 0,
                              hidden=(8,), energy_weight=0.1, device="cpu")


def test_online_mlp_trainer_learns():
    from climsim_tpu.norms import compute_norms_from_data

    spec = get_varspec("v2_rh")
    x, y = synthetic_split(spec, 256, load_default_grid(), seed=1)
    stats = compute_norms_from_data(spec, x, y)
    tr = PR.online_mlp_trainer(spec, stats, (x, y), 1, hidden=(32,),
                               steps_per_epoch=4, lr=3e-3,
                               device="cpu")
    st, losses = tr.state, []
    for _ in range(3):
        for s in range(4):
            st, m = tr.train_step(st, torch.from_numpy(x[64 * s:64 * s + 64]),
                                  torch.from_numpy(y[64 * s:64 * s + 64]))
            losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_bench_train_needs_a_card(capsys, monkeypatch):
    """Without a CUDA device the benchmark refuses, and prints no result
    line."""
    from climsim_tpu_torch import bench_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench_train.main([]) != 0
    assert "metric" not in capsys.readouterr().out


def test_bench_core_on_a_small_split(data):
    """bench_train's core (build + throughput) end to end at a small size
    on the CPU: the loss falls and every epoch is finite."""
    from climsim_tpu_torch import bench_train

    tr, loader, (x, _) = bench_train.build("cpu", seed=0, batch=256, pool=4)
    assert loader.steps_per_epoch == 4 and x.shape == (1024, SPEC.input_len)
    res = bench_train.throughput(tr, loader, epochs=3, reps=1)
    assert len(res["epoch_loss"]) == 6
    assert np.isfinite(res["epoch_loss"]).all()
    assert res["epoch_loss"][-1] < res["epoch_loss"][0] * 0.7
    assert res["samples_per_s"] > 0
