"""The zoo's training recipes (mlp_v2, ed, cnn, hsr with its NLL stage,
cvae), radam, the RPN ensemble's stacked step and multi-seed training,
against the JAX package on the CPU, from the same weights and batches.

The JAX models run at compute_dtype=float32 (patched in, as
test_torch_train.py does for mlp_trainer) and so does the port.
Tolerances: the train steps' losses rtol 1e-5 and parameters atol 2e-6
(test_torch_train.py::test_train_steps_match_jax: float32 sums in another
order, through Adam's normalized update); radam rtol 1e-5 / atol 1e-7
(test_optimizers_match_optax); a multi-seed replica bit-equal to its
single-seed run."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import models as JM
from climsim_tpu.grid import load_default_grid
from climsim_tpu.norms import compute_norms_from_data
from climsim_tpu.train import multiseed as JMS
from climsim_tpu.train import recipes as JR
from climsim_tpu.train import rpn_recipe as JRR
from climsim_tpu.train import schedules as JS
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch import models as PMOD
from climsim_tpu_torch.data.synthetic import synthetic_split
from climsim_tpu_torch.train import multiseed as PMS
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.train import rpn_recipe as PRR
from climsim_tpu_torch.train import schedules as PS
from climsim_tpu_torch.utils import migrate as PM

F32 = torch.float32
B = 64


@functools.lru_cache(maxsize=None)
def data(version):
    spec = get_varspec(version)
    x, y = synthetic_split(spec, 6 * B, load_default_grid(), seed=0)
    return spec, x, y, compute_norms_from_data(spec, x, y)


def f32_model(monkeypatch, name, **kw):
    """The JAX package's model ``name`` at float32 compute (and ``kw``),
    wherever a recipe builds it."""
    fields = dict(compute_dtype=jnp.float32, **kw)
    sub = type(name, (getattr(JM, name),), {
        "__annotations__": {k: type(v) for k, v in fields.items()},
        **fields})   # a subclass: recipes call its methods by class
    monkeypatch.setattr(f"climsim_tpu.models.{name}", sub)


def tree(jt):
    return jax.tree.map(np.asarray, jt.state.params)


# recipe -> (varspec, JAX model patch, the two trainers' kwargs, porter)
RECIPES = {
    "mlp_v2": ("v2", ("ClimSimMLP", {}), dict(hidden=(32, 24),
                                              steps_per_epoch=3),
               PM.port_flax_mlp),
    "ed": ("v1", ("EncoderDecoder", dict(intermediate=32)),
           dict(steps_per_epoch=3), PM.port_flax_ed),
    "cnn": ("v1", ("ClimSimCNN", {}), dict(depth=2, channels=16,
                                           dropout=0.0, steps_per_epoch=3),
            PM.port_flax_cnn),
    "hsr": ("v1", ("HSR", {}), dict(hidden=32, layers=2),
            PM.port_flax_hsr),
    "cvae": ("v1", ("CVAE", {}), dict(latent=4, hidden=32, layers=2),
            PM.port_flax_cvae),
}


def pair(monkeypatch, name):
    version, (cls, extra), kw, porter = RECIPES[name]
    spec, x, y, stats = data(version)
    f32_model(monkeypatch, cls, **extra)
    if extra:
        monkeypatch.setattr(f"climsim_tpu_torch.models.{cls}",
                            functools.partial(getattr(PMOD, cls), **extra))
    jt = getattr(JR, f"{name}_trainer")(spec, stats, (x, y),
                                        jax.random.PRNGKey(0), **kw)
    pt = getattr(PR, f"{name}_trainer")(spec, stats, (x, y), 0,
                                        compute_dtype=F32, device="cpu", **kw)
    pt.model.load_state_dict(porter(tree(jt)))
    return jt, pt, porter, x, y


def feed_cvae_noise(monkeypatch, jt, steps):
    """The JAX cvae step's eps (its state key split once a step; a fixed
    PRNGKey(0) in evaluation) fed to the port's, in order."""
    key, train = jt.state.rng, []
    for _ in range(steps):
        key, sub = jax.random.split(key)
        train.append(np.array(jax.random.normal(sub, (B, 4), jnp.float32)))
    ev = np.array(jax.random.normal(jax.random.PRNGKey(0), (B, 4),
                                    jnp.float32))

    def normal(seed, shape, device):
        assert tuple(shape) == (B, 4)
        return torch.from_numpy(ev if seed is None else train.pop(0))

    monkeypatch.setattr(PR, "_normal", normal)


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_recipe_steps_match_jax(monkeypatch, name):
    """Three steps (HSR: two MSE-stage steps, then two of stage2_step's
    NLL), the losses and the parameters after them against the JAX
    recipe's, then the evaluation loss and the predictions."""
    jt, pt, porter, x, y = pair(monkeypatch, name)
    steps = [("train_step", i) for i in range(3)]
    if name == "hsr":
        steps = [("train_step", 0), ("train_step", 1), ("stage2_step", 2),
                 ("stage2_step", 3)]
    if name == "cvae":
        feed_cvae_noise(monkeypatch, jt, len(steps))
    js, ps = jt.state, pt.state
    for fn, i in steps:
        xb, yb = x[B * i:B * (i + 1)], y[B * i:B * (i + 1)]
        js, jm = getattr(jt, fn)(js, jnp.asarray(xb), jnp.asarray(yb))
        ps, pm = getattr(pt, fn)(ps, torch.from_numpy(xb),
                                 torch.from_numpy(yb))
        for k in jm:
            np.testing.assert_allclose(float(pm[k]), float(jm[k]),
                                       rtol=1e-5, err_msg=k)
    assert ps.step == len(steps) == int(js.step)
    want = porter(jax.tree.map(np.asarray, js.params))
    for k, v in pt.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    ev = pt.eval_step(pt.model, torch.from_numpy(x[:B]),
                      torch.from_numpy(y[:B]))
    jev = jt.eval_step(js.params, jnp.asarray(x[:B]), jnp.asarray(y[:B]))
    np.testing.assert_allclose(float(ev["loss"]), float(jev["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(pt.predict(pt.model, x[:70], 32),
                               np.asarray(jt.predict(js.params, x[:70], 32)),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["hsr", "cvae"])
def test_recipe_samples(monkeypatch, name):
    """sample: finite (B, D_out, S), the same seed the same draws."""
    _, pt, _, x, _ = pair(monkeypatch, name)
    a, b, c = (pt.sample(pt.model, torch.from_numpy(x[:8]), s, 5)
               for s in (3, 3, 4))
    assert a.shape == (8, get_varspec("v1").output_len, 5)
    assert torch.isfinite(a).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a != c).any()


def test_radam_matches_optax():
    """Ten updates, so that rho_t crosses 5 (at t = 6), against
    optax.radam; gradients small enough (~1e-6) that where eps is added
    shows.  torch.optim.RAdam (planted) must miss."""
    import optax

    rng = np.random.default_rng(5)
    p0 = rng.normal(size=(7, 5)).astype(np.float32)
    grads = [1e-6 * rng.normal(size=(7, 5)).astype(np.float32)
             for _ in range(10)]
    opt = optax.radam(JS.constant(1e-2))
    pj = jnp.asarray(p0)
    st = opt.init(pj)

    def run(make):
        pt = torch.nn.Parameter(torch.from_numpy(p0.copy()))
        o = make([pt])
        for g in grads:
            pt.grad = torch.from_numpy(g.copy())
            for group in o.param_groups:
                group["lr"] = 1e-2
            o.step()
        return pt.detach().numpy()

    for g in grads:
        u, st = opt.update(jnp.asarray(g), st, pj)
        pj = optax.apply_updates(pj, u)
    want = np.asarray(pj)
    got = run(PR._optimizer(PS.constant(1e-2), "radam").init)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    planted = run(lambda ps: torch.optim.RAdam(ps, lr=1e-2))
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(planted, want, rtol=1e-5, atol=1e-7)


def test_rpn_step_matches_jax(monkeypatch):
    """The stacked Adam step against JAX's vmapped one: three steps on
    member-specific batches (losses (E,), parameters), then the posterior
    and the per-member evaluation losses on a shared batch."""
    spec, x, y, stats = data("v1")
    monkeypatch.setattr(JRR, "RPNEnsemble", functools.partial(
        JRR.RPNEnsemble, compute_dtype=jnp.float32))
    kw = dict(ensemble_size=3, hidden=(32, 24), decay_steps=2)
    jt = JRR.rpn_trainer(spec, stats, x, jax.random.PRNGKey(0), **kw)
    pt = PRR.rpn_trainer(spec, stats, x, 0, compute_dtype=F32, device="cpu",
                         **kw)
    pt.ensemble.load_state_dict(PM.port_flax_rpn(
        *(jax.tree.map(np.asarray, p) for p in (jt.params, jt.prior))))
    params, opt_state = jt.params, jt.opt_state
    rng = np.random.default_rng(1)
    for _ in range(3):
        idx = rng.integers(0, x.shape[0], (3, B))
        xb, yb = x[idx], y[idx]
        params, opt_state, jl = jt.train_step(params, opt_state, jt.prior,
                                              jnp.asarray(xb),
                                              jnp.asarray(yb))
        pl = pt.train_step(torch.from_numpy(xb), torch.from_numpy(yb))
        assert pl.shape == (3,)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=1e-5)
    assert pt.step == 3
    want = PM.port_flax_rpn(*(jax.tree.map(np.asarray, p)
                              for p in (params, jt.prior)))
    for k, v in pt.ensemble.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)
    post = pt.posterior(torch.from_numpy(x[:16]))
    assert post.shape == (16, spec.output_len, 3)
    np.testing.assert_allclose(
        post.numpy(), np.asarray(jt.posterior(params, jt.prior,
                                              jnp.asarray(x[:16]))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        pt.eval_losses(torch.from_numpy(x[:B]), torch.from_numpy(y[:B])),
        np.asarray(jt.eval_losses(params, jt.prior, jnp.asarray(x[:B]),
                                  jnp.asarray(y[:B]))), rtol=1e-5)


def _mlp(spec, stats, x, y, seed):
    return PR.mlp_trainer(spec, stats, (x, y), seed, hidden=(32,),
                          steps_per_epoch=4, compute_dtype=F32, device="cpu")


def test_multiseed_matches_single_runs():
    """Replica k of the multi-seed step is the single-seed run with seed
    k, bit for bit; the replicas differ from each other; predict stacks
    (K, N, D) and seed_spread equals the JAX package's."""
    spec, x, y, stats = data("v1")
    seeds = [3, 17, 42]
    ms = PMS.multiseed(PR.mlp_trainer, spec, stats, (x, y), seeds,
                       hidden=(32,), steps_per_epoch=4, compute_dtype=F32,
                       device="cpu")
    assert ms.num_seeds == 3
    state = ms.state
    for s in range(3):
        xb, yb = (torch.from_numpy(a[s * B:(s + 1) * B]) for a in (x, y))
        state, m = ms.train_step(state, xb, yb)
    assert m["loss"].shape == (3,)
    tr = _mlp(spec, stats, x, y, 17)
    st = tr.state
    for s in range(3):
        st, m1 = tr.train_step(st, *(torch.from_numpy(a[s * B:(s + 1) * B])
                                     for a in (x, y)))
    assert float(m["loss"][1]) == float(m1["loss"])
    got = ms.unstack_params(state.params)[1].state_dict()
    for k, v in tr.model.state_dict().items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    p0, p2 = (ms.unstack_params()[i].state_dict() for i in (0, 2))
    assert max(float((p0[k] - p2[k]).abs().max()) for k in p0) > 1e-4
    preds = ms.predict(state.params, x[:16]).numpy()
    assert preds.shape == (3, 16, spec.output_len)
    ev = ms.eval_step(state.params, torch.from_numpy(x[:B]),
                      torch.from_numpy(y[:B]))
    assert ev["loss"].shape == (3,)
    want = JMS.seed_spread(preds)
    got = PMS.seed_spread(preds)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_multiseed_lr_sweep():
    """Per-seed lr_scale: scale 0 freezes that replica only."""
    spec, x, y, stats = data("v1")
    ms = PMS.multiseed(PR.mlp_trainer, spec, stats, (x, y), [1, 1],
                       lr_scales=[1.0, 0.0], hidden=(32,), steps_per_epoch=4,
                       compute_dtype=F32, device="cpu")
    np.testing.assert_array_equal(ms.state.lr_scale, [1.0, 0.0])
    before = [{k: v.clone() for k, v in p.state_dict().items()}
              for p in ms.state.params]
    ms.train_step(ms.state, torch.from_numpy(x[:B]), torch.from_numpy(y[:B]))
    after = [p.state_dict() for p in ms.state.params]
    for k in before[0]:
        assert (before[0][k] != after[0][k]).any()
        torch.testing.assert_close(before[1][k], after[1][k], rtol=0, atol=0)
    with pytest.raises(ValueError):
        ms.state.set_lr_scale([1.0])
    # rules go to every replica's recipe (a model axis of 1: every
    # replica on this rank)
    from climsim_tpu_torch.parallel import mesh as PPM

    rules = PPM.ShardingRules(PPM.Mesh(1, 0, torch.device("cpu"), None))
    seen = []

    def recipe(*a, rules=None, **kw):
        seen.append(rules)
        return PR.mlp_trainer(*a, **kw)

    PMS.multiseed(recipe, spec, stats, (x, y), [0, 1], rules=rules,
                  hidden=(8,), device="cpu")
    assert seen == [rules, rules]


def test_multiseed_hsr_stages_and_samples():
    """HSR replicas: stage2_step advances each replica as its own
    stage2_step does; sample stacks (K, N, D_out, S), replica k from seed
    + k."""
    spec, x, y, stats = data("v1")
    kw = dict(hidden=16, layers=1, compute_dtype=F32, device="cpu")
    ms = PMS.multiseed(PR.hsr_trainer, spec, stats, (x, y), [0, 5], **kw)
    one = PR.hsr_trainer(spec, stats, (x, y), 5, **kw)
    state, st = ms.state, one.state
    for fn in ("train_step", "stage2_step"):
        xb, yb = torch.from_numpy(x[:B]), torch.from_numpy(y[:B])
        state, m = getattr(ms, fn)(state, xb, yb)
        st, m1 = getattr(one, fn)(st, xb, yb)
        assert float(m["loss"][1]) == float(m1["loss"])
    s = ms.sample(state.params, x[:4], 7, 3)
    assert s.shape == (2, 4, spec.output_len, 3)
    torch.testing.assert_close(s[1], one.sample(one.model,
                                                torch.from_numpy(x[:4]), 8,
                                                3), rtol=0, atol=0)
    cv = PMS.multiseed(PR.cvae_trainer, spec, stats, (x, y), [0, 1],
                       hidden=16, layers=1, latent=4, device="cpu")
    assert cv.stage2_step is None and cv.sample is not None
