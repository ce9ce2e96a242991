"""Differentiable K-step rollout fine-tuning in the port
(climsim_tpu_torch.train.rollout_ft, HybridDriver(remat=True)) against
climsim_tpu.train.rollout_ft, on the CPU.

* The four tests of tests/test_rollout_ft.py, on the port alone: the
  shapes of ``trajectory_stds``, zero loss when hybrid and reference are
  one model, eight fine-tune updates taking the loss below 0.8 of its
  start, and gradient reaching all leaves but one.
* float64 on both sides, a tiny OnlineMLP carried across by the porter
  (its parameters float64 too), through ``make_wrapper``,
  ``make_v4_wrapper`` and ``make_v2rh_wrapper`` (``V2RHDriver`` for the
  last): the loss within 1e-10 relative (the driver test's F64_TOL), each
  parameter's gradient within a rel-L2 of 1e-9, and the parameters after
  three ``make_finetune_step`` updates (AdamW, clip, cosine) within rtol
  1e-8 (atol 1e-8 of the tensor's largest value).  The forcing is
  Newtonian relaxation with the diurnal cycle and the rollout starts at a
  nonzero ``start_step``, so the solar phase is exercised.
* F5: the columns are cloud-free above level 15 (qc = qi = 0 there), so
  the driver's clamps of qc and qi sit at exact ties every step; with
  ``torch.clamp``'s tie gradient planted back (all of it to x, where
  ``jnp.maximum`` splits it 0.5 / 0.5) the gradients must miss JAX's.
* A tiny U-Net (2 levels, 8 channels) with ``fused_gn_conv=True`` on both
  sides (JAX's Pallas 5' in interpret mode, the port's plain 5') through
  ``make_wrapper`` in float32 at K = 2: the loss within rtol 1e-5, every
  parameter's gradient within the rel-L2 that test_torch_unet_train.py
  holds the fused model's float32 gradients to (1e-4); ``remat=True``
  against ``remat=False``: loss and gradients bit-equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import load_default_grid as jax_grid
from climsim_tpu.models import OnlineMLP as FlaxOnlineMLP
from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.online import driver as JD
from climsim_tpu.online import wrapper as JW
from climsim_tpu.train import rollout_ft as JF
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.models import ClimSimUNet, OnlineMLP
from climsim_tpu_torch.online import driver as PD
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.train.rollout_ft import (make_finetune_step,
                                                make_rollout_loss,
                                                trajectory_stds)
from climsim_tpu_torch.utils.migrate import (port_flax_online_mlp,
                                             port_flax_unet)
from test_torch_unet import perturb
from test_torch_unet_train import rel_l2

SPEC2, SPEC4, SPEC5 = (get_varspec(v) for v in ("v2_rh", "v4", "v5"))
STATS = {v: load_asset_norms(v) for v in ("v2_rh", "v4", "v5")}
GRID, JGRID = load_default_grid(), jax_grid()
FT_KEYS = ("t", "q1", "qn", "u")
F64_TOL = 1e-10
GRAD_TOL = 1e-9
PARAM_TOL = 1e-8
UNET_GRAD_TOL = 1e-4
TAU, DIURNAL = 2 * 72, 1.5
START = 17            # a nonzero absolute forcing step
TINY_UNET = dict(model_channels=8, channel_mult=(1, 2), num_blocks=1,
                 attn_resolutions=(), output_prune=True, strato_lev_out=15)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These networks are tiny: one intra-op thread does their work at a
    third of the CPU time of eight, and keeps a loaded host's cores for
    the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def columns(n, dtype=np.float32, seed=3, clear_top=True):
    """Raw v4 columns; with ``clear_top`` cloud-free above level 15."""
    x = synthetic_inputs(SPEC4, n, GRID, seed=seed).astype(dtype)
    if clear_top:
        for v in ("state_q0002", "state_q0003"):
            s = SPEC4.input_slices[v].start
            x[:, s:s + 15] = 0.0
    return x


# -- the four tests of tests/test_rollout_ft.py, on the port ---------------
def _setup(n=6, hidden=(24,)):
    """The JAX test's setup: the flax models' weights from PRNGKey(0) (the
    hybrid) and PRNGKey(7) (the reference), carried across."""
    def wrapped(seed):
        fl = FlaxOnlineMLP(spec=SPEC5, hidden=hidden)
        m = OnlineMLP(SPEC5, hidden=hidden)
        m.load_state_dict(port_flax_online_mlp(jax.tree.map(
            np.asarray, fl.init(jax.random.PRNGKey(seed), jnp.zeros(
                (2, SPEC5.input_len)))["params"])))
        return m, PW.make_wrapper(lambda xn: m(xn), STATS["v5"],
                                  PW.WrapperConfig(input_version="v4"),
                                  device="cpu")

    model, wrap = wrapped(0)
    ref_model, ref_wrap = wrapped(7)
    x0 = synthetic_inputs(SPEC4, n, GRID, seed=3)
    s0 = PD.initial_state(x0, GRID, device="cpu")
    return (model, PD.HybridDriver(wrap, GRID), ref_model,
            PD.HybridDriver(ref_wrap, GRID), s0)


def test_trajectory_stds_shapes():
    _, _, _, reference, s0 = _setup()
    with torch.no_grad():
        _, traj = reference.rollout(s0, 5)
    stds = trajectory_stds({k: v for k, v in traj.items() if k in FT_KEYS})
    for k in FT_KEYS:
        assert stds[k].shape == (60,) and stds[k].dtype == np.float32
        assert np.all(stds[k] > 0)


def test_rollout_loss_zero_when_identical():
    """Hybrid == reference (one model) -> exactly zero loss."""
    _, hybrid, _, _, s0 = _setup()
    stds = {k: np.ones(60, np.float32) for k in FT_KEYS}
    with torch.no_grad():
        assert float(make_rollout_loss(hybrid, hybrid, 3, stds)(s0)) == 0.0


def test_finetune_reduces_rollout_loss():
    """Eight updates on the K-step loss must reduce it (gradients flow
    through the rollout) and leave the reference's model untouched."""
    model, hybrid, ref_model, reference, s0 = _setup()
    with torch.no_grad():
        _, traj = reference.rollout(s0, 6)
    stds = trajectory_stds({k: v for k, v in traj.items() if k in FT_KEYS})
    loss_fn = make_rollout_loss(hybrid, reference, 4, stds)
    ref_before = [p.detach().clone() for p in ref_model.parameters()]
    step_fn, _ = make_finetune_step(hybrid, reference, 4, stds,
                                    model.parameters(), learning_rate=3e-3,
                                    total_steps=8)
    with torch.no_grad():
        l0 = float(loss_fn(s0))
    assert l0 > 0.0
    for _ in range(8):
        step_fn(s0)
    with torch.no_grad():
        l1 = float(loss_fn(s0))
    assert l1 < 0.8 * l0, (l0, l1)
    for p, q in zip(ref_model.parameters(), ref_before):
        assert torch.equal(p, q) and p.grad is None


def test_finetune_gradient_nonzero_through_wrapper_constraints():
    """The wrapper applies clips/prune/repartition; the path must still
    carry gradient to every parameter leaf but one."""
    model, hybrid, _, reference, s0 = _setup()
    stds = {k: np.ones(60, np.float32) for k in FT_KEYS}
    loss = make_rollout_loss(hybrid, reference, 2, stds)(s0)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    norms = [float(g.abs().max()) for g in grads]
    assert all(np.isfinite(n) for n in norms)
    assert sum(n > 0 for n in norms) >= len(norms) - 1


# -- float64 against JAX -----------------------------------------------------
# name -> (spec of the model, JAX wrapper factory, port wrapper factory,
# driver classes)
def _wrap_v5(jap, pap, jdt, tdt):
    return (JW.make_wrapper(jap, STATS["v5"], JW.WrapperConfig(dtype=jdt)),
            PW.make_wrapper(pap, STATS["v5"], PW.WrapperConfig(dtype=tdt),
                            device="cpu"))


def _wrap_v4(jap, pap, jdt, tdt):
    return (JW.make_v4_wrapper(jap, STATS["v4"], dtype=jdt),
            PW.make_v4_wrapper(pap, STATS["v4"], device="cpu", dtype=tdt))


def _wrap_v2rh(jap, pap, jdt, tdt):
    return (JW.make_v2rh_wrapper(jap, STATS["v2_rh"], dtype=jdt),
            PW.make_v2rh_wrapper(pap, STATS["v2_rh"], device="cpu",
                                 dtype=tdt))


WRAPPERS = {"make_wrapper": (SPEC5, _wrap_v5, JD.HybridDriver,
                             PD.HybridDriver),
            "make_v4_wrapper": (SPEC4, _wrap_v4, JD.HybridDriver,
                                PD.HybridDriver),
            "make_v2rh_wrapper": (SPEC2, _wrap_v2rh, JD.V2RHDriver,
                                  PD.V2RHDriver)}
NCOL, K_STEPS = 8, 3


def forcings(state_j, dtype=np.float64, n=NCOL):
    lat = GRID.lat[:n]
    clim = [np.asarray(getattr(state_j, f)) for f in ("t", "q1", "u")]
    fj = JD.newtonian_relaxation(*clim, tau_steps=TAU, lat=lat,
                                 diurnal_amp_k_per_day=DIURNAL)
    fp = PD.newtonian_relaxation(*(c.astype(dtype) for c in clim),
                                 tau_steps=TAU, lat=lat,
                                 diurnal_amp_k_per_day=DIURNAL, device="cpu")
    return fj, fp


def _mlp_pair(spec, seed):
    """(flax module, float64 params, port OnlineMLP float64 with them)."""
    fl = FlaxOnlineMLP(spec=spec, hidden=(16,), compute_dtype=jnp.float64)
    params = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), fl.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, spec.input_len))))
    m = OnlineMLP(spec, hidden=(16,), compute_dtype=torch.float64)
    m.load_state_dict(port_flax_online_mlp(
        jax.tree.map(np.asarray, params["params"])))
    return fl, params, m.double()


_F64: dict = {}


def f64_case(name):
    """Both sides' drivers, models and states for ``name``, built once.
    The reference is an MLP_v2rh-family model through make_v2rh_wrapper
    with no output zeroing, so that, as online_eval's oracle does, it
    moves the stratospheric clouds the hybrid's head holds at 0."""
    if name not in _F64:
        spec, wrap, jcls, pcls = WRAPPERS[name]
        fl, jp, m = _mlp_pair(spec, 0)
        fl2, jref, mref = _mlp_pair(SPEC2, 7)
        jw, pw = wrap(fl.apply, lambda xn: m(xn), jnp.float64, torch.float64)
        jwr, pwr = _wrap_v2rh(fl2.apply, lambda xn: mref(xn), jnp.float64,
                              torch.float64)
        x = columns(NCOL, np.float64)
        sj = JD.initial_state(x, JGRID)
        sp = PD.initial_state(x, GRID, device="cpu")
        fj, fp = forcings(sj)
        jh = jcls(jw, JGRID, dyn_forcing=fj)
        jr = JD.V2RHDriver(jwr, JGRID, dyn_forcing=fj)
        ph = pcls(pw, GRID, dyn_forcing=fp)
        pr = PD.V2RHDriver(pwr, GRID, dyn_forcing=fp)
        with torch.no_grad():
            _, traj = pr.rollout(sp, K_STEPS + 2, start_step=START)
        stds = trajectory_stds(traj)
        _F64[name] = dict(jh=jh, jr=jr, jp=jp, jref=jref, sj=sj, ph=ph,
                          pr=pr, m=m, sp=sp, stds=stds)
    return _F64[name]


STATE = [f.name for f in dataclasses.fields(PD.ColumnState)]


def _jax_loss_grads(c):
    """The loss and its gradient with respect to every parameter (JAX's
    ``make_rollout_loss``) and every field of the initial state
    (``state.<field>``).  JAX's loss differentiates its reference branch
    too, which depends on the state (not on the parameters); the port's
    runs it under no_grad.  So the state's gradient is taken of the same
    loss with the reference trajectory held constant: JAX's hybrid
    rollout against ``stop_gradient`` of its reference."""
    loss_fn = JF.make_rollout_loss(c["jh"], c["jr"], K_STEPS, c["stds"],
                                   reference_params=c["jref"])
    loss, g = jax.value_and_grad(loss_fn)(c["jp"], c["sj"], START)
    _, r = c["jr"].rollout(c["jref"], c["sj"], K_STEPS, start_step=START)
    r = jax.lax.stop_gradient(r)
    w = {k: jnp.asarray(1.0 / c["stds"][k]) for k in FT_KEYS}

    def held(s0):
        _, h = c["jh"].rollout(c["jp"], s0, K_STEPS, start_step=START)
        return sum(jnp.mean(((h[k] - r[k]) * w[k]) ** 2)
                   for k in FT_KEYS) / len(FT_KEYS)

    loss_held, gs = jax.value_and_grad(held)(c["sj"])
    assert float(loss_held) == float(loss)
    grads = port_flax_online_mlp(jax.tree.map(np.asarray, g["params"]))
    grads.update({f"state.{f}": np.asarray(getattr(gs, f)) for f in STATE})
    return float(loss), grads


def _port_loss_grads(c):
    s0 = PD.map_state(lambda a: a.detach().clone().requires_grad_(),
                      c["sp"])
    loss = make_rollout_loss(c["ph"], c["pr"], K_STEPS, c["stds"])(
        s0, START)
    names, params = zip(*c["m"].named_parameters())
    names += tuple(f"state.{f}" for f in STATE)
    params += tuple(getattr(s0, f) for f in STATE)
    # V2RHDriver reads no memory fields: their gradient is 0
    return float(loss), dict(zip(names, torch.autograd.grad(
        loss, params, allow_unused=True, materialize_grads=True)))


def _check_grads(got, want):
    assert set(got) == set(want)
    for k in got:
        assert got[k].dtype == torch.float64, k
        assert rel_l2(got[k], want[k]) <= GRAD_TOL, (k, rel_l2(got[k],
                                                              want[k]))


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_loss_and_gradients_match_jax_f64(name):
    c = f64_case(name)
    want_l, want_g = _jax_loss_grads(c)
    got_l, got_g = _port_loss_grads(c)
    assert want_l > 0
    assert abs(got_l - want_l) <= F64_TOL * abs(want_l), (got_l, want_l)
    _check_grads(got_g, want_g)
    # gradient reaches all parameter leaves but one
    leaves = [float(g.abs().max()) for k, g in got_g.items()
              if not k.startswith("state.")]
    assert sum(n > 0 for n in leaves) >= len(leaves) - 1


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_finetune_updates_match_jax_f64(name):
    """Three updates from the same parameters: the losses each returns and
    the parameters after them."""
    c = f64_case(name)
    kw = dict(learning_rate=3e-3, total_steps=5)
    step_j, init_j = JF.make_finetune_step(
        c["jh"], c["jr"], K_STEPS, c["stds"], reference_params=c["jref"],
        **kw)
    p, opt = c["jp"], init_j(c["jp"])
    saved = {k: v.detach().clone() for k, v in c["m"].state_dict().items()}
    try:
        step_p, _ = make_finetune_step(c["ph"], c["pr"], K_STEPS, c["stds"],
                                       c["m"].parameters(), **kw)
        for _ in range(3):
            p, opt, lj = step_j(p, opt, c["sj"], START)
            lp = step_p(c["sp"], START)
            assert abs(float(lp) - float(lj)) <= F64_TOL * abs(float(lj))
        want = port_flax_online_mlp(jax.tree.map(np.asarray, p["params"]))
        got = c["m"].state_dict()
        for k, w in want.items():
            w = w.numpy()
            np.testing.assert_allclose(got[k].numpy(), w, rtol=PARAM_TOL,
                                       atol=PARAM_TOL * np.abs(w).max(),
                                       err_msg=k)
            assert not np.array_equal(w, saved[k].numpy()), k
    finally:
        c["m"].load_state_dict(saved)


@pytest.mark.parametrize("name", ["make_v4_wrapper", "make_wrapper"])
def test_f5_clamp_tie_gradient_misses_jax(name, monkeypatch):
    """The columns hold qc = qi = 0 above level 15 and these heads zero the
    cloud tendencies there, so the driver's floor of qc and qi is at an
    exact tie every step, and the reference moves those clouds, so the
    loss has a gradient there.  Planted: torch.clamp's tie gradient (all
    of it to x) in place of torch.maximum's 0.5 / 0.5 split, in the driver
    and in the transforms' and physics' clips.  The loss is unchanged;
    the gradients must miss JAX's."""
    c = f64_case(name)
    for v in ("qc", "qi"):
        assert (getattr(c["sp"], v)[:, :15] == 0).all()
    want_l, want_g = _jax_loss_grads(c)
    real = torch.maximum

    def clamp_max(x, other):     # other is a bound: it wants no gradient
        return torch.where(x >= other, x, other)
    monkeypatch.setattr(torch, "maximum", clamp_max)
    got_l, got_g = _port_loss_grads(c)
    monkeypatch.setattr(torch, "maximum", real)
    assert abs(got_l - want_l) <= F64_TOL * abs(want_l)
    with pytest.raises(AssertionError) as planted:
        _check_grads(got_g, want_g)
    print(f"F5 planted, {name}: {str(planted.value).splitlines()[0]}")


# -- a tiny U-Net with fused_gn_conv=True, float32 ----------------------------
UNET_NCOL, UNET_K = 16, 2     # the fused chains need B % 16 == 0
_UNET: dict = {}


def unet_case():
    if not _UNET:
        trees, models = [], []
        for seed in (0, 7):
            fm = FlaxUNet(spec=SPEC5, fused_gn_conv=True,
                          compute_dtype=jnp.float32, **TINY_UNET)
            tree = perturb(jax.tree.map(np.asarray, fm.init(
                jax.random.PRNGKey(seed),
                jnp.zeros((16, SPEC5.input_len)))["params"]), seed=seed + 1)
            m = ClimSimUNet(SPEC5, fused_gn_conv=True,
                            compute_dtype=torch.float32, **TINY_UNET)
            m.load_state_dict(port_flax_unet(tree, m))
            trees.append(jax.tree.map(jnp.asarray, tree))
            models.append(m.eval())
        x = columns(UNET_NCOL)
        sp = PD.initial_state(x, GRID, device="cpu")
        # the JAX state from the port's float32 fields (JAX's own q1
        # recovery is float64 under x64)
        sj = JD.ColumnState(**{f.name: jnp.asarray(getattr(sp, f.name)
                                                   .numpy())
                               for f in dataclasses.fields(PD.ColumnState)})
        fj, fp = forcings(sj, np.float32, UNET_NCOL)
        jw = JW.make_wrapper(lambda p, xn: fm.apply({"params": p}, xn),
                             STATS["v5"], JW.WrapperConfig())
        pws = [PW.make_wrapper(lambda xn, m=m: m(xn), STATS["v5"],
                               PW.WrapperConfig(), device="cpu")
               for m in models]
        with torch.no_grad():
            _, traj = PD.HybridDriver(pws[1], GRID, dyn_forcing=fp).rollout(
                sp, 4, start_step=START)
        _UNET.update(trees=trees, models=models, sj=sj, sp=sp, fj=fj, fp=fp,
                     jw=jw, pws=pws, stds=trajectory_stds(traj))
    return _UNET


def _unet_port(c, remat):
    hyb = PD.HybridDriver(c["pws"][0], GRID, dyn_forcing=c["fp"],
                          remat=remat)
    ref = PD.HybridDriver(c["pws"][1], GRID, dyn_forcing=c["fp"])
    loss = make_rollout_loss(hyb, ref, UNET_K, c["stds"])(c["sp"], START)
    names, params = zip(*c["models"][0].named_parameters())
    return loss, dict(zip(names, torch.autograd.grad(loss, params)))


def test_tiny_fused_unet_matches_jax_f32():
    c = unet_case()
    hyb = JD.HybridDriver(c["jw"], JGRID, dyn_forcing=c["fj"], remat=True)
    ref = JD.HybridDriver(c["jw"], JGRID, dyn_forcing=c["fj"])
    loss_fn = JF.make_rollout_loss(hyb, ref, UNET_K, c["stds"],
                                   reference_params=c["trees"][1])
    want_l, g = jax.value_and_grad(loss_fn)(c["trees"][0], c["sj"], START)
    want_g = port_flax_unet(jax.tree.map(np.asarray, g), c["models"][0])
    got_l, got_g = _unet_port(c, remat=True)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=1e-5)
    worst = max((rel_l2(got_g[k], want_g[k]), k) for k in got_g)
    print(f"tiny fused U-Net, K={UNET_K}: loss {float(got_l):.6e} against "
          f"{float(want_l):.6e}; worst gradient rel-L2 {worst[0]:.2e} "
          f"({worst[1]})")
    assert worst[0] <= UNET_GRAD_TOL, worst


def test_remat_equals_no_remat():
    """remat=True recomputes each step in the backward: the loss and every
    gradient bit-equal to the rollout that keeps its activations."""
    c = unet_case()
    l1, g1 = _unet_port(c, remat=True)
    l0, g0 = _unet_port(c, remat=False)
    assert torch.equal(l1, l0)
    for k in g0:
        assert torch.equal(g1[k], g0[k]), k
