"""The port's hybrid rollout driver (climsim_tpu_torch.online.driver)
against climsim_tpu.online.driver on the same seeded raw v4 columns, with
the weights carried across by the porters.

Two comparisons, as the JAX package's own tests compute in float64
(``tests/conftest.py`` turns x64 on):

- float64 on both sides: the port's driver on the CPU around the float64
  wrapper (``WrapperConfig(dtype=torch.float64)``, the kernels' plain
  versions) against the JAX driver around ``WrapperConfig(dtype=
  jnp.float64)``: 1e-10 relative (F64_TOL), values near zero held at
  1e-10 of the field's largest magnitude.
- the port in float32 against the JAX driver on float32 columns (whose
  pressure and recovered q1 are float64 under x64): rtol 1e-5 / atol
  1e-6 (F32_TOL), the tolerance of tests/test_online.py:167.  atol 1e-6
  says nothing of the fields of small magnitude (q1, qn, precc,
  water_res), so they are also held within 1e-4 of their largest value
  (SMALL_TOL, the float32 U-Net parity tolerance of test_torch_unet.py):
  the networks' RH input differs between the two at cold levels (below).

Saturation pressure in float32 is ill-conditioned below ~200 K (the
Horner sum of ``eice``'s middle branch cancels): against float64 it is up
to 19% off at 185.5 K, and the JAX package's jitted float32 ``eice``
(the driver's, fused by XLA) differs from its own eager one by up to 22%
there.  The port's equals the eager one (test_torch_physics.py), and
there a difference of 1e-7 in T changes the float32 value by up to ~1e-3.
So in float32 the RH block of the rollout's features is held to the JAX
package's eager ``relative_humidity`` at the first step (the same state)
and left out after it, where the two trajectories' T differ in the last
bits; test_assemble_v4_matches_jax holds the block on equal states.

The U-Net runs with float64 norms in the float64 case: flax's GroupNorm
stores its output in its own dtype, float32 by default, so only then is
the flax model float64 throughout.

The forcing is Newtonian relaxation toward the initial state with a
diurnal cycle over the columns' latitudes (the defaults of
scripts/online_eval.py: tau 2 days, 1.5 K/day), so the step index and
``start_step`` reach every step."""

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
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.models import ClimSimUNet, OnlineMLP
from climsim_tpu_torch.online import driver as PD
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.utils.migrate import (port_flax_online_mlp,
                                             port_flax_unet)
from test_torch_unet import perturb

SPEC4, SPEC5, SPEC2 = (get_varspec(v) for v in ("v4", "v5", "v2_rh"))
STATS5, STATS2 = load_asset_norms("v5"), load_asset_norms("v2_rh")
GRID, JGRID = load_default_grid(), jax_grid()
NCOL, STEPS = 16, 5
TAU, DIURNAL = 2 * 72, 1.5
F64_TOL = 1e-10
F32_TOL = (1e-5, 1e-6)
SMALL_TOL = 1e-4
SMALL = ("q1", "qn", "precc", "water_res")
FIELDS = [f.name for f in dataclasses.fields(PD.ColumnState)]
TINY_UNET = dict(model_channels=8, channel_mult=(1, 2), num_blocks=1,
                 attn_resolutions=(), output_prune=True, strato_lev_out=15)


def columns(dtype, n=NCOL, seed=3):
    return synthetic_inputs(SPEC4, n, GRID, seed=seed).astype(dtype)


def close(got, want, dtype, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.abs(want).max()
    if dtype == "f64":
        np.testing.assert_allclose(got, want, rtol=F64_TOL,
                                   atol=F64_TOL * scale, err_msg=name)
        return
    np.testing.assert_allclose(got, want, rtol=F32_TOL[0], atol=F32_TOL[1],
                               err_msg=name)
    if name in SMALL:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=SMALL_TOL * scale, err_msg=name)


def forcings(state_j, dtype):
    """(JAX forcing, port forcing) relaxing toward the JAX initial state,
    with the diurnal cycle over the first NCOL latitudes."""
    lat = GRID.lat[:NCOL]
    clim = [np.asarray(getattr(state_j, f)) for f in ("t", "q1", "u")]
    fj = JD.newtonian_relaxation(*clim, tau_steps=TAU, lat=lat,
                                 diurnal_amp_k_per_day=DIURNAL)
    npdt = np.float64 if dtype == "f64" else np.float32
    fp = PD.newtonian_relaxation(*(c.astype(npdt) for c in clim),
                                 tau_steps=TAU, lat=lat,
                                 diurnal_amp_k_per_day=DIURNAL, device="cpu")
    return fj, fp


# -- the wrappers a case rolls out, each on both sides ---------------------
def _unet(dtype):
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    fm = FlaxUNet(spec=SPEC5, compute_dtype=jdt, norm_dtype=jdt, **TINY_UNET)
    tree = perturb(jax.tree.map(np.asarray, fm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, SPEC5.input_len)))["params"]))
    m = ClimSimUNet(SPEC5, compute_dtype=tdt, norm_dtype=tdt, **TINY_UNET)
    m.load_state_dict(port_flax_unet(tree, m))
    m.eval()
    jcfg = JW.WrapperConfig(dtype=jdt)
    pcfg = PW.WrapperConfig(dtype=tdt)
    jwrap = JW.make_wrapper(lambda p, xn: fm.apply({"params": p}, xn),
                            STATS5, jcfg)
    pwrap = PW.make_wrapper(lambda xn: m(xn), STATS5, pcfg, device="cpu")
    return JD.HybridDriver, PD.HybridDriver, jwrap, tree, pwrap


def _mlp_v2rh(dtype):
    """MLP_v2rh (hidden 32) through make_v2rh_wrapper (float32 only)."""
    fl = FlaxOnlineMLP(spec=SPEC2, hidden=(32,), compute_dtype=jnp.float32)
    params = fl.init(jax.random.PRNGKey(1),
                     jnp.zeros((1, SPEC2.input_len), jnp.float32))
    m = OnlineMLP(SPEC2, hidden=(32,), compute_dtype=torch.float32)
    m.load_state_dict(port_flax_online_mlp(
        jax.tree.map(np.asarray, params["params"])))
    return (JD.V2RHDriver, PD.V2RHDriver,
            JW.make_v2rh_wrapper(fl.apply, STATS2, SPEC2), params,
            PW.make_v2rh_wrapper(m, STATS2, SPEC2, device="cpu"))


def _linear_v2rh(dtype):
    """A float64 linear stand-in in the v2_rh layout (the port's
    make_v2rh_wrapper is float32): the V2RHDriver's own float64 math."""
    rng = np.random.default_rng(2)
    proj = rng.standard_normal((SPEC2.input_len, SPEC2.output_len)) / 60.0
    sub, div, osc = (np.asarray(a, np.float64) for a in (
        STATS2.inp_sub, STATS2.inp_div, STATS2.out_scale))
    tj = [jnp.asarray(a) for a in (sub, div, osc, proj)]
    tp = [torch.from_numpy(a) for a in (sub, div, osc, proj)]

    def jwrap(p, x):
        return ((x - tj[0]) / tj[1]) @ tj[3] / tj[2]

    def pwrap(x):
        return ((x - tp[0]) / tp[1]) @ tp[3] / tp[2]

    return JD.V2RHDriver, PD.V2RHDriver, jwrap, None, pwrap


CASES = {("unet", "f64"): _unet, ("unet", "f32"): _unet,
         ("mlp_v2rh", "f32"): _mlp_v2rh, ("linear_v2rh", "f64"): _linear_v2rh}
_BUILT: dict = {}


def case(name, dtype):
    """(JAX driver, params, port driver, JAX state, port state), made once
    a case (the JAX rollout compiles per driver)."""
    if (name, dtype) not in _BUILT:
        jcls, pcls, jwrap, params, pwrap = CASES[(name, dtype)](dtype)
        npdt = np.float64 if dtype == "f64" else np.float32
        x = columns(npdt)
        sj = JD.initial_state(x, JGRID)
        sp = PD.initial_state(x, GRID, device="cpu")
        fj, fp = forcings(sj, dtype)
        _BUILT[(name, dtype)] = (jcls(jwrap, JGRID, dyn_forcing=fj), params,
                                 pcls(pwrap, GRID, dyn_forcing=fp), sj, sp)
    return _BUILT[(name, dtype)]


# -- the pieces --------------------------------------------------------------
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_initial_state_matches_jax(dtype):
    npdt = np.float64 if dtype == "f64" else np.float32
    x = columns(npdt)
    sj = JD.initial_state(x, JGRID)
    sp = PD.initial_state(torch.from_numpy(x), GRID, device="cpu")
    for f in FIELDS:
        got, want = getattr(sp, f), np.asarray(getattr(sj, f))
        assert got.dtype == getattr(torch, npdt.__name__), f
        assert got.shape == want.shape, f
        if f == "q1":        # recovered from RH through pmid: computed
            close(got, want, dtype, f)
        else:                # copied from the columns
            np.testing.assert_array_equal(got.numpy(), want.astype(npdt))
    q1 = PD.physics_q1_from_rh(x, PD.get_varspec("v4"), GRID, device="cpu")
    np.testing.assert_array_equal(q1.numpy(), sp.q1.numpy())
    # the state is a copy: changing the columns afterwards changes nothing
    t0 = sp.t.clone()
    x[:, :60] += 1.0
    assert torch.equal(sp.t, t0)


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_newtonian_relaxation_matches_jax(dtype):
    """With lat and the diurnal cycle, at several absolute steps, on a
    state moved off the climatology; and on two members stacked on the
    batch axis, each relaxed toward the same climatology."""
    npdt = np.float64 if dtype == "f64" else np.float32
    sj = JD.initial_state(columns(npdt), JGRID)
    fj, fp = forcings(sj, dtype)
    rng = np.random.default_rng(4)
    moved = {"t": np.asarray(sj.t) + rng.normal(0, 2.0, (NCOL, 60)),
             "q1": np.asarray(sj.q1) * rng.uniform(0.8, 1.2, (NCOL, 60)),
             "u": np.asarray(sj.u) + rng.normal(0, 3.0, (NCOL, 60))}
    sj = dataclasses.replace(sj, **{k: jnp.asarray(v.astype(
        np.asarray(getattr(sj, k)).dtype)) for k, v in moved.items()})
    sp = PD.map_state(lambda a: torch.from_numpy(np.asarray(a).astype(npdt)),
                      sj)
    for step in (0, 17, 40, 71, 200):
        want = np.asarray(fj(sj, jnp.asarray(step)))
        got = fp(sp, step)
        assert got.dtype == sp.dyn.dtype and got.shape == (NCOL, 3, 60)
        for k, name in enumerate(("t", "q1", "u")):
            close(got[:, k], want[:, k], dtype, name)
    two = PD.map_state(lambda a: torch.cat([a, a]), sp)
    torch.testing.assert_close(fp(two, 17), torch.cat([fp(sp, 17)] * 2),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="climatology"):
        fp(PD.map_state(lambda a: a[:NCOL - 1], sp), 0)


@pytest.mark.parametrize("name,dtype", [("unet", "f64"), ("unet", "f32"),
                                        ("mlp_v2rh", "f32")])
def test_assemble_v4_matches_jax(name, dtype):
    """The features each driver hands its wrapper (v4 for HybridDriver,
    v2_rh for V2RHDriver), from the initial state and from a state with
    memory (after a step)."""
    jdrv, params, pdrv, sj, sp = case(name, dtype)
    with torch.no_grad():
        stepped = pdrv.step(sp, 0)[0]
    for j, p in ((sj, sp), (jdrv.step(params, sj, 0)[0], stepped)):
        want, got = np.asarray(jdrv.assemble_v4(j)), pdrv.assemble_v4(p)
        assert got.dtype == sp.t.dtype and got.shape == want.shape
        close(got, want, dtype)


# -- rollouts ----------------------------------------------------------------
@pytest.mark.parametrize("name,dtype", sorted(CASES))
def test_rollout_matches_jax(name, dtype):
    """STEPS steps with the relaxation and diurnal forcing: the final state
    and every trajectory key; the features with collect_features."""
    jdrv, params, pdrv, sj, sp = case(name, dtype)
    fj, tj = jdrv.rollout(params, sj, STEPS, True)
    with torch.no_grad():
        fp, tp = pdrv.rollout(sp, STEPS, collect_features=True)
    assert sorted(tp) == sorted(tj) == sorted(
        ["t", "q1", "qn", "u", "precc", "water_res", "x4"])
    # the features are those of the state before each step
    torch.testing.assert_close(tp["x4"][0], pdrv.assemble_v4(sp),
                               rtol=0, atol=0)
    for k, want in tj.items():
        assert tp[k].shape == want.shape, k
        if k == "x4" and dtype == "f32":
            close(tp[k][0, :, 60:120], _eager_rh(sj), dtype, "rh")
            tp[k], want = (np.delete(np.asarray(a), np.s_[60:120], axis=-1)
                           for a in (tp[k], want))
        close(tp[k], want, dtype, k)
    for f in FIELDS:
        close(getattr(fp, f), getattr(fj, f), dtype, f)
    assert (tp["q1"] >= 0).all() and (tp["qn"] >= 0).all()
    assert torch.isfinite(tp["water_res"]).all()


def _eager_rh(sj):
    """The RH of the JAX state ``sj`` by the JAX package's eager
    ``relative_humidity`` (see the module's docstring)."""
    from climsim_tpu import physics as JP

    pmid = JP.midlevel_pressure(sj.scalars[:, 0], JGRID.hyam, JGRID.hybm)
    return np.asarray(JP.relative_humidity(sj.t, sj.q1, pmid))


def test_segmented_rollout_equals_one_rollout():
    """Three segments with the running start_step equal the one long
    rollout within F32_TOL (bit-equal where the CPU's products sum in the
    same order, which a loaded host's threading need not keep); a segment
    that restarts the diurnal phase at 0 (a dropped start_step, planted)
    fails that tolerance."""
    _, _, pdrv, _, sp = case("unet", "f32")
    n, seg = 9, 3
    with torch.no_grad():
        final, whole = pdrv.rollout(sp, n)
        for planted in (False, True):
            s, parts = sp, []
            for k in range(n // seg):
                s, tr = pdrv.rollout(s, seg,
                                     start_step=0 if planted else k * seg)
                parts.append(tr)
            got = {key: torch.cat([p[key] for p in parts])
                   for key in whole}
            if not planted:
                for key in whole:
                    close(got[key], whole[key], "f32", key)
                for f in FIELDS:
                    close(getattr(s, f), getattr(final, f), "f32", f)
            else:
                with pytest.raises(AssertionError):
                    close(got["t"], whole["t"], "f32", "t")


def test_rollout_ensemble_matches_member_loop_and_jax():
    """Two members (the second 0.05 K warmer, as scripts/online_eval.py
    perturbs them) stacked on the batch axis: the per-member loop within
    F32_TOL, and the JAX package's vmapped ensemble too."""
    jdrv, params, pdrv, sj, sp = case("unet", "f32")
    rng = np.random.default_rng(1234)
    dt = (0.05 * rng.standard_normal((NCOL, 60))).astype(np.float32)
    members_j = [sj, dataclasses.replace(sj, t=sj.t + jnp.asarray(dt))]
    members_p = [sp, dataclasses.replace(sp, t=sp.t + torch.from_numpy(dt))]
    n = 3
    with torch.no_grad():
        ef, et = pdrv.rollout_ensemble(PD.stack_states(members_p), n)
        loop = [pdrv.rollout(s, n) for s in members_p]
    _, jt = jdrv.rollout_ensemble(
        params, jax.tree.map(lambda *a: jnp.stack(a), *members_j), n)
    for k in et:
        assert et[k].shape == (2,) + tuple(loop[0][1][k].shape), k
        assert et[k].shape == jt[k].shape, k
        close(et[k], jt[k], "f32", k)
        for mi in range(2):
            close(et[k][mi], loop[mi][1][k], "f32", k)
    for f in FIELDS:
        for mi in range(2):
            close(getattr(ef, f)[mi], getattr(loop[mi][0], f), "f32", f)


def test_n_steps_is_refused():
    """A rollout of no step raises.  (HybridDriver(remat=True) no longer
    raises: test_torch_rollout_ft.py holds it to remat=False.)"""
    with pytest.raises(ValueError, match="n_steps"):
        PD.HybridDriver(lambda x: x, GRID).rollout(
            PD.initial_state(columns(np.float32), GRID, device="cpu"), 0)
