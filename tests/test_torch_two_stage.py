"""The port's two-stage gate (climsim_tpu_torch.online.two_stage) against
climsim_tpu.online.two_stage.

On fixed regressor outputs and logits: the classes must be identical and
the gated values within rtol 1e-6 (the same float32 formula, evaluated by
XLA and by torch), with the asset v5 stats, with identity stats and a
known raw qn, and without stats; plus the JAX test's properties
(tests/test_shardmap_twostage.py:68-107): class-1 levels drive qn to zero
over one step (atol 1e-8) and everything outside the qn block is
untouched.

Through tiny U-Nets: the port's fused engine for both networks against
flax ``model.apply`` (the classifier's stratosphere forcing included),
the gate composed into the whole ``make_wrapper`` on raw v4 and v5
columns, compared in normalized units at the engine's float32 tolerance,
1e-4 * max|y| (tests/test_torch_unet.py)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.norms import identity_norms, load_asset_norms
from climsim_tpu.online import wrapper as W
from climsim_tpu.online.two_stage import make_two_stage_apply as jax_gate
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.grid import load_default_grid
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.online.two_stage import make_two_stage_apply
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
from test_torch_unet import TINY, columns, perturb, port_model

SPEC5, SPEC4 = get_varspec("v5"), get_varspec("v4")
SL_QN = SPEC5.output_slices["ptend_qn"]
SL_QN_IN = SPEC5.input_slices["state_qn"]
STATS5 = load_asset_norms("v5")


def _identity_case(rng):
    """Identity norms with lbd_qn 1e4 and the qn block the exp-transformed
    raw qn, as the JAX test builds it."""
    stats = dataclasses.replace(identity_norms(SPEC5),
                                lbd_qn=np.full(60, 1e4))
    qn_raw = np.abs(rng.normal(size=(4, 60))).astype(np.float32) * 1e-4
    x = np.zeros((4, SPEC5.input_len), np.float32)
    x[:, SL_QN_IN] = 1.0 - np.exp(-qn_raw * 1e4)
    return stats, x, qn_raw


def _gate_both(stats, x, y, logits):
    jax_out = np.asarray(jax_gate(lambda p, xx: jnp.asarray(y),
                                  lambda p, xx: jnp.asarray(logits),
                                  stats=stats)((None, None), jnp.asarray(x)))
    got = make_two_stage_apply(lambda xx: torch.from_numpy(y),
                               lambda xx: torch.from_numpy(logits),
                               stats=stats, device="cpu")(
        torch.from_numpy(x)).numpy()
    return got, jax_out


@pytest.mark.parametrize("stats_kind", ["asset", "identity", "none"])
def test_gate_matches_jax(stats_kind):
    rng = np.random.default_rng(0)
    y = rng.normal(size=(4, SPEC5.output_len)).astype(np.float32)
    logits = (rng.normal(size=(4, 60, 3)) * 3).astype(np.float32)
    if stats_kind == "identity":
        stats, x, _ = _identity_case(rng)
    else:
        stats = STATS5 if stats_kind == "asset" else None
        # normalized columns as the served transform gives them
        x = columns(4, seed=3)
    got, want = _gate_both(stats, x, y, logits)
    assert got.shape == want.shape == (4, SPEC5.output_len)
    classes = logits.argmax(-1)
    assert set(np.unique(classes)) == {0, 1, 2}
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    if stats is None:   # class 1 falls back to class 0's answer
        assert (got[:, SL_QN][classes == 1] == 0).all()
    else:
        assert (got[:, SL_QN][classes == 1] != 0).any()


def test_gate_properties():
    """Class 0 -> 0, class 1 -> -qn / 1200 (qn reaches zero within atol
    1e-8 over a step), class 2 -> the regressor's value; the rest of the
    output untouched."""
    rng = np.random.default_rng(0)
    y = rng.normal(size=(4, SPEC5.output_len)).astype(np.float32)
    logits = (rng.normal(size=(4, 60, 3)) * 3).astype(np.float32)
    stats, x, qn_raw = _identity_case(rng)
    got, _ = _gate_both(stats, x, y, logits)
    classes = logits.argmax(-1)
    want_qn = np.where(classes == 2, y[:, SL_QN],
                       np.where(classes == 1, -qn_raw / 1200.0, 0.0))
    np.testing.assert_allclose(got[:, SL_QN], want_qn, rtol=2e-3,
                               atol=1e-12)
    qn_next = qn_raw + got[:, SL_QN] * 1200.0
    np.testing.assert_allclose(qn_next[classes == 1], 0.0, atol=1e-8)
    mask = np.ones(SPEC5.output_len, bool)
    mask[SL_QN] = False
    np.testing.assert_array_equal(got[:, mask], y[:, mask])


def _tiny_pair():
    """(flax regressor, its tree, flax classifier, its tree): TINY widths,
    the unet_v5 and unet_v5_classifier presets' output settings."""
    kws = (dict(TINY, output_prune=True, strato_lev_out=15),
           dict(TINY, classifier=True, output_prune=True, strato_lev_out=12))
    out = []
    for i, kw in enumerate(kws):
        fm = FlaxUNet(spec=SPEC5, compute_dtype=jnp.float32, **kw)
        params = fm.init(jax.random.PRNGKey(i),
                         jnp.asarray(columns(2)))["params"]
        out += [fm, kw, perturb(jax.tree.map(np.asarray, params),
                                seed=4 + i)]
    return out


def _scale368():
    s = STATS5.out_scale.astype(np.float64)
    return np.concatenate([s[:120], s[120:180], s[120:180], s[180:]])


@pytest.mark.parametrize("version", ["v4", "v5"])
def test_two_stage_wrapper_matches_jax(version):
    """Raw columns -> input transform -> both fused engines and the gate
    -> constraint head, against the JAX wrapper over flax model.apply;
    the classes the two sides pick are printed and must agree."""
    fr, kr, tr, fc, kc, tc = _tiny_pair()
    spec = SPEC4 if version == "v4" else SPEC5
    x = synthetic_inputs(spec, 12, load_default_grid(), seed=7)
    want = np.asarray(W.make_wrapper(
        jax_gate(lambda p, xn: fr.apply({"params": p}, xn),
                 lambda p, xn: fc.apply({"params": p}, xn), stats=STATS5),
        STATS5, W.WrapperConfig(input_version=version))(
        (tr, tc), jnp.asarray(x)))
    reg = port_model(kr, tr, torch.float32)
    cls = port_model(kc, tc, torch.float32)
    PK.reset_launches()
    with torch.inference_mode():
        got = PW.make_wrapper(
            make_two_stage_apply(partial(unet_apply_fused, reg),
                                 partial(unet_apply_fused, cls),
                                 stats=STATS5, device="cpu"),
            STATS5, PW.WrapperConfig(input_version=version), device="cpu")(
            torch.from_numpy(x)).numpy()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)
    assert got.shape == (12, 368) and np.isfinite(got).all()
    scale = _scale368()
    np.testing.assert_allclose(got * scale, want * scale, rtol=0,
                               atol=1e-4 * np.abs(want * scale).max())
    # the gate acted: every class occurs, class 0 in the top 12 levels
    xn = columns(12, seed=7) if version == "v5" else None
    if xn is not None:
        with torch.inference_mode():
            k = unet_apply_fused(cls, torch.from_numpy(xn)).argmax(-1)
        assert (k[:, :12] == 0).all()
        assert set(k.unique().tolist()) >= {0, 2}
