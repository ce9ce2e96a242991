"""The port's coupling wrappers (climsim_tpu_torch.online.wrapper) and
target transform against climsim_tpu's, on raw synthetic v2_rh columns
with the packaged v2_rh norms.

Tolerances: the fast wrappers at rtol 2e-4, atol 1e-5, the reference's own
for two float32 implementations of this wrapper
(tests/test_pallas_kernels.py:120); the float32 v2_rh wrapper tighter, at
rtol 5e-5, atol 1e-6 (XLA and torch sum the float32 products in another
order).  Raw tendencies of water species are ~1e-8, below any such atol,
so each case also compares the outputs in normalized units (times
out_scale) at the kernels' tolerance, rtol 2e-4, atol 1e-4
(tests/test_pallas_kernels.py:88)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import transforms as T
from climsim_tpu.grid import load_default_grid
from climsim_tpu.models import OnlineMLP as FlaxOnlineMLP
from climsim_tpu.norms import NormStats, load_asset_norms
from climsim_tpu.online import wrapper as W
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.models import OnlineMLP
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

SPEC = get_varspec("v2_rh")
STATS = load_asset_norms("v2_rh")


def _models(hidden=(64, 64), compute=(jnp.float32, torch.float32),
            output_prune=False, seed=0):
    fl = FlaxOnlineMLP(spec=SPEC, hidden=hidden, compute_dtype=compute[0],
                       output_prune=output_prune)
    params = fl.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, SPEC.input_len), jnp.float32))
    m = OnlineMLP(SPEC, hidden=hidden, compute_dtype=compute[1],
                  output_prune=output_prune)
    m.load_state_dict(port_flax_online_mlp(
        jax.tree.map(np.asarray, params["params"])))
    return fl, params, m


def _close_normalized(got, want):
    scale = STATS.out_scale.astype(np.float32)
    np.testing.assert_allclose(got * scale, want * scale, rtol=2e-4,
                               atol=1e-4)


def _columns(n=32, seed=0):
    return synthetic_inputs(SPEC, n, load_default_grid(), seed=seed)


@pytest.mark.parametrize("published", [False, True])
def test_v2rh_wrapper_matches_jax(published):
    """The repo's clip-only contract, and the reference's published v2
    wrapper (qc/qi rates, cloud-input prune, V4_OUT_ZERO)."""
    fl, params, m = _models()
    kw, pkw = {}, {}
    if published:
        kw = dict(tcfg=T.TransformConfig(
            qn_transform=True, qinput_prune=True, strato_lev=15,
            input_clip=True, input_clip_rhonly=True), out_zero=W.V4_OUT_ZERO)
        pkw = dict(tcfg=PT.TransformConfig(
            qn_transform=True, qinput_prune=True, strato_lev=15,
            input_clip=True, input_clip_rhonly=True),
            out_zero=PW.V4_OUT_ZERO)
    x = _columns()
    want = np.asarray(W.make_v2rh_wrapper(fl.apply, STATS, SPEC, **kw)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = PW.make_v2rh_wrapper(m, STATS, SPEC, **pkw)(
            torch.from_numpy(x)).numpy()
    assert got.shape == (32, 368)
    np.testing.assert_allclose(got, want, rtol=5e-5, atol=1e-6)
    _close_normalized(got, want)
    if published:
        assert (got[:, 120:148] == 0).all()   # ptend_q0002 zeroed 28 deep


@pytest.mark.parametrize("wdtype", ["f32", "bf16", "int8"])
def test_fast_mlp_wrapper_matches_jax(wdtype):
    fl, params, m = _models()
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16),
                "int8": ("int8", "int8")}[wdtype]
    x = _columns(24, seed=1)
    want = np.asarray(W.make_fast_mlp_wrapper(fl, params, STATS, SPEC,
                                              weights_dtype=jdt)(
        jnp.asarray(x)))
    got = PW.make_fast_mlp_wrapper(m, STATS, SPEC, weights_dtype=tdt)(
        torch.from_numpy(x)).numpy()
    assert got.shape == (24, 368)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-5)
    _close_normalized(got, want)


def test_fast_wrapper_leaves_output_prune_off():
    """Like the reference, the fast path serves the plain network: it does
    not apply OnlineMLP.output_prune (a known gap, kept for parity)."""
    _, _, plain = _models(output_prune=False)
    _, _, pruned = _models(output_prune=True)
    x = torch.from_numpy(_columns(8, seed=2))
    a = PW.make_fast_mlp_wrapper(plain, STATS, SPEC, torch.float32)(x)
    b = PW.make_fast_mlp_wrapper(pruned, STATS, SPEC, torch.float32)(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        slow = PW.make_v2rh_wrapper(pruned, STATS, SPEC)(x)
    s = SPEC.output_slices["ptend_q0001"].start
    assert (slow[:, s:s + 12] == 0).all() and (a[:, s:s + 12] != 0).any()


def test_input_transform_missing_rate_fails_loud():
    stats = NormStats(inp_sub=STATS.inp_sub, inp_div=STATS.inp_div,
                      out_scale=STATS.out_scale)
    cfg = PT.TransformConfig(qn_transform=True)
    with pytest.raises(ValueError, match="state_q0002"):
        PT.make_input_transform(SPEC, stats, cfg)


@pytest.mark.parametrize("prune", [False, True])
def test_target_transform_matches_jax(prune):
    y = np.random.default_rng(4).standard_normal(
        (16, SPEC.output_len)).astype(np.float32) * 1e-4
    y[0, 5] = np.nan
    y[1, 7] = np.inf
    want = np.asarray(T.make_target_transform(
        SPEC, STATS, T.TransformConfig(output_prune=prune))(jnp.asarray(y)))
    got = PT.make_target_transform(
        SPEC, STATS, PT.TransformConfig(output_prune=prune))(
        torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
