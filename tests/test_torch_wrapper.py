"""The port's coupling wrappers (climsim_tpu_torch.online.wrapper) and
target transform against climsim_tpu's, on raw synthetic v2_rh columns
with the packaged v2_rh norms, and the U-Net v5 wrapper on raw v4 and v5
columns with the packaged v5 norms.

Tolerances: the fast wrappers at rtol 2e-4, atol 1e-5, the reference's own
for two float32 implementations of this wrapper
(tests/test_pallas_kernels.py:120); the float32 v2_rh wrapper tighter, at
rtol 5e-5, atol 1e-6 (XLA and torch sum the float32 products in another
order).  Raw tendencies of water species are ~1e-8, below any such atol,
so each case also compares the outputs in normalized units (times
out_scale) at the kernels' tolerance, rtol 2e-4, atol 1e-4
(tests/test_pallas_kernels.py:88)."""

from functools import partial

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
        got = PW.make_v2rh_wrapper(m, STATS, SPEC, device="cpu", **pkw)(
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
    got = PW.make_fast_mlp_wrapper(m, STATS, SPEC, weights_dtype=tdt,
                                   device="cpu")(
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
    a = PW.make_fast_mlp_wrapper(plain, STATS, SPEC, torch.float32, "cpu")(x)
    b = PW.make_fast_mlp_wrapper(pruned, STATS, SPEC, torch.float32,
                                 "cpu")(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with torch.no_grad():
        slow = PW.make_v2rh_wrapper(pruned, STATS, SPEC, device="cpu")(x)
    s = SPEC.output_slices["ptend_q0001"].start
    assert (slow[:, s:s + 12] == 0).all() and (a[:, s:s + 12] != 0).any()


def test_input_transform_missing_rate_fails_loud():
    stats = NormStats(inp_sub=STATS.inp_sub, inp_div=STATS.inp_div,
                      out_scale=STATS.out_scale)
    cfg = PT.TransformConfig(qn_transform=True)
    with pytest.raises(ValueError, match="state_q0002"):
        PT.make_input_transform(SPEC, stats, cfg, device="cpu")


@pytest.mark.parametrize("prune", [False, True])
def test_target_transform_matches_jax(prune):
    y = np.random.default_rng(4).standard_normal(
        (16, SPEC.output_len)).astype(np.float32) * 1e-4
    y[0, 5] = np.nan
    y[1, 7] = np.inf
    want = np.asarray(T.make_target_transform(
        SPEC, STATS, T.TransformConfig(output_prune=prune))(jnp.asarray(y)))
    got = PT.make_target_transform(
        SPEC, STATS, PT.TransformConfig(output_prune=prune), device="cpu")(
        torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


# --------------------------------------------------------------------------
# the U-Net v5 coupling wrapper, end to end
# --------------------------------------------------------------------------
SPEC5, SPEC4 = get_varspec("v5"), get_varspec("v4")
STATS5 = load_asset_norms("v5")


def _scale368():
    """out_scale in the 368 contract's layout: qc and qi take qn's."""
    s = STATS5.out_scale.astype(np.float64)
    return np.concatenate([s[:120], s[120:180], s[120:180], s[180:]])


def test_convert_v4_to_v5_matches_jax():
    x = synthetic_inputs(SPEC4, 16, load_default_grid(), seed=3)
    want = np.asarray(W.convert_v4_to_v5(jnp.asarray(x)))
    got = PW.convert_v4_to_v5(torch.from_numpy(x)).numpy()
    assert got.shape == (16, SPEC5.input_len)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("version,dtype", [("v4", "bf16"), ("v5", "bf16"),
                                           ("v4", "f32")])
def test_v5_wrapper_matches_jax(version, dtype):
    """The served slice on the CPU: raw columns -> input transform -> the
    fused U-Net engine -> constraint head, the port's against the JAX
    package's, in normalized units (times out_scale) at the engine's
    tolerance (1e-4 * max|y| float32, 2e-2 * max|y| bf16)."""
    from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
    from climsim_tpu.ops.unet_infer import unet_apply_fused as jax_engine
    from climsim_tpu_torch.ops import kernels as PK
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from test_torch_unet import DTYPES, close, flax_case, port_model

    jdt, tdt = DTYPES[dtype]
    kw, tree = flax_case("prune")
    fm = FlaxUNet(spec=SPEC5, compute_dtype=jdt, **kw)
    spec = SPEC4 if version == "v4" else SPEC5
    x = synthetic_inputs(spec, 12, load_default_grid(), seed=6)
    want = np.asarray(W.make_wrapper(
        lambda p, xn: jax_engine(fm, p, xn), STATS5,
        W.WrapperConfig(input_version=version))(tree, jnp.asarray(x)))
    m = port_model(kw, tree, tdt)
    PK.reset_launches()
    with torch.inference_mode():
        got = PW.make_wrapper(
            partial(unet_apply_fused, m), STATS5,
            PW.WrapperConfig(input_version=version), device="cpu")(
            torch.from_numpy(x)).numpy()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)
    assert got.shape == (12, 368) and np.isfinite(got).all()
    close(got * _scale368(), want * _scale368(), dtype)
    s = SPEC5.output_slices["ptend_u"].start + 60    # u in the 368 layout
    assert (got[:, s:s + 15] == 0).all()


def test_v5_wrapper_float64_oracle_path():
    """WrapperConfig(dtype=float64) runs the plain versions in float64 on
    the CPU and matches the JAX wrapper's float64 path; on a CUDA device
    it is refused."""
    x = synthetic_inputs(SPEC4, 6, load_default_grid(), seed=8)
    # a linear stand-in model of the right widths keeps the comparison on
    # the wrapper's own float64 math
    proj = np.random.default_rng(0).standard_normal(
        (SPEC5.input_len, SPEC5.output_len)) / 40.0
    want = np.asarray(W.make_wrapper(
        lambda p, xn: xn @ jnp.asarray(proj), STATS5,
        W.WrapperConfig(dtype=jnp.float64))(None, jnp.asarray(x, jnp.float64)))
    got = PW.make_wrapper(lambda xn: xn @ torch.from_numpy(proj), STATS5,
                          PW.WrapperConfig(dtype=torch.float64),
                          device="cpu")(
        torch.from_numpy(x))
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy() * _scale368(),
                               want * _scale368(), rtol=1e-10, atol=1e-9)
    with pytest.raises(ValueError, match="float64"):
        PW.make_wrapper(lambda xn: xn, STATS5,
                        PW.WrapperConfig(dtype=torch.float64), device="cuda")
    with pytest.raises(ValueError, match="input_version"):
        PW.make_wrapper(lambda xn: xn, STATS5,
                        PW.WrapperConfig(input_version="v2_rh"), device="cpu")


def test_v5_wrapper_served_over_coupling_server():
    """Raw v4 columns over the TCP bridge: each reply is the direct
    wrapper call on the same rows (padded to the bucket on the server)."""
    from climsim_tpu_torch.online.server import CouplingClient, CouplingServer
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from test_torch_unet import flax_case, port_model

    kw, tree = flax_case("prune")
    m = port_model(kw, tree, torch.bfloat16)
    wrap = PW.make_wrapper(partial(unet_apply_fused, m), STATS5,
                           device="cpu")
    srv = CouplingServer(wrap, SPEC4.input_len, base_chunk=8,
                         max_batch=16, device="cpu").start()
    try:
        cl = CouplingClient("127.0.0.1", srv.port)
        for n, seed in ((8, 1), (5, 2)):
            x = synthetic_inputs(SPEC4, n, load_default_grid(), seed=seed)
            y = cl.step(x)
            with torch.inference_mode():
                direct = wrap(torch.from_numpy(x)).numpy()
            assert y.shape == (n, 368)
            np.testing.assert_allclose(
                y * _scale368(), direct * _scale368(), rtol=1e-5,
                atol=1e-6 * np.abs(direct * _scale368()).max())
        cl.close()
    finally:
        srv.stop()


def test_physics_tensor_functions_match_jax():
    """liquid_fraction, repartition_clouds and qn_exponential_transform,
    float64 on both sides (the wrapper's oracle path), bit for bit up to
    the last place."""
    from climsim_tpu import physics as JP
    from climsim_tpu_torch import physics as PP

    rng = np.random.default_rng(9)
    t = 230.0 + 70.0 * rng.random((6, 60))
    qc, qi = 1e-5 * rng.random((2, 6, 60))
    dt_t, dqn = 1e-3 * rng.standard_normal((2, 6, 60))
    lbd = 1.0 / (1e-6 + 1e-5 * rng.random(60))
    tt = [torch.from_numpy(a) for a in (t, qc, qi, dt_t, dqn)]
    np.testing.assert_allclose(PP.liquid_fraction(tt[0]).numpy(),
                               np.asarray(JP.liquid_fraction(t)), rtol=1e-14)
    for got, want in zip(PP.repartition_clouds(*tt),
                         JP.repartition_clouds(t, qc, qi, dt_t, dqn)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-12, atol=1e-20)
    np.testing.assert_allclose(
        PP.qn_exponential_transform(tt[1], torch.from_numpy(lbd)).numpy(),
        np.asarray(JP.qn_exponential_transform(qc, lbd)), rtol=1e-12)


# --------------------------------------------------------------------------
# the v4 U-Net coupling wrapper
# --------------------------------------------------------------------------
STATS4 = load_asset_norms("v4")
V4_TCFG = {"default": (None, None),
           "preset": (T.TransformConfig(), PT.TransformConfig())}


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("tcfg", sorted(V4_TCFG))
def test_v4_wrapper_matches_jax(tcfg, dtype):
    """Raw v4 columns -> input transform (the default's qc/qi rates and
    cloud-input prune, or the unet_v4 preset's plain normalization) ->
    the fused U-Net engine on the v4 columns -> V4_OUT_ZERO -> un-scale,
    the port's against the JAX package's, in normalized units at the
    engine's tolerance (1e-4 * max|y| float32, 2e-2 * max|y| bf16)."""
    from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
    from climsim_tpu.ops.unet_infer import unet_apply_fused as jax_engine
    from climsim_tpu_torch.models import ClimSimUNet
    from climsim_tpu_torch.ops import kernels as PK
    from climsim_tpu_torch.ops.unet_infer import unet_apply_fused
    from climsim_tpu_torch.utils.migrate import port_flax_unet
    from test_torch_unet import DTYPES, TINY, close, perturb

    jdt, tdt = DTYPES[dtype]
    jcfg, pcfg = V4_TCFG[tcfg]
    x = synthetic_inputs(SPEC4, 12, load_default_grid(), seed=11)
    fm = FlaxUNet(spec=SPEC4, compute_dtype=jdt, **TINY)
    tree = perturb(jax.tree.map(np.asarray, fm.init(
        jax.random.PRNGKey(0), jnp.zeros((2, SPEC4.input_len)))["params"]))
    want = np.asarray(W.make_v4_wrapper(
        lambda p, xn: jax_engine(fm, p, xn), STATS4, SPEC4, tcfg=jcfg)(
        tree, jnp.asarray(x)))
    m = ClimSimUNet(SPEC4, compute_dtype=tdt, **TINY)
    m.load_state_dict(port_flax_unet(tree, m))
    PK.reset_launches()
    with torch.inference_mode():
        got = PW.make_v4_wrapper(partial(unet_apply_fused, m.eval()),
                                 STATS4, SPEC4, tcfg=pcfg, device="cpu")(
            torch.from_numpy(x)).numpy()
    assert PK.LAUNCHES == dict.fromkeys(PK.LAUNCHES, 0)
    assert got.shape == (12, 368) and np.isfinite(got).all()
    scale = STATS4.out_scale.astype(np.float64)
    close(got * scale, want * scale, dtype)
    assert (got[:, 120:148] == 0).all()   # ptend_q0002 zeroed 28 deep
