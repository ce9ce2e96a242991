"""The port's kernel functions (climsim_tpu_torch.ops.kernels) on the CPU,
where they take their plain PyTorch versions, against the Pallas kernels
they replace (interpret mode) and the XLA chains those kernels fuse.

Tolerances are the JAX package's own for the same functions
(tests/test_pallas_kernels.py:28, :69, :88, :138, :172)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data import transforms as T
from climsim_tpu.grid import load_default_grid
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.ops import kernels as K
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.ops import kernels as PK

# (spec, the port's config, the reference's config)
TRANSFORM_CASES = {
    "v5_online": ("v5", PT.v5_online_config(), T.v5_online_config()),
    "v2rh_clip_only": (
        "v2_rh",
        PT.TransformConfig(input_clip=True, input_clip_rhonly=True),
        T.TransformConfig(input_clip=True, input_clip_rhonly=True)),
    "v4_qc_qi_rates": (
        "v4",
        PT.TransformConfig(qn_transform=True, qinput_prune=True,
                           strato_lev=15, input_clip=True,
                           input_clip_rhonly=True),
        T.TransformConfig(qn_transform=True, qinput_prune=True,
                          strato_lev=15, input_clip=True,
                          input_clip_rhonly=True)),
}


def _raw_columns(spec, n, seed):
    x = synthetic_inputs(spec, n, load_default_grid(), seed=seed)
    cloud = [spec.input_slices[v].start + 40
             for v in ("state_qn", "state_q0002", "state_q0003")
             if v in spec.input_slices]
    x[0, 3] = np.nan
    x[1, 9] = np.inf
    x[2, 70] = -np.inf
    for i, j in enumerate(cloud):
        x[3 + i, j] = (np.nan, np.inf, -np.inf)[i]
    return x


@pytest.mark.parametrize("case", sorted(TRANSFORM_CASES))
def test_input_transform_matches_pallas_and_xla(case):
    version, pcfg, jcfg = TRANSFORM_CASES[case]
    spec, stats = get_varspec(version), load_asset_norms(version)
    x = _raw_columns(spec, 48, seed=7)

    got = PT.make_input_transform(spec, stats, pcfg, device="cpu")(
        torch.from_numpy(x)).numpy()
    assert PK.LAUNCHES["fused_input_transform"] == 0  # CPU: plain version

    xla = np.asarray(T.make_input_transform(spec, stats, jcfg)(
        jnp.asarray(x)))
    np.testing.assert_allclose(got, xla, rtol=1e-5, atol=1e-7)

    # The Pallas kernel applies the state_qn rate only; for the separate
    # qc/qi rates of the v4 family feed it columns with the rate applied.
    xp = x.copy()
    if version != "v5":
        for name, rate in (("state_q0002", stats.lbd_qc),
                           ("state_q0003", stats.lbd_qi)):
            if jcfg.qn_transform:
                sl = spec.input_slices[name]
                xp[:, sl] = 1.0 - np.exp(-xp[:, sl] * rate.astype(np.float32))
    pallas = np.asarray(K.make_fused_input_transform(
        spec, stats, jcfg, tile_b=32)(jnp.asarray(xp)))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-7)
    assert np.isfinite(got).all()


def _mlp_params(widths, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.standard_normal(o)).astype(np.float32)
          for o in widths[1:]]
    return ws, bs


def _xla_mlp(x, ws, bs, relu_tail, int8_scales=None):
    """The jnp chain the fused-MLP kernels fuse (f32 activations times
    widened weights; with scales, bf16 activations times int8 weights)."""
    h = jnp.asarray(x)
    for i, (w, b) in enumerate(zip(ws, bs)):
        if int8_scales is None:
            h = jnp.dot(h, jnp.asarray(w).astype(jnp.float32)) + b
        else:
            h = jnp.dot(h.astype(jnp.bfloat16), jnp.asarray(w).astype(
                jnp.bfloat16), preferred_element_type=jnp.float32)
            h = h * int8_scales[i] + b
        if i < len(ws) - 1:
            h = jnp.maximum(h, 0.0)
    d = h.shape[1]
    return np.asarray(h.at[:, d - relu_tail:].set(
        jnp.maximum(h[:, d - relu_tail:], 0.0)))


WIDTHS = (557, 96, 64, 368)


@pytest.mark.parametrize("b", [1, 7, 256])
@pytest.mark.parametrize("wdtype", ["bf16", "f32"])
def test_fused_mlp_matches_pallas_and_xla(wdtype, b):
    ws, bs = _mlp_params(WIDTHS, seed=11)
    x = np.random.default_rng(b).standard_normal(
        (b, WIDTHS[0])).astype(np.float32)
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "f32": (torch.float32, jnp.float32)}[wdtype]
    mlp = PK.pack_mlp(ws, bs, tdt, device="cpu")
    got = PK.fused_mlp_forward(torch.from_numpy(x), mlp, relu_tail=8).numpy()
    assert PK.LAUNCHES["fused_mlp_forward"] == 0

    wj = [jnp.asarray(w).astype(jdt) for w in ws]
    pallas = np.asarray(K.fused_mlp_forward(jnp.asarray(x), wj, bs,
                                            relu_tail=8, tile_b=64))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got, _xla_mlp(x, wj, bs, 8),
                               rtol=2e-4, atol=1e-4)
    assert (got[:, -8:] >= 0).all()


def test_quantize_weights_int8_bit_equal():
    ws, _ = _mlp_params((124, 256, 128), seed=3)
    ws.append(np.zeros((128, 4), np.float32))  # all-zero channels: scale 1
    qj, sj = K.quantize_weights_int8(ws)
    qp, sp = PK.quantize_weights_int8(ws)
    for a, b in zip(qj, qp):
        assert b.dtype == torch.int8
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(sj, sp):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("b", [1, 7, 256])
def test_fused_mlp_int8_matches_pallas_and_xla(b):
    ws, bs = _mlp_params(WIDTHS, seed=12)
    x = np.random.default_rng(b).standard_normal(
        (b, WIDTHS[0])).astype(np.float32)
    mlp = PK.pack_mlp(ws, bs, "int8", device="cpu")
    got = PK.fused_mlp_forward_int8(torch.from_numpy(x), mlp,
                                    relu_tail=8).numpy()
    assert PK.LAUNCHES["fused_mlp_forward_int8"] == 0

    qs, scales = K.quantize_weights_int8(ws)
    pallas = np.asarray(K.fused_mlp_forward_int8(
        jnp.asarray(x), qs, scales, bs, relu_tail=8, tile_b=64))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(got, _xla_mlp(x, qs, bs, 8, scales),
                               rtol=2e-4, atol=1e-4)


def test_int8_fused_mlp_accuracy():
    """Weight-only int8 stays within quantization error of f32
    (the reference's acceptance, tests/test_pallas_kernels.py:123-141)."""
    rng = np.random.default_rng(0)
    ws = [rng.normal(size=(124, 256)).astype(np.float32) * 0.1,
          rng.normal(size=(256, 128)).astype(np.float32) * 0.1]
    bs = [rng.normal(size=(256,)).astype(np.float32) * 0.01,
          rng.normal(size=(128,)).astype(np.float32) * 0.01]
    x = rng.normal(size=(32, 124)).astype(np.float32)

    want = np.maximum(x @ ws[0] + bs[0], 0) @ ws[1] + bs[1]
    got = PK.fused_mlp_forward_int8(
        torch.from_numpy(x), PK.pack_mlp(ws, bs, "int8", device="cpu")).numpy()
    err = np.abs(got - want) / (np.abs(want).mean() + 1e-6)
    assert err.mean() < 0.02, err.mean()
    qs, scales = PK.quantize_weights_int8(ws)
    wdq = qs[0].float().numpy() * scales[0].numpy()[None, :]
    assert np.abs(wdq - ws[0]).max() <= (np.abs(ws[0]).max() / 127) + 1e-6


# (C, Cout, groups), offset: the cases of tests/test_pallas_kernels.py:156-159;
# offset 1e3 puts |mean| >> std, where a one-pass variance cancels
GN_CASES = {"c128": ((128, 128, 32), 0.0), "c256_to_128": ((256, 128, 32), 0.0),
            "c64": ((64, 64, 16), 0.0), "offset_1e3": ((128, 128, 32), 1e3)}


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(GN_CASES))
def test_fused_gn_silu_conv3_matches_pallas_and_xla(case, dtype):
    """Kernel 5's plain version against the Pallas kernel (interpret mode)
    and the XLA chain: rtol 1e-5 / atol 1e-5 * max|y| at float32 compute,
    atol 2e-2 * max|y| at bf16 (test_pallas_kernels.py:172)."""
    from climsim_tpu.ops.unet_fused import (fused_gn_silu_conv3,
                                            xla_gn_silu_conv3)
    from climsim_tpu_torch.models.unet import _num_groups
    from climsim_tpu_torch.ops import unet_fused as PU

    (c, cout, groups), offset = GN_CASES[case]
    assert _num_groups(c) == groups
    rng = np.random.default_rng(3)
    b, l = 16, 64
    x = (rng.standard_normal((b, l, c)) + offset).astype(np.float32)
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    w = (rng.standard_normal((3, c, cout)) / np.sqrt(3 * c)).astype(np.float32)
    bias = rng.standard_normal(cout).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    args = [jnp.asarray(a) for a in (x, gamma, beta, w, bias)]
    xla = np.asarray(xla_gn_silu_conv3(*args, groups=groups,
                                       compute_dtype=jdt), np.float64)
    pallas = np.asarray(fused_gn_silu_conv3(
        *args, groups=groups, batch_tile=8, compute_dtype=jdt), np.float64)
    PK.reset_launches()
    got = PU.fused_gn_silu_conv3(
        torch.from_numpy(x), torch.from_numpy(gamma), torch.from_numpy(beta),
        torch.from_numpy(w).to(tdt), torch.from_numpy(bias)).double().numpy()
    assert PK.LAUNCHES["fused_gn_silu_conv3"] == 0   # CPU: plain version
    assert got.shape == (b, l, cout)
    if dtype == "f32" and offset:
        # at |x| ~ 1e3 float32 resolves 6e-5 of a unit std, so no two
        # float32 orders of summation agree to 1e-5 (the Pallas kernel and
        # the XLA chain differ by 7e-5 * max|y|): hold all three to the
        # float64 chain at 1.5e-4 * max|y| instead
        exact = PU.xla_gn_silu_conv3_plain(*[
            torch.from_numpy(a).double() for a in (x, gamma, beta, w, bias)
        ]).numpy()
        scale = np.abs(exact).max()
        for a in (got, xla, pallas):
            np.testing.assert_allclose(a, exact, rtol=0, atol=1.5e-4 * scale)
        return
    for want in (xla, pallas):
        scale = np.abs(want).max()
        if dtype == "f32":
            np.testing.assert_allclose(got, want, rtol=1e-5,
                                       atol=1e-5 * scale)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-2 * scale)


@pytest.mark.parametrize("b", [1, 7, 24])
def test_fused_constraint_head_matches_pallas_and_wrapper_math(b):
    """Kernel 4's plain version against the Pallas kernel (interpret mode)
    and the wrapper's XLA chain, at rtol 2e-4 / atol 1e-9
    (test_pallas_kernels.py:69)."""
    from climsim_tpu import physics

    stats = load_asset_norms("v5")
    rng = np.random.default_rng(2)
    y = rng.normal(size=(b, 308)).astype(np.float32)
    t = (260 + 30 * rng.random((b, 60))).astype(np.float32)
    qc = np.abs(rng.normal(size=(b, 60))).astype(np.float32) * 1e-5
    qi = np.abs(rng.normal(size=(b, 60))).astype(np.float32) * 1e-5
    consts = PK.constraint_head_consts(stats.out_scale, 15, device="cpu")
    got = PK.fused_constraint_head(*map(torch.from_numpy, (y, t, qc, qi)),
                                   consts, 1200.0).numpy()
    assert PK.LAUNCHES["fused_constraint_head"] == 0
    assert got.shape == (b, 368)

    pallas = np.asarray(K.make_fused_constraint_head(
        stats, strato_lev_out=15, tile_b=16)(*map(jnp.asarray,
                                                  (y, t, qc, qi))))
    np.testing.assert_allclose(got, pallas, rtol=2e-4, atol=1e-9)
    yu = y * consts[0].numpy() * consts[1].numpy()
    dqc, dqi = physics.repartition_clouds(
        jnp.asarray(t), jnp.asarray(qc), jnp.asarray(qi),
        jnp.asarray(yu[:, 0:60]), jnp.asarray(yu[:, 120:180]))
    want = np.concatenate([yu[:, :120], np.asarray(dqc), np.asarray(dqi),
                           yu[:, 180:]], axis=1)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-9)
    assert (got[:, 60:75] == 0).all() and (got[:, 240:255] == 0).all()
