"""The port's model zoo (ED, HSR, cVAE, CNN, RPN; the LayerNorm and dropout
of MLPTrunk; the channelized views, the UTLS subset, the zoo's losses, the
flax porters and the reference-checkpoint loaders) against the JAX package
on the CPU, from the same numpy seeds and weights.

Tolerances: the models at compute_dtype=float32 rtol 1e-5 / atol 1e-6 (as
test_torch_train.py), at bf16 atol 2e-2 * max|y|
(tests/test_pallas_kernels.py:172); the losses rtol 1e-6; gathers and
index layouts exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import models as JM
from climsim_tpu.data import transforms as JT
from climsim_tpu.models import rpn as JRPN
from climsim_tpu.models.common import MLPTrunk as FlaxTrunk
from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.train import losses as JL
from climsim_tpu.utils import migrate as JMIG
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.models import (CVAE, HSR, ClimSimCNN, ClimSimMLP,
                                      ClimSimUNet, EncoderDecoder, OnlineMLP,
                                      RPNEnsemble, RPNNet, build_model)
from climsim_tpu_torch.models.common import MLPTrunk, param_count
from climsim_tpu_torch.train import losses as PL
from climsim_tpu_torch.utils import migrate as PM

SPEC = get_varspec("v1")
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def perturbed(params, seed):
    """A flax tree as numpy, every 1-D leaf (biases, LayerNorm scales)
    moved off its init, so the porter's placement of each is checked."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda a: np.asarray(a) + (0.05 * rng.standard_normal(
            a.shape).astype(np.float32) if np.ndim(a) == 1 and a.shape[0]
            > 0 else 0), jax.tree.map(np.asarray, params))


def close(got, want, dtype):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())


def rows(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


def t(a):
    return torch.from_numpy(np.array(a, copy=True))


# -- models ------------------------------------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_trunk_layernorm_matches_flax(dtype):
    """MLPTrunk with LayerNorm: flax's fast variance, E[x^2] - E[x]^2, on
    inputs with a large mean (where the two-pass form differs most)."""
    jdt, tdt = DTYPES[dtype]
    x = rows(16, 12, 0) + 30.0
    fl = FlaxTrunk((24, 16), "relu", layernorm=True, compute_dtype=jdt)
    tree = perturbed(fl.init(jax.random.PRNGKey(0), jnp.asarray(x))[
        "params"], 1)
    want = np.asarray(fl.apply({"params": tree}, jnp.asarray(x)))
    m = MLPTrunk(12, (24, 16), "relu", tdt, layernorm=True)
    m.load_state_dict(PM._trunk(tree, ""))
    with torch.no_grad():
        got = m(t(x))
    assert got.dtype == torch.float32
    close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ed_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = rows(16, SPEC.input_len, 2)
    fl = JM.EncoderDecoder(spec=SPEC, intermediate=32, compute_dtype=jdt)
    tree = perturbed(fl.init(jax.random.PRNGKey(1), jnp.asarray(x))[
        "params"], 3)
    want = np.asarray(fl.apply({"params": tree}, jnp.asarray(x)))
    m = build_model("ed", SPEC, intermediate=32, compute_dtype=tdt)
    assert isinstance(m, EncoderDecoder)
    m.load_state_dict(PM.port_flax_ed(tree))
    with torch.no_grad():
        got = m(t(x))
    assert got.dtype == torch.float32
    close(got, want, dtype)
    assert param_count(m) == JM.common.param_count(tree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_hsr_matches_flax(dtype):
    jdt, tdt = DTYPES[dtype]
    x = rows(16, SPEC.input_len, 4)
    fl = JM.HSR(spec=SPEC, hidden=32, layers=2, compute_dtype=jdt)
    tree = perturbed(fl.init(jax.random.PRNGKey(2), jnp.asarray(x))[
        "params"], 5)
    mean_j, logprec_j = fl.apply({"params": tree}, jnp.asarray(x))
    m = build_model("hsr", SPEC, hidden=32, layers=2, compute_dtype=tdt)
    assert isinstance(m, HSR)
    m.load_state_dict(PM.port_flax_hsr(tree))
    m.eval()
    with torch.no_grad():
        mean, logprec = m(t(x))
    close(mean, mean_j, dtype)
    close(logprec, logprec_j, dtype)
    # sample: mean + exp(-logprec / 2) * eps, (B, D_out, S)
    with torch.no_grad():
        s = m.sample(t(x), torch.Generator().manual_seed(0), 5)
    assert s.shape == (16, SPEC.output_len, 5)
    eps = torch.randn(16, SPEC.output_len, 5,
                      generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(
        s, mean[..., None] + torch.exp(-0.5 * logprec)[..., None] * eps)
    assert param_count(m) == JM.common.param_count(tree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cvae_matches_flax(dtype):
    """encode, decode, and the training pass with eps fed (the JAX pass
    draws it from its key; the same eps goes to both)."""
    jdt, tdt = DTYPES[dtype]
    x = rows(16, SPEC.input_len, 6)
    y = rows(16, SPEC.output_len, 7)
    fl = JM.CVAE(spec=SPEC, latent=4, hidden=32, layers=2, compute_dtype=jdt)
    key = jax.random.PRNGKey(9)
    tree = perturbed(fl.init(jax.random.PRNGKey(3), jnp.asarray(y),
                             jnp.asarray(x))["params"], 8)
    v = {"params": tree}
    mu_j, ls_j = fl.apply(v, jnp.asarray(y), jnp.asarray(x),
                          method=JM.CVAE.encode)
    eps = np.asarray(jax.random.normal(key, mu_j.shape, dtype=mu_j.dtype))
    ym_j, ys_j, kl_j = fl.apply(v, jnp.asarray(y), jnp.asarray(x), rng=key)
    z = rows(16, 4, 10)
    dm_j, ds_j = fl.apply(v, jnp.asarray(z), jnp.asarray(x),
                          method=JM.CVAE.decode)
    m = build_model("cvae", SPEC, latent=4, hidden=32, layers=2,
                    compute_dtype=tdt)
    assert isinstance(m, CVAE)
    m.load_state_dict(PM.port_flax_cvae(tree))
    with torch.no_grad():
        mu, ls = m.encode(t(y), t(x))
        ym, ys, kl = m(t(y), t(x), t(eps))
        dm, ds = m.decode(t(z), t(x))
        ym0, _, _ = m(t(y), t(x))
    for got, want in ((mu, mu_j), (ls, ls_j), (ym, ym_j), (ys, ys_j),
                      (dm, dm_j), (ds, ds_j)):
        close(got, want, dtype)
    close(kl, kl_j, dtype)
    # eps None: z = mu (the JAX module's rng=None)
    ym0_j, _, _ = fl.apply(v, jnp.asarray(y), jnp.asarray(x))
    close(ym0, ym0_j, dtype)
    with torch.no_grad():
        s = m.sample(t(x), torch.Generator().manual_seed(0), 3)
        s0 = m.sample(t(x), torch.Generator().manual_seed(0), 2,
                      random=False)
    assert s.shape == (16, SPEC.output_len, 3)
    torch.testing.assert_close(s0[..., 0], m.decode(
        torch.zeros(16, 4), t(x))[0].detach())
    assert param_count(m) == JM.common.param_count(tree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("head", ["softplus", "relu"])
def test_cnn_matches_flax(head, dtype):
    jdt, tdt = DTYPES[dtype]
    xn = rows(8, SPEC.input_len, 11)
    x = np.asarray(JT.channelize_input(jnp.asarray(xn), SPEC))
    fl = JM.ClimSimCNN(spec=SPEC, depth=2, channels=24, scalar_head=head,
                       compute_dtype=jdt)
    tree = perturbed(fl.init(jax.random.PRNGKey(4), jnp.asarray(x))[
        "params"], 12)
    want = np.asarray(fl.apply({"params": tree}, jnp.asarray(x)))
    m = build_model("cnn", SPEC, depth=2, channels=24, scalar_head=head,
                    compute_dtype=tdt)
    assert isinstance(m, ClimSimCNN)
    m.load_state_dict(PM.port_flax_cnn(tree))
    m.eval()
    with torch.no_grad():
        got = m(PT.channelize_input(t(xn), SPEC))
    assert got.dtype == torch.float32
    close(got, want, dtype)
    assert param_count(m) == JM.common.param_count(tree)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_rpn_matches_flax(dtype):
    """One member (RPNNet) and the stacked ensemble: member-specific
    batches through ``forward``, a shared one through ``posterior``."""
    jdt, tdt = DTYPES[dtype]
    hidden = (32, 24)
    x = rows(8, SPEC.input_len, 13)
    ens_j = JRPN.RPNEnsemble(SPEC, 3, hidden, compute_dtype=jdt)
    params, prior = ens_j.init(jax.random.PRNGKey(5), jnp.asarray(x))
    params, prior = perturbed(params, 14), perturbed(prior, 15)
    xe = np.stack([rows(8, SPEC.input_len, 16 + e) for e in range(3)])
    fwd_j = np.asarray(ens_j.forward(params, prior, jnp.asarray(xe)))
    post_j = np.asarray(ens_j.posterior(params, prior, jnp.asarray(x)))
    ens = RPNEnsemble(SPEC, 3, hidden, compute_dtype=tdt)
    ens.load_state_dict(PM.port_flax_rpn(params, prior))
    with torch.no_grad():
        fwd, post = ens(t(xe)), ens.posterior(t(x))
    assert post.shape == (8, SPEC.output_len, 3)
    close(fwd, fwd_j, dtype)
    close(post, post_j, dtype)
    assert not any(p.requires_grad for p in ens.prior.parameters())
    # member 1 alone, as an RPNNet
    one = jax.tree.map(lambda a: a[1], params)
    net = build_model("rpn", SPEC, hidden=hidden, compute_dtype=tdt)
    assert isinstance(net, RPNNet)
    net.load_state_dict(PM.port_flax_online_mlp(one))
    want = np.asarray(ens_j.net.apply(one, jnp.asarray(x)))
    with torch.no_grad():
        close(net(t(x)), want, dtype)


def test_build_model_has_every_name():
    want = {"mlp": ClimSimMLP, "mlp_online": OnlineMLP, "cnn": ClimSimCNN,
            "ed": EncoderDecoder, "hsr": HSR, "cvae": CVAE, "rpn": RPNNet,
            "unet": ClimSimUNet}
    tiny = {"mlp": dict(hidden=(8,)), "mlp_online": dict(hidden=(8,)),
            "cnn": dict(depth=1, channels=8), "ed": dict(intermediate=32),
            "hsr": dict(hidden=8, layers=1), "cvae": dict(hidden=8,
                                                          layers=1),
            "rpn": dict(hidden=(8,)),
            "unet": dict(model_channels=8, channel_mult=(1,), num_blocks=1,
                         attn_resolutions=())}
    for name, cls in want.items():
        spec = get_varspec("v5") if name == "unet" else SPEC
        assert type(build_model(name, spec, **tiny[name])) is cls
    assert build_model("unet_classifier", get_varspec("v5"),
                       **tiny["unet"]).classifier
    with pytest.raises(KeyError):
        build_model("gan", SPEC)


# -- dropout -----------------------------------------------------------------

def test_dropout_masks():
    """Kept share within binomial bounds of 1 - p, kept units scaled by
    1 / (1 - p), a seed's mask the same twice and another seed's not, and
    no dropout in eval() mode."""
    p, n = 0.25, 64
    m = HSR(SPEC, hidden=256, layers=1, dropout=p).train()
    x = t(rows(n, SPEC.input_len, 20))
    h = m.mean_trunk.layers[0](x)
    h = m.mean_trunk.norms[0](h)
    from climsim_tpu_torch.models.common import dropout, step_generator

    d = dropout(h, p, step_generator(3, "cpu"))
    kept = d != 0
    share = kept.float().mean().item()
    sd = np.sqrt(p * (1 - p) / kept.numel())
    assert abs(share - (1 - p)) < 5 * sd
    torch.testing.assert_close(d[kept], h[kept] / (1 - p))
    with torch.no_grad():
        a, b, c = (m(x, s)[0] for s in (7, 7, 8))
        m.eval()
        e1, e2 = m(x, 7)[0], m(x, 8)[0]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a != c).any()
    torch.testing.assert_close(e1, e2, rtol=0, atol=0)
    m.dropout = 0.0
    for tr in (m.mean_trunk, m.logprec_trunk):
        tr.dropout = 0.0
    torch.testing.assert_close(m(x)[0], e1, rtol=0, atol=0)


def test_cnn_dropout_follows_the_seed():
    m = ClimSimCNN(SPEC, depth=2, channels=16, dropout=0.3).train()
    x = PT.channelize_input(t(rows(4, SPEC.input_len, 21)), SPEC)
    with torch.no_grad():
        a, b, c = (m(x, s) for s in (1, 1, 2))
        m.eval()
        e = m(x, 1)
        m.train()
        n = m(x)   # no seed: no masks
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a != c).any()
    torch.testing.assert_close(e, n, rtol=0, atol=0)


# -- channelized views and the UTLS subset ------------------------------------

@pytest.mark.parametrize("version", ["v1", "v2", "v5"])
def test_channelize_matches_jax(version):
    spec = get_varspec(version)
    x = rows(5, spec.input_len, 22)
    y = rows(5, spec.output_len, 23)
    np.testing.assert_array_equal(
        PT.channelize_input(t(x), spec).numpy(),
        np.asarray(JT.channelize_input(jnp.asarray(x), spec)))
    yc = PT.channelize_target(t(y), spec)
    np.testing.assert_array_equal(
        yc.numpy(), np.asarray(JT.channelize_target(jnp.asarray(y), spec)))
    yc_noisy = yc + 0.1 * t(rows(5 * 60, yc.shape[-1], 24)).reshape(
        yc.shape)
    np.testing.assert_allclose(
        PT.dechannelize_output(yc_noisy, spec).numpy(),
        np.asarray(JT.dechannelize_output(jnp.asarray(yc_noisy.numpy()),
                                          spec)), rtol=1e-6, atol=1e-7)
    # a broadcast target round-trips (a scalar as the mean of 60 copies)
    np.testing.assert_allclose(PT.dechannelize_output(yc, spec).numpy(), y,
                               rtol=1e-6, atol=0)


@pytest.mark.parametrize("version", ["v2", "v2_rh", "v5"])
def test_utls_indices_equal_jax(version):
    spec = get_varspec(version)
    for lo, hi in ((5, 21), (0, 60), (10, 12)):
        kw = dict(lo=lo, hi=hi)
        if not {"pbuf_ozone", "pbuf_CH4", "pbuf_N2O"} & set(spec.inputs):
            continue
        want = JT.utls_feature_indices(spec, **kw)
        got = PT.utls_feature_indices(spec, **kw)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    if version == "v2":
        assert len(PT.utls_feature_indices(spec)) == 425
    x = rows(3, spec.input_len, 25)
    idx = PT.utls_feature_indices(spec)
    np.testing.assert_array_equal(
        PT.make_subset_transform(idx, "cpu")(t(x)).numpy(), x[:, idx])


# -- losses --------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["mae", "mse"])
def test_channel_adjusted_matches_jax(kind):
    a = rows(6 * 60, 10, 26).reshape(6, 60, 10)
    b = rows(6 * 60, 10, 27).reshape(6, 60, 10)
    want = float(JL.channel_adjusted(jnp.asarray(a), jnp.asarray(b), SPEC,
                                     kind))
    got = float(PL.channel_adjusted(t(a), t(b), SPEC, kind))
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("mse_stage", [True, False])
def test_hsr_loss_matches_jax(mse_stage):
    m, lp, y = (rows(16, 30, s) for s in (28, 29, 30))
    want = float(JL.hsr_loss(jnp.asarray(m), jnp.asarray(lp), jnp.asarray(y),
                             mse_stage))
    got = float(PL.hsr_loss(t(m), t(lp), t(y), mse_stage))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_cvae_loss_matches_jax():
    m, y = rows(16, 30, 31), rows(16, 30, 32)
    std = np.exp(0.3 * rows(16, 30, 33))
    want = float(JL.cvae_loss(jnp.asarray(m), jnp.asarray(std),
                              jnp.asarray(0.7, jnp.float32), jnp.asarray(y),
                              0.05))
    got = float(PL.cvae_loss(t(m), t(std), torch.tensor(0.7), t(y), 0.05))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the reference's division by std, not std^2
    sq = float(torch.mean(0.5 * (t(y) - t(m)) ** 2 / t(std) ** 2
                          + torch.log(t(std)))) + 0.05 * 0.7
    assert abs(sq - got) > 1e-3


# -- porters and the reference-checkpoint loaders ----------------------------

def test_porters_reject_other_trees():
    with pytest.raises(KeyError):
        PM.port_flax_hsr({"mean_trunk": {}, "out": {}})
    with pytest.raises(KeyError):
        PM.port_flax_cvae({"enc_trunk": {}})
    with pytest.raises(KeyError):
        PM.port_flax_ed({"encoder": {"Dense_0": {}, "Dense_2": {}},
                         "decoder": {}, "out": {}})
    with pytest.raises(KeyError):
        PM.port_flax_cnn({"ResBlock_0": {}, "Conv1d_0": {}})


def _torch_state(named):
    """A reference torch state_dict: numpy arrays under the names."""
    rng = np.random.default_rng(40)
    return {k: (rng.standard_normal(s) / np.sqrt(s[-1]) if len(s) == 2
                else 0.1 * rng.standard_normal(s)).astype(np.float32)
            for k, s in named}


def _trunk_keys(prefix, widths, ln, key="linear{}."):
    out = []
    for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
        k = prefix + key.format(i)
        out += [(k + "0.weight", (b, a)), (k + "0.bias", (b,))]
        if ln:
            out += [(k + "1.weight", (b,)), (k + "1.bias", (b,))]
    return out


def _check_loader(state, jax_tree, porter, model, flax_model, *args):
    """The loader's state_dict equals the JAX loader followed by the
    porter, tensor for tensor, and the loaded model's forward equals the
    flax model's on the JAX loader's tree."""
    want = porter(jax_tree)
    assert set(state) == set(want)
    for k in want:
        torch.testing.assert_close(state[k], want[k], rtol=0, atol=0)
    model.load_state_dict(state)
    model.eval()
    with torch.no_grad():
        got = model(*(t(a) for a in args))
    ref = flax_model.apply({"params": jax_tree},
                           *(jnp.asarray(a) for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    ref if isinstance(ref, tuple) else (ref,)):
        close(g, w, "f32")


def test_reference_loaders_hsr_cvae_online_mlp():
    f32 = jnp.float32
    v2rh = get_varspec("v2_rh")
    din, dout = SPEC.input_len, SPEC.output_len
    x = rows(4, din, 41)
    # MLP_v2rh/training/mlp.py
    st = _torch_state(_trunk_keys("", (v2rh.input_len, 16, 16), False,
                                  "linears.{}.")
                      + [("final_linear.weight", (v2rh.output_len, 16)),
                         ("final_linear.bias", (v2rh.output_len,))])
    _check_loader(PM.port_online_mlp(st, 2), JMIG.port_online_mlp(st, 2),
                  PM.port_flax_online_mlp,
                  OnlineMLP(v2rh, hidden=(16, 16), compute_dtype=torch.float32),
                  JM.OnlineMLP(spec=v2rh, hidden=(16, 16), compute_dtype=f32),
                  rows(4, v2rh.input_len, 42))
    # HSR/training/hsr.py
    keys = []
    for part in ("mean", "logprec"):
        keys += _trunk_keys(part + ".", (din, 16, 16), True)
        keys += [(part + ".final_linear.weight", (dout, 16)),
                 (part + ".final_linear.bias", (dout,))]
    st = _torch_state(keys)
    _check_loader(PM.port_hsr(st, 2), JMIG.port_hsr(st, 2), PM.port_flax_hsr,
                  HSR(SPEC, hidden=16, layers=2, compute_dtype=torch.float32),
                  JM.HSR(spec=SPEC, hidden=16, layers=2, compute_dtype=f32), x)
    # cVAE/training/cvae.py (encode: the training pass's encoder)
    keys = (_trunk_keys("encoder.", (dout + din, 16, 16), True)
            + [("encoder.linear_mean.weight", (4, 16)),
               ("encoder.linear_mean.bias", (4,)),
               ("encoder.linear_logstd.weight", (4, 16)),
               ("encoder.linear_logstd.bias", (4,))]
            + _trunk_keys("decoder.", (4 + din, 16, 16), True)
            + [("decoder.final_linear1.weight", (dout, 16)),
               ("decoder.final_linear1.bias", (dout,)),
               ("decoder.final_log_std1.weight", (dout, 16)),
               ("decoder.final_log_std1.bias", (dout,))])
    st = _torch_state(keys)
    y = rows(4, dout, 43)
    _check_loader(PM.port_cvae(st, 2), JMIG.port_cvae(st, 2),
                  PM.port_flax_cvae,
                  CVAE(SPEC, latent=4, hidden=16, layers=2,
                       compute_dtype=torch.float32),
                  JM.CVAE(spec=SPEC, latent=4, hidden=16, layers=2,
                          compute_dtype=f32), y, x)


def test_reference_loaders_keras():
    f32 = jnp.float32
    rng = np.random.default_rng(44)
    din, dout = SPEC.input_len, SPEC.output_len

    def dense(a, b):
        return ((rng.standard_normal((a, b)) / np.sqrt(a)).astype(
                    np.float32),
                (0.1 * rng.standard_normal(b)).astype(np.float32))

    # hpo_baseline_v1.py: trunk, pre-head, linear head, relu head
    lin = dout - len(SPEC.output_scalar_vars)
    ws = [dense(din, 16), dense(16, 12), dense(12, dout),
          dense(dout, lin), dense(dout, dout - lin)]
    x = rows(4, din, 45)
    _check_loader(PM.port_keras_mlp(ws), JMIG.port_keras_mlp(ws),
                  PM.port_flax_mlp,
                  ClimSimMLP(SPEC, hidden=(16, 12),
                             compute_dtype=torch.float32),
                  JM.ClimSimMLP(spec=SPEC, hidden=(16, 12), compute_dtype=f32),
                  x)
    # ClimSIM_ED_1_3_train.py at intermediate=32: widths 32..2 -> latent 5
    m = 32
    enc_w = (m, m, m // 2, m // 4, m // 8, m // 16, 5)
    dec_w = (m // 16, m // 8, m // 4, m // 2, m, m)
    enc = [dense(a, b) for a, b in zip((din, *enc_w[:-1]), enc_w)]
    dec = [dense(a, b) for a, b in zip((5, *dec_w[:-1]), dec_w)]
    dec.append(dense(m, dout))
    _check_loader(PM.port_keras_ed(enc, dec), JMIG.port_keras_ed(enc, dec),
                  PM.port_flax_ed,
                  EncoderDecoder(SPEC, intermediate=m,
                                 compute_dtype=torch.float32),
                  JM.EncoderDecoder(spec=SPEC, intermediate=m,
                                    compute_dtype=f32), x)
    # hpo_train.py at depth 2, 8 channels (the 1x1 heads as Dense kernels)
    cin, c = len(SPEC.inputs), 8
    n_prof, n_scal = (len(SPEC.output_profile_vars),
                      len(SPEC.output_scalar_vars))

    def conv(k, a, b):
        w, bias = dense(a * k, b)
        return w.reshape(k, a, b), bias

    convs = []
    for blk in range(2):
        a = cin if blk == 0 else c
        convs += [conv(3, a, c), conv(3, c, c), conv(1, a, c)]
    convs += [dense(c, n_prof + n_scal), dense(n_prof + n_scal, n_prof),
              dense(n_prof + n_scal, n_scal)]
    xc = np.asarray(JT.channelize_input(jnp.asarray(x), SPEC))
    _check_loader(PM.port_keras_cnn(convs, 2), JMIG.port_keras_cnn(convs, 2),
                  PM.port_flax_cnn,
                  ClimSimCNN(SPEC, depth=2, channels=c, scalar_head="relu",
                             compute_dtype=torch.float32),
                  JM.ClimSimCNN(spec=SPEC, depth=2, channels=c,
                                scalar_head="relu", compute_dtype=f32), xc)


UNET_KW = dict(model_channels=8, channel_mult=(1, 2), num_blocks=1,
               attn_resolutions=(32,), seq_resolution=64, dropout=0.0,
               norm1_act=False, resample_proj=True, attn_heads=1)


def _reference_unet_state(tree):
    """The reference ClimsimUnet's state_dict names for a flax ClimSimUNet
    tree (the inverse of ``port_climsim_unet``): torch (Cout, Cin, K) conv
    weights, norms' ``weight``, the interleaved qkv channels."""
    st = {"emb_loc": tree["emb_loc"]}

    def conv(k, c):
        st[k + ".weight"] = np.transpose(c["Conv_0"]["kernel"], (2, 1, 0))
        st[k + ".bias"] = c["Conv_0"]["bias"]

    def norm(k, n):
        st[k + ".weight"], st[k + ".bias"] = n["scale"], n["bias"]

    def block(k, b):
        norm(k + ".norm0", b["norm0"])
        conv(k + ".conv0", b["conv0"])
        norm(k + ".norm1", b["norm1"])
        conv(k + ".conv1", b["conv1"])
        if "skip" in b:
            conv(k + ".skip", b["skip"])
        if "Attention_0" in b:
            a = b["Attention_0"]
            norm(k + ".norm2", a["norm"])
            w = np.transpose(a["qkv"]["Conv_0"]["kernel"], (2, 1, 0))
            bias = a["qkv"]["Conv_0"]["bias"]
            c = w.shape[0] // 3
            perm = np.concatenate([np.arange(c) * 3 + j for j in range(3)])
            wr, br = np.empty_like(w), np.empty_like(bias)
            wr[perm], br[perm] = w, bias
            st[k + ".qkv.weight"], st[k + ".qkv.bias"] = wr, br
            conv(k + ".proj", a["proj"])

    levels = len(UNET_KW["channel_mult"])
    for lvl in range(levels):
        r = 64 >> lvl
        if lvl == 0:
            conv(f"enc.{r}_conv", tree[f"enc{r}_conv"])
        else:
            block(f"enc.{r}_down", tree[f"enc{r}_down"])
        for i in range(UNET_KW["num_blocks"]):
            block(f"enc.{r}_block{i}", tree[f"enc{r}_block{i}"])
    for lvl in reversed(range(levels)):
        r = 64 >> lvl
        if lvl == levels - 1:
            for j in (0, 1):
                block(f"dec.{r}_in{j}", tree[f"dec{r}_in{j}"])
        else:
            block(f"dec.{r}_up", tree[f"dec{r}_up"])
        for i in range(UNET_KW["num_blocks"] + 1):
            block(f"dec.{r}_block{i}", tree[f"dec{r}_block{i}"])
    norm("dec_aux_norm.64_aux_norm", tree["out_norm"])
    conv("dec_aux_conv.64_aux_conv", tree["out_conv"])
    assert len(st) == sum(1 for _ in jax.tree.leaves(tree))
    return st


def test_reference_loader_unet():
    spec5 = get_varspec("v5")
    x = rows(2, spec5.input_len, 46)
    x[:, -1] = [17.0, 212.0]
    fl = FlaxUNet(spec=spec5, compute_dtype=jnp.float32, **UNET_KW)
    tree = perturbed(fl.init(jax.random.PRNGKey(6), jnp.asarray(x))[
        "params"], 47)
    st = _reference_unet_state(tree)
    kw = dict(channel_mult=UNET_KW["channel_mult"],
              num_blocks=UNET_KW["num_blocks"], seq_resolution=64)
    jtree = JMIG.port_climsim_unet(st, **kw)
    model = ClimSimUNet(spec5, compute_dtype=torch.float32, **UNET_KW)
    _check_loader(PM.port_climsim_unet(st, model, **kw), jtree,
                  lambda tr: PM.port_flax_unet(tr, model), model, fl, x)
