"""The port's U-Net (climsim_tpu_torch.models.unet) against the flax
ClimSimUNet of climsim_tpu, with the weights moved across by
``port_flax_unet``, and the porter itself.

Parameters are perturbed away from the flax init: every conv kernel at
full xavier scale (the init scales conv1, the attention proj and out_conv
by 1e-5, which would hide half of the network), GroupNorm scale ~1 and
bias ~0 with noise, emb_loc normal.  Inputs are synthetic v5 columns from
a seed, normalized by the port's input transform, the same float32 array
for both sides.

Tolerances (the JAX engine test's, tests/test_unet_infer.py:44-46, :89-95):
1e-4 * max|y| at compute_dtype=float32 (flax's E[x^2]-E[x]^2 GroupNorm
against the two-pass engines leaves ~6e-5), 2e-2 * max|y| at bf16 (one
flipped bf16 rounding moves a value by 2**-8 relative and carries on)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.grid import load_default_grid
from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.norms import load_asset_norms
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data import transforms as PT
from climsim_tpu_torch.data.synthetic import synthetic_inputs
from climsim_tpu_torch.models import ClimSimUNet, build_model
from climsim_tpu_torch.ops import unet_infer as PI
from climsim_tpu_torch.config import PRESETS
from climsim_tpu_torch.utils.migrate import port_flax_unet

SPEC = get_varspec("v5")
UNET_V5 = PRESETS["unet_v5"].model_kw
TINY = dict(model_channels=32, channel_mult=(1, 2), num_blocks=1,
            attn_resolutions=(32,))
VARIANTS = {
    "attn": TINY,
    "prune": dict(TINY, attn_resolutions=(), output_prune=True,
                  strato_lev_out=15),
    "skipconv": dict(TINY, skip_conv=True),
    "classifier": dict(TINY, classifier=True),
    "reference_flags": dict(TINY, norm1_act=False, resample_proj=True,
                            attn_heads=1),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def perturb(tree, seed=1):
    """A flax U-Net tree (numpy leaves) with every conv at full xavier
    scale, GroupNorm scale ~1 / bias ~0, small conv biases, emb_loc
    normal."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name, a = path[-1].key, np.asarray(a)
        if name == "kernel":
            k, cin, cout = a.shape
            lim = np.sqrt(6.0 / ((cin + cout) * k))
            out = rng.uniform(-lim, lim, a.shape)
        elif name == "scale":
            out = 1.0 + 0.2 * rng.standard_normal(a.shape)
        elif name == "bias":
            out = 0.1 * rng.standard_normal(a.shape)
        elif name == "emb_loc":
            out = rng.standard_normal(a.shape)
        else:
            raise KeyError(name)
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def columns(n=8, seed=0):
    """Normalized v5 columns (the served input transform, plain path)."""
    x = synthetic_inputs(SPEC, n, load_default_grid(), seed=seed)
    t = PT.make_input_transform(SPEC, load_asset_norms("v5"),
                                PT.v5_online_config(), device="cpu")
    return t(torch.from_numpy(x)).numpy()


_TREES: dict = {}


def flax_case(variant: str):
    """(flax model kwargs, perturbed tree), the tree made once a variant."""
    kw = VARIANTS[variant]
    if variant not in _TREES:
        params = FlaxUNet(spec=SPEC, **kw).init(
            jax.random.PRNGKey(0), jnp.asarray(columns(2)))["params"]
        _TREES[variant] = perturb(jax.tree.map(np.asarray, params))
    return kw, _TREES[variant]


def port_model(kw, tree, compute_dtype):
    m = ClimSimUNet(SPEC, compute_dtype=compute_dtype, **kw)
    m.load_state_dict(port_flax_unet(tree, m))
    return m.eval()


def close(got, want, dtype):
    scale = np.abs(want).max()
    atol = (1e-4 if dtype == "f32" else 2e-2) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet_matches_flax(variant, dtype):
    jdt, tdt = DTYPES[dtype]
    kw, tree = flax_case(variant)
    x = columns()
    want = np.asarray(FlaxUNet(spec=SPEC, compute_dtype=jdt, **kw).apply(
        {"params": tree}, jnp.asarray(x)), np.float64)
    m = port_model(kw, tree, tdt)
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    close(got.double().numpy(), want, dtype)
    if kw.get("output_prune"):
        s = SPEC.output_slices["ptend_q0001"].start
        assert (got[:, s:s + 15] == 0).all()


def test_classifier_stratosphere_forcing():
    """classifier + output_prune forces class 0 in the top levels, as the
    flax model does (models/unet.py:430-445)."""
    kw = dict(TINY, classifier=True, output_prune=True, strato_lev_out=12)
    params = FlaxUNet(spec=SPEC, **kw).init(
        jax.random.PRNGKey(0), jnp.asarray(columns(2)))["params"]
    tree = perturb(jax.tree.map(np.asarray, params), seed=3)
    x = columns(4, seed=5)
    want = np.asarray(FlaxUNet(spec=SPEC, compute_dtype=jnp.float32,
                               **kw).apply({"params": tree}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(kw, tree, torch.float32)(torch.from_numpy(x))
    close(got.numpy(), want, "f32")
    np.testing.assert_array_equal(got[:, :12].numpy(),
                                  np.broadcast_to([1e2, 0.0, 0.0], (4, 12, 3)))


def test_porter_maps_every_leaf_once():
    kw, tree = flax_case("skipconv")
    m = ClimSimUNet(SPEC, **kw)
    state = port_flax_unet(tree, m)
    assert len(state) == len(jax.tree.leaves(tree)) == len(m.state_dict())
    k = tree["enc64_block0"]["conv0"]["Conv_0"]["kernel"]   # (K, Cin, Cout)
    np.testing.assert_array_equal(
        state["enc64_block0.conv0.weight"].numpy(), k.transpose(2, 1, 0))
    np.testing.assert_array_equal(state["enc64_block0.norm0.weight"].numpy(),
                                  tree["enc64_block0"]["norm0"]["scale"])
    assert state["emb_loc"].shape == (385, 8)
    assert state["skipconv0.weight"].shape == (32, 32, 1)
    # a leaf the porter does not know, a tree that misses a tensor, and
    # one whose shapes disagree with the model are refused
    bad = dict(tree, extra={"Conv_0": {"kernel": np.zeros((3, 2, 2)),
                                       "bias": np.zeros(2), "x": 0}})
    with pytest.raises(KeyError):
        port_flax_unet(bad, m)
    with pytest.raises(KeyError):
        port_flax_unet({k: v for k, v in tree.items() if k != "out_conv"}, m)
    with pytest.raises(ValueError):
        port_flax_unet(tree, ClimSimUNet(SPEC, **dict(kw, model_channels=16)))


def test_full_width_parameter_count():
    """The unet_v5 preset: 21,231,125 parameters on both sides, and the
    flax tree's every leaf fills the port's module."""
    shapes = jax.eval_shape(
        FlaxUNet(spec=SPEC, **UNET_V5).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, SPEC.input_len), jnp.float32))["params"]
    tree = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    m = build_model("unet", SPEC, **UNET_V5)
    assert sum(p.numel() for p in m.parameters()) == 21_231_125
    assert sum(a.size for a in jax.tree.leaves(tree)) == 21_231_125
    m.load_state_dict(port_flax_unet(tree, m))


# (L, C, Cout) -> calls: the fused chains of one unet_v5 forward
FUSED_CHAINS = {
    (64, 128, 128): 13, (64, 256, 128): 4, (64, 256, 256): 1,
    (64, 384, 128): 1, (32, 128, 128): 1, (32, 128, 256): 1,
    (32, 256, 256): 13, (32, 384, 256): 1, (32, 512, 256): 4,
    (16, 256, 256): 15, (16, 512, 256): 5, (8, 256, 256): 18,
    (8, 512, 256): 5}


def test_full_width_engine_runs_82_fused_chains(monkeypatch):
    m = build_model("unet", SPEC, **UNET_V5,
                    generator=torch.Generator().manual_seed(0)).eval()
    seen = []
    real = PI.fused_gn_silu_conv3

    def record(x, gamma, beta, w, b):
        seen.append((x.shape[1], x.shape[2], w.shape[2]))
        assert w.dtype == torch.bfloat16   # cast once, when prepared
        return real(x, gamma, beta, w, b)

    monkeypatch.setattr(PI, "fused_gn_silu_conv3", record)
    with torch.inference_mode():
        y = PI.unet_apply_fused(m, torch.from_numpy(columns(1)))
    assert y.shape == (1, SPEC.output_len)
    assert len(seen) == 82
    assert {s: seen.count(s) for s in set(seen)} == FUSED_CHAINS


def test_build_model_unet_and_classifier():
    gen = torch.Generator().manual_seed(0)
    m = build_model("unet_classifier", SPEC, **TINY, generator=gen)
    assert m.classifier and m.out_conv.weight.shape[0] == 3
    again = build_model("unet_classifier", SPEC, **TINY,
                        generator=torch.Generator().manual_seed(0))
    assert torch.equal(again.enc64_conv.weight, m.enc64_conv.weight)
    u = build_model("unet", SPEC, **TINY)
    assert not u.classifier and u.out_conv.weight.shape[0] == 13
    # xavier-uniform bound, zero-init convs scaled by 1e-5
    w = u.enc64_block0.conv0.weight
    assert w.abs().max() <= np.sqrt(6 / (3 * (32 + 32)))
    assert u.enc64_block0.conv1.weight.abs().max() < 1e-5
    # the CNN, once refused, is ported (tests/test_torch_zoo.py holds it
    # to flax); a name the registry lacks still raises
    from climsim_tpu_torch.models import ClimSimCNN

    assert isinstance(build_model("cnn", SPEC, depth=1, channels=8),
                      ClimSimCNN)
    with pytest.raises(KeyError):
        build_model("gan", SPEC)
