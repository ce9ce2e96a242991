"""U-Net training in the port against the JAX package, on the CPU.

* ``ops.unet_fused.make_trainable_fused_block`` (kernel 5 under a custom
  VJP) against ``climsim_tpu.ops.unet_fused.make_trainable_fused_block``
  (the Pallas kernel in interpret mode): forward and ``jax.vjp`` with the
  same cotangent.  float32 compute: forward rtol 1e-5 / atol 1e-5 *
  max|y|, every gradient rel-L2 <= 1e-5.  bf16: forward 2e-2 * max|y|
  (tests/test_pallas_kernels.py:156-173), every gradient rel-L2 <= 1e-2
  and cosine >= 0.9999.
* ``ClimSimUNet(fused_gn_conv=True)`` at the widths of
  tests/test_fused_train.py:132-134, the weights moved across by
  ``port_flax_unet``: forward and every parameter gradient against the
  JAX fused model, rel-L2 <= 1e-4 at float32 compute; at bf16 the JAX
  test's own bound against its reference (rel < 0.15, forward < 5e-2 *
  max|y|).
* ``remat_blocks``, dropout and ``norm_dtype``; the energy and water
  losses (rtol 1e-6); ``classifier_labels`` (bit-equal); ``unet_trainer``
  and ``unet_classifier_trainer`` at tests/test_recipes_full.py's widths,
  float32 compute: the first loss rtol 1e-5, the parameters after one Adam
  step rtol 1e-4.

The readings of the bf16 comparisons are printed (``pytest -s``)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.data.synthetic import synthetic_split
from climsim_tpu.grid import load_default_grid
from climsim_tpu.models.unet import ClimSimUNet as FlaxUNet
from climsim_tpu.norms import compute_norms_from_data
from climsim_tpu.ops import unet_fused as JU
from climsim_tpu.train import losses as JL
from climsim_tpu.train import recipes as JR
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.models.unet import ClimSimUNet, GroupNorm, _dropout
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.ops import unet_fused as PU
from climsim_tpu_torch.ops import unet_infer as PI
from climsim_tpu_torch.train import losses as PL
from climsim_tpu_torch.train import recipes as PR
from climsim_tpu_torch.utils.migrate import port_flax_unet
from test_torch_unet import perturb

SPEC = get_varspec("v5")
GRID = load_default_grid()
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-30))


def cosine(got, want) -> float:
    a = np.asarray(got, np.float64).ravel()
    b = np.asarray(want, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-300))


# --------------------------------------------------------------------------
# 5': kernel 5 under a custom VJP
# --------------------------------------------------------------------------
# (L, C, Cout) at B = 16
BLOCK_SHAPES = [(8, 64, 32), (16, 128, 64), (16, 64, 64), (8, 128, 32)]


def _block_args(l, c, cout, seed=0):
    rng = np.random.default_rng(seed)
    lim = np.sqrt(6.0 / (3 * (c + cout)))
    return [a.astype(np.float32) for a in (
        rng.standard_normal((16, l, c)) + 0.5,
        1.0 + 0.2 * rng.standard_normal(c), 0.1 * rng.standard_normal(c),
        rng.uniform(-lim, lim, (3, c, cout)), 0.1 * rng.standard_normal(cout),
        rng.standard_normal((16, l, cout)))]


def _port_block(fn, args):
    """(y, the five gradients) of ``fn`` at ``args``' inputs and cotangent."""
    ins = [torch.from_numpy(a).requires_grad_() for a in args[:5]]
    y = fn(*ins)
    grads = torch.autograd.grad(y, ins, torch.from_numpy(args[5]))
    return y.detach(), grads


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_trainable_block_matches_jax(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    l, c, cout = shape
    groups = PU._num_groups(c)
    args = _block_args(l, c, cout)
    jf = JU.make_trainable_fused_block(groups, compute_dtype=jdt)
    want, vjp = jax.vjp(jf, *map(jnp.asarray, args[:5]))
    want_g = vjp(jnp.asarray(args[5]))
    PK.reset_launches()
    got, got_g = _port_block(
        PU.make_trainable_fused_block(groups, compute_dtype=tdt), args)
    assert PK.LAUNCHES["fused_gn_silu_conv3"] == 0    # CPU: plain version
    want = np.asarray(want)
    scale = np.abs(want).max()
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * scale)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2e-2 * scale)
    readings = []
    for name, g, w in zip(("dx", "dgamma", "dbeta", "dw", "db"), got_g,
                          want_g):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        r, cs = rel_l2(g, w), cosine(g, w)
        readings.append(f"{name} {r:.2e}/{cs:.7f}")
        if dtype == "f32":
            assert r <= 1e-5, (name, r)
        else:
            assert r <= 1e-2 and cs >= 0.9999, (name, r, cs)
    print(f"5' {dtype} L={l} C={c} Cout={cout}: forward "
          f"{np.abs(got.numpy() - want).max() / scale:.2e} of max|y|; "
          "rel-L2/cosine " + ", ".join(readings))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_trainable_block_backward_is_the_plain_chain(dtype):
    """The forward is the kernel's plain version on ``w`` rounded to the
    compute dtype; the backward is autograd of
    ``xla_gn_silu_conv3_plain(f32_accum=False)`` at the same inputs, bit
    for bit, and never the kernel."""
    tdt = DTYPES[dtype][1]
    args = _block_args(16, 128, 64, seed=1)
    y, grads = _port_block(
        PU.make_trainable_fused_block(32, compute_dtype=tdt), args)
    t = [torch.from_numpy(a) for a in args]
    torch.testing.assert_close(
        y, PU.fused_gn_silu_conv3(*t[:3], t[3].to(tdt), t[4]), rtol=0, atol=0)
    want_y, want = _port_block(
        lambda *a: PU.xla_gn_silu_conv3_plain(*a, tdt, f32_accum=False), args)
    for g, w in zip(grads, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    if dtype == "bf16":   # the rounded conv output: not the kernel's sums
        assert not torch.equal(want_y, y)


@pytest.mark.parametrize("f32_accum", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_chain_matches_the_xla_chain(dtype, f32_accum):
    """``xla_gn_silu_conv3_plain`` is ``xla_gn_silu_conv3`` (two-pass
    variance, the flax casting with ``f32_accum=False``)."""
    jdt, tdt = DTYPES[dtype]
    args = _block_args(16, 64, 32, seed=2)
    want = np.asarray(JU.xla_gn_silu_conv3(
        *map(jnp.asarray, args[:5]), groups=16, compute_dtype=jdt,
        f32_accum=f32_accum))
    got = PU.xla_gn_silu_conv3_plain(
        *map(torch.from_numpy, args[:5]), tdt, f32_accum).numpy()
    scale = np.abs(want).max()
    atol = (1e-5 if dtype == "f32" else 1e-2) * scale
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


def test_trainable_block_refuses_other_groups():
    args = [torch.from_numpy(a) for a in _block_args(8, 64, 32)[:5]]
    with pytest.raises(ValueError, match="groups"):
        PU.make_trainable_fused_block(8)(*args)


class _H100:
    shared_memory_per_block_optin = 232_448
    multi_processor_count = 132


def test_kernel_shapes_checked_before_the_first_step(monkeypatch):
    """Every fused chain of the unet_v5 training step fits the kernel on an
    H100; a chain it cannot take is refused when the trainer is built."""
    from climsim_tpu_torch.config import PRESETS

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: _H100())
    m = ClimSimUNet(SPEC, fused_gn_conv=True,
                    **PRESETS["unet_v5"].model_kw)
    chains = m.fused_chains(1024)
    assert sum(chains.values()) == 82
    assert {c for _, c, _ in chains} == {128, 256, 384, 512}
    PU.check_kernel_shapes(chains, "cuda")
    with pytest.raises(ValueError, match="C=96"):
        PU.check_kernel_shapes({(64, 96, 64): 1}, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        PU.check_kernel_shapes({(64, 2048, 64): 1}, "cuda")
    assert m.fused_chains(1000) == {}          # B % 16 != 0: nothing fused


# --------------------------------------------------------------------------
# the model's training features
# --------------------------------------------------------------------------
# tests/test_fused_train.py:132-134
FUSED_KW = dict(model_channels=16, channel_mult=(1, 2), num_blocks=1,
                attn_resolutions=(), seq_resolution=64, dropout=0.0)


def _fused_case(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((16, SPEC.input_len)).astype(np.float32)
    x[:, -1] = rng.integers(1, 385, 16)
    tgt = rng.standard_normal((16, SPEC.output_len)).astype(np.float32)
    params = FlaxUNet(spec=SPEC, fused_gn_conv=True, **FUSED_KW).init(
        jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    return x, tgt, perturb(jax.tree.map(np.asarray, params), seed=seed)


def _port_grads(model, x, tgt):
    """(y, {state name: gradient}) of mean((model(x) - tgt)^2)."""
    model.zero_grad(set_to_none=True)
    y = model(torch.from_numpy(x))
    ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
    return y.detach().numpy(), {k: p.grad.clone()
                                for k, p in model.named_parameters()}


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_fused_model_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, tgt, tree = _fused_case()
    fm = FlaxUNet(spec=SPEC, fused_gn_conv=True, compute_dtype=jdt,
                  **FUSED_KW)

    def loss(p):
        y = fm.apply({"params": p}, jnp.asarray(x))
        return jnp.mean((y - jnp.asarray(tgt)) ** 2), y

    (_, want), g_tree = jax.value_and_grad(loss, has_aux=True)(tree)
    m = ClimSimUNet(SPEC, fused_gn_conv=True, compute_dtype=tdt, **FUSED_KW)
    # the fused model's flax tree carries over unchanged
    m.load_state_dict(port_flax_unet(tree, m))
    PK.reset_launches()
    got, grads = _port_grads(m, x, tgt)
    assert PK.LAUNCHES["fused_gn_silu_conv3"] == 0
    want_g = port_flax_unet(jax.tree.map(np.asarray, g_tree), m)
    assert set(want_g) == set(grads)
    want = np.asarray(want)
    fwd = (rel_l2(got, want) if dtype == "f32"
           else np.abs(got - want).max() / np.abs(want).max())
    worst = max((rel_l2(grads[k], want_g[k]), k) for k in grads)
    print(f"fused model {dtype}: forward {fwd:.2e}, worst gradient rel-L2 "
          f"{worst[0]:.2e} ({worst[1]})")
    if dtype == "f32":
        assert fwd <= 1e-4 and worst[0] <= 1e-4, (fwd, worst)
    else:
        assert fwd < 5e-2 and worst[0] < 0.15, (fwd, worst)


def test_fused_model_takes_the_fused_chains(monkeypatch):
    """The chains JAX fuses (tests/test_fused_train.py widths) go through
    the fused block, at the shapes ``fused_chains`` reports; at B = 8 none
    does."""
    seen = []
    real = PU.make_trainable_fused_block

    def spy(*a, **k):
        f = real(*a, **k)

        def g(x, *rest):
            seen.append((x.shape[1], x.shape[2], rest[2].shape[2]))
            return f(x, *rest)
        return g

    monkeypatch.setattr(PU, "make_trainable_fused_block", spy)
    x, _, tree = _fused_case()
    m = ClimSimUNet(SPEC, fused_gn_conv=True, **FUSED_KW)
    m(torch.from_numpy(x))
    assert {s: seen.count(s) for s in set(seen)} == m.fused_chains(16)
    assert len(seen) == sum(m.fused_chains(16).values()) == 18
    seen.clear()
    m(torch.from_numpy(x[:8]))
    assert seen == [] and m.fused_chains(8) == {}


def test_flags_keep_the_parameter_tree():
    base = ClimSimUNet(SPEC, **FUSED_KW).state_dict()
    for kw in (dict(fused_gn_conv=True), dict(remat_blocks=True),
               dict(dropout=0.3), dict(norm_dtype=torch.bfloat16)):
        other = ClimSimUNet(SPEC, **dict(FUSED_KW, **kw)).state_dict()
        assert [(k, v.shape) for k, v in other.items()] == \
            [(k, v.shape) for k, v in base.items()], kw


@pytest.mark.parametrize("fused", [False, True])
def test_remat_gives_the_same_gradients(fused):
    """Bit for bit on the CPU, dropout masks included."""
    x, tgt, tree = _fused_case()
    out = []
    for remat in (False, True):
        m = ClimSimUNet(SPEC, **dict(FUSED_KW, dropout=0.2),
                        fused_gn_conv=fused, remat_blocks=remat)
        m.load_state_dict(port_flax_unet(tree, m))
        m.train()
        y = m(torch.from_numpy(x), seed=11)
        ((y - torch.from_numpy(tgt)) ** 2).mean().backward()
        out.append((y.detach(), [p.grad for p in m.parameters()]))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_dropout():
    x, _, tree = _fused_case()
    x = torch.from_numpy(x)

    def model(p):
        m = ClimSimUNet(SPEC, **dict(FUSED_KW, dropout=p))
        m.load_state_dict(port_flax_unet(tree, m))
        return m

    with torch.no_grad():
        ref = model(0.0).eval()(x)
        # dropout 0 in train() is the model without dropout
        assert torch.equal(model(0.0).train()(x, seed=1), ref)
        # dropout > 0 is the identity in eval()
        assert torch.equal(model(0.3).eval()(x), ref)
        # in train() it draws from the seed: the same seed, the same masks
        m = model(0.3).train()
        a, b, c = m(x, seed=5), m(x, seed=5), m(x, seed=6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert not torch.equal(a, ref)
    with pytest.raises(ValueError, match="seed"):
        m(x)
    h = torch.ones(64, 64, 128)
    d = _dropout(h, 0.3, 9)
    kept = d != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    assert torch.equal(d[kept], torch.full_like(d[kept], 1 / 0.7))


def test_group_norm_bf16_matches_flax():
    """norm_dtype=bfloat16: float32 statistics, the result stored in
    bf16, as flax's nn.GroupNorm(dtype=bfloat16)."""
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((6, 64, 128)) * 3 + 1).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(128)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(128)).astype(np.float32)
    want = fnn.GroupNorm(num_groups=32, epsilon=1e-6,
                         dtype=jnp.bfloat16).apply(
        {"params": {"scale": scale, "bias": bias}}, jnp.asarray(x))
    assert want.dtype == jnp.bfloat16
    gn = GroupNorm(128, dtype=torch.bfloat16)
    gn.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = gn(torch.from_numpy(x))
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    # both round float32 values to bf16; the float32 sums differ in order,
    # so a rounding may flip: one bf16 step (2**-8 to 2**-7 relative)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)
    assert np.mean(got.float().numpy() == want) > 0.99


def test_bf16_norm_model_matches_flax():
    x, _, tree = _fused_case()
    kw = dict(FUSED_KW, norm_dtype=jnp.bfloat16)
    want = np.asarray(FlaxUNet(spec=SPEC, **kw).apply({"params": tree},
                                                      jnp.asarray(x)))
    m = ClimSimUNet(SPEC, **dict(kw, norm_dtype=torch.bfloat16))
    m.load_state_dict(port_flax_unet(tree, m))
    with torch.no_grad():
        got = m.eval()(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    print(f"norm_dtype=bf16 model: forward {err:.2e} of max|y|")
    assert err <= 2e-2


def test_engine_refuses_bf16_norms_and_takes_the_training_flags():
    x, _, tree = _fused_case()
    m = ClimSimUNet(SPEC, **dict(FUSED_KW, norm_dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="norm_dtype"):
        PI.unet_apply_fused(m, torch.from_numpy(x))
    m = ClimSimUNet(SPEC, **dict(FUSED_KW, dropout=0.2), fused_gn_conv=True,
                    remat_blocks=True)
    m.load_state_dict(port_flax_unet(tree, m))
    with torch.inference_mode():
        y = PI.unet_apply_fused(m.eval(), torch.from_numpy(x))
    assert y.shape == (16, SPEC.output_len) and torch.isfinite(y).all()


# --------------------------------------------------------------------------
# losses and trainers
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def v5data():
    """tests/test_recipes_full.py's v5 split: 768 rows, icol 1..384."""
    x, y = synthetic_split(SPEC, n=2 * 384, grid=GRID, seed=1)
    x[:, SPEC.input_slices["icol"]] = np.tile(np.arange(1, 385), 2)[:, None]
    return x, y, compute_norms_from_data(SPEC, x, y, qn_transform=True)


def test_energy_and_water_losses_match_jax(v5data):
    """The batches of tests/test_recipes_full.py:206-216 (there the
    prediction is the target, and both penalties are 0), and an
    independent prediction."""
    _, _, stats = v5data
    yy = np.random.default_rng(0).normal(
        size=(8, SPEC.output_len)).astype(np.float32)
    pred = np.random.default_rng(3).normal(size=yy.shape).astype(np.float32)
    ps = np.random.default_rng(1).uniform(9e4, 1e5, 8).astype(np.float32)
    lh = np.random.default_rng(2).uniform(0, 200, 8).astype(np.float32)
    consts = [GRID.hyai, GRID.hybi, stats.out_scale]
    j = [jnp.asarray(a, jnp.float32) for a in consts]
    t = [torch.as_tensor(np.asarray(a), dtype=torch.float32) for a in consts]
    for p in (yy, pred):
        want_e = float(JL.energy_loss(jnp.asarray(p), jnp.asarray(yy),
                                      jnp.asarray(ps), *j, SPEC))
        want_w = float(JL.water_loss(jnp.asarray(p), jnp.asarray(yy),
                                     jnp.asarray(ps), jnp.asarray(lh), *j,
                                     SPEC))
        tp, ty = torch.from_numpy(p), torch.from_numpy(yy)
        got_e = float(PL.energy_loss(tp, ty, torch.from_numpy(ps), *t, SPEC))
        got_w = float(PL.water_loss(tp, ty, torch.from_numpy(ps),
                                    torch.from_numpy(lh), *t, SPEC))
        np.testing.assert_allclose(got_e, want_e, rtol=1e-6)
        np.testing.assert_allclose(got_w, want_w, rtol=1e-6)
    assert got_e > 0 and got_w > 0


def test_classifier_labels_bit_equal(v5data):
    x, y, _ = v5data
    rng = np.random.default_rng(5)
    # labels of every class: no tendency, evaporating, regular
    dq = y[:64, SPEC.output_slices["ptend_qn"]]
    dq[:, :20] = 0.0
    dq[:, 20:40] = -x[:64, SPEC.input_slices["state_qn"]][:, 20:40] / 1000.0
    dq[:, 40:] = np.abs(rng.normal(size=(64, 20))) * 1e-8
    y = y.copy()
    y[:64, SPEC.output_slices["ptend_qn"]] = dq
    want = np.asarray(JR.classifier_labels(x[:64], y[:64], SPEC))
    got = PR.classifier_labels(torch.from_numpy(x[:64]),
                               torch.from_numpy(y[:64]), SPEC).numpy()
    np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) == {0, 1, 2}


# tests/test_recipes_full.py:95-98 and :126-129
UNET_KW = dict(model_channels=8, channel_mult=(1,), num_blocks=1,
               attn_resolutions=(32,))
CLS_KW = dict(model_channels=8, channel_mult=(1,), num_blocks=1,
              attn_resolutions=())
TRAINER_CASES = {
    "plain": dict(model_kw=UNET_KW),
    "fused": dict(model_kw=dict(UNET_KW, fused_gn_conv=True)),
    "penalties": dict(model_kw=CLS_KW, energy_weight=1e-12,
                      water_weight=1e-6, grid=GRID),
}


def _jax_and_port(jax_recipe, port_recipe, data, model_kw, **kw):
    """The JAX and the port's trainer at float32 compute with the same
    (perturbed) weights."""
    x, y, stats = data
    jt = jax_recipe(SPEC, stats, (x, y), jax.random.PRNGKey(0),
                    model_kw=dict(model_kw, compute_dtype=jnp.float32), **kw)
    tree = perturb(jax.tree.map(np.asarray, jt.state.params["params"]))
    jt.state = jt.state.replace(params={"params": jax.tree.map(
        jnp.asarray, tree)})
    pt = port_recipe(SPEC, stats, (x, y), 0, model_kw=model_kw,
                     compute_dtype=torch.float32, device="cpu", **kw)
    pt.model.load_state_dict(port_flax_unet(tree, pt.model))
    return jt, pt


def _one_step_matches(jt, pt, xb, yb, aux=()):
    js, jm = jt.train_step(jt.state, jnp.asarray(xb), jnp.asarray(yb))
    ps, pm = pt.train_step(pt.state, torch.from_numpy(xb),
                           torch.from_numpy(yb))
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    for k in aux:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), rtol=1e-5)
    want = port_flax_unet(jax.tree.map(np.asarray, js.params["params"]),
                          pt.model)
    for k, v in pt.model.state_dict().items():
        v, w = v.numpy(), want[k].numpy()
        if k.endswith("qkv.bias"):
            # the key bias has no gradient in exact arithmetic (the softmax
            # is shift-invariant), so Adam's first step normalizes rounding
            # noise there: it only has to stay within one step (lr 1e-3)
            c = v.shape[0] // 3
            np.testing.assert_allclose(v[c:2 * c], w[c:2 * c], rtol=0,
                                       atol=2e-3, err_msg=k)
            v, w = np.delete(v, np.s_[c:2 * c]), np.delete(w, np.s_[c:2 * c])
        np.testing.assert_allclose(v, w, rtol=1e-4, atol=1e-7, err_msg=k)
    assert ps.step == 1


@pytest.mark.parametrize("case", sorted(TRAINER_CASES))
def test_unet_trainer_matches_jax(v5data, case):
    kw = dict(TRAINER_CASES[case])
    jt, pt = _jax_and_port(JR.unet_trainer, PR.unet_trainer, v5data,
                           steps_per_epoch=4, **kw)
    x, y, _ = v5data
    aux = [k for k in ("energy_loss", "water_loss")
           if kw.get(k.split("_")[0] + "_weight")]
    _one_step_matches(jt, pt, x[:32], y[:32], aux)
    preds = pt.predict(pt.model, x[:40], 16)
    assert preds.shape == (40, SPEC.output_len)
    assert not pt.model.training


def test_unet_classifier_trainer_matches_jax(v5data):
    jt, pt = _jax_and_port(JR.unet_classifier_trainer,
                           PR.unet_classifier_trainer, v5data, CLS_KW)
    x, y, _ = v5data
    xb, yb = x[:32], y[:32]
    jm = jt.eval_step(jt.state.params, jnp.asarray(xb), jnp.asarray(yb))
    pm = pt.eval_step(pt.model, torch.from_numpy(xb), torch.from_numpy(yb))
    np.testing.assert_allclose(float(pm["accuracy"]),
                               float(jm["accuracy"]), rtol=1e-6)
    _one_step_matches(jt, pt, xb, yb, ("accuracy",))
    probs = pt.predict(pt.model, x[:8])
    assert probs.shape == (8, 60, 3)
    np.testing.assert_allclose(probs.sum(axis=-1), 1.0, rtol=1e-5)


def test_stochastic_loss_path(v5data):
    """dropout > 0: the training step runs the model in train() mode with
    masks from the state's generator, which advances once a step; the
    same seed gives the same steps bit for bit; eval runs in eval()."""
    x, y, stats = v5data
    xb, yb = torch.from_numpy(x[:32]), torch.from_numpy(y[:32])

    def run(rng):
        tr = PR.unet_trainer(SPEC, stats, None, rng, steps_per_epoch=4,
                             model_kw=dict(UNET_KW, dropout=0.3),
                             device="cpu")
        modes, real = [], tr.model.forward

        def forward(*a, **k):
            modes.append(tr.model.training)
            return real(*a, **k)

        tr.model.forward = forward
        st, losses = tr.state, []
        for _ in range(2):
            st, m = tr.train_step(st, xb, yb)
            losses.append(m["loss"])
        ev = tr.eval_step(tr.model, xb, yb)["loss"]
        return tr, losses, ev, modes

    a, la, ea, modes = run(4)
    b, lb, eb, _ = run(4)
    c, lc, _, _ = run(5)
    assert modes == [True, True, False]
    assert all(torch.equal(p, q) for p, q in zip(la, lb)) and torch.equal(
        ea, eb)
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
    assert not torch.equal(la[1], lc[1])
    # two steps drew two seeds: the generator moved on each step
    g = torch.Generator().manual_seed(a.state.rng.initial_seed())
    for _ in range(2):
        torch.randint(2**62, (), generator=g)
    assert torch.equal(g.get_state(), a.state.rng.get_state())


def test_bench_unet_train_setup(monkeypatch, capsys):
    """The benchmark's pool, arms and operation count on the CPU; without
    a card it exits non-zero and prints no result."""
    import json

    from climsim_tpu_torch import bench_unet_train as BU

    x, y = BU.pool(768)
    np.testing.assert_array_equal(x[:, SPEC.input_slices["icol"]][:, 0],
                                  np.arange(768) % 384 + 1)
    assert y.shape == (768, SPEC.output_len)
    assert BU.model_kw("fused")["fused_gn_conv"]
    assert BU.model_kw("remat+bf16norm")["norm_dtype"] == torch.bfloat16
    assert BU.main(["--flops"]) == 0
    flops = json.loads(capsys.readouterr().out)["forward_flop_per_sample"]
    assert flops["total"] == 896_073_728 == sum(flops["by_op"].values())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert BU.main(["--arms", "plain"]) == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit):
        BU.main(["--arms", "xla"])
