"""5''s backward (``ops.unet_fused.fused_gn_silu_conv3_bwd``) on the CPU.

The CUDA kernel (``ops/csrc/fused_gn_silu_conv3_bwd.cu``) runs only on the
card; here its plain version, its tile plan and the arithmetic of its
three passes are checked:

* ``fused_gn_silu_conv3_bwd_plain`` against ``jax.vjp`` of
  ``climsim_tpu.ops.unet_fused.make_trainable_fused_block`` (the Pallas
  kernel in interpret mode, as tests/test_torch_unet_train.py runs it) at
  that file's BLOCK_SHAPES: float32 compute every gradient within rel-L2
  1e-5; bf16 within rel-L2 1e-2 and cosine 0.9999.
* The plain version against autograd of ``xla_gn_silu_conv3_plain(
  f32_accum=False)`` within PLAIN_TOL; the control without the bf16
  roundings of g, dxn and dw must fail it at bf16.
* ``plan_gn_silu_conv3_bwd`` at an H100's limits (232,448 bytes of shared
  memory a block, 132 SMs), after tests/test_torch_gn_plan.py: every shape
  kernel 5 plans gets a plan that fits at B = 1 to 4096, the grids cover
  every row and column once, a shape planned at B = 1 plans at every B,
  refusals give their reason, and ``check_kernel_shapes`` refuses a shape
  that only the backward refuses.
* An emulation of the passes' index arithmetic in float64 (the gb slab's
  rows a tap reads, the padded rows and the shifted boxes of wgrad, the
  split partials in order) against the plain version's float64 twin.
* On CPU tensors no kernel launch; the argument checks.

The readings of the bf16 comparisons are printed (``pytest -s``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops import unet_fused as JU
from climsim_tpu_torch.bench_gn_conv3 import (GN_RAGGED, GN_STEPPED,
                                              unet_v5_chains)
from climsim_tpu_torch.models.unet import _num_groups
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.ops import unet_fused as PU
from test_torch_unet_train import (BLOCK_SHAPES, DTYPES, _H100, _block_args,
                                   cosine, rel_l2)

GRADS = ("dx", "dgamma", "dbeta", "dw", "db")
# The plain version against autograd of the plain chain, rel-L2 a gradient.
# Both round g, dxn and dw to bf16 at the same places and differ in their
# float32 orders of summation (the closed form against autograd's graph,
# the taps' products against the convolution's): at BLOCK_SHAPES and
# PLAIN_SHAPES the largest reading was 1.8e-5 (dx, (8, 64, 32)), at float32
# compute 3.1e-7.  The control without the three roundings was 1.8e-3 to
# 2.9e-3 off at bf16, so it fails the bound.
PLAIN_TOL = 1e-4
PLAIN_SHAPES = [*BLOCK_SHAPES, (16, 256, 128), (8, 384, 64)]
CHAINS = unet_v5_chains()
# the fused chains of a unet_v5 at model_channels=256 (test_torch_gn_plan)
BIG = ((32, 256, 512), (32, 512, 512), (16, 512, 512), (8, 512, 512),
       (16, 1024, 512), (32, 1024, 512), (32, 768, 512), (64, 512, 512),
       (64, 768, 256), (64, 512, 256))
SHAPES = [*CHAINS, *GN_RAGGED, GN_STEPPED]
BATCHES = (1, 7, 16, 384, 1024, 4096)
LIMIT, N_SM = _H100.shared_memory_per_block_optin, _H100.multi_processor_count


def plan(b, l, c, cout):
    return PU.plan_gn_silu_conv3_bwd(b, l, c, cout, LIMIT, N_SM)


def _tensors(args):
    return [torch.from_numpy(a) for a in args]


# --------------------------------------------------------------------------
# the plain version
# --------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", BLOCK_SHAPES, ids=str)
def test_plain_backward_matches_the_jax_vjp(shape, dtype):
    jdt, tdt = DTYPES[dtype]
    l, c, cout = shape
    args = _block_args(l, c, cout, seed=3)
    jf = JU.make_trainable_fused_block(_num_groups(c), compute_dtype=jdt)
    _, vjp = jax.vjp(jf, *map(jnp.asarray, args[:5]))
    want = vjp(jnp.asarray(args[5]))
    got = PU.fused_gn_silu_conv3_bwd_plain(*_tensors(args), tdt)
    readings = []
    for name, x, w in zip(GRADS, got, want):
        assert x.dtype == torch.float32 and x.shape == w.shape, name
        r, cs = rel_l2(x, w), cosine(x, w)
        readings.append(f"{name} {r:.2e}/{cs:.7f}")
        if dtype == "f32":
            assert r <= 1e-5, (name, r)
        else:
            assert r <= 1e-2 and cs >= 0.9999, (name, r, cs)
    print(f"5' backward, plain against jax.vjp, {dtype} L={l} C={c} "
          f"Cout={cout}: rel-L2/cosine " + ", ".join(readings))


def _autograd(args, tdt):
    t = _tensors(args)
    ins = [a.clone().requires_grad_() for a in t[:5]]
    y = PU.xla_gn_silu_conv3_plain(*ins, tdt, f32_accum=False)
    return torch.autograd.grad(y, ins, t[5])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", PLAIN_SHAPES, ids=str)
def test_plain_backward_is_autograd_of_the_plain_chain(shape, dtype):
    tdt = DTYPES[dtype][1]
    args = _block_args(*shape, seed=4)
    want = _autograd(args, tdt)
    t = _tensors(args)
    got = PU.fused_gn_silu_conv3_bwd_plain(*t, tdt)
    ctl = PU.fused_gn_silu_conv3_bwd_plain(*t, tdt, rounded=False)
    gaps = [rel_l2(x, w) for x, w in zip(got, want)]
    ctl_gaps = [rel_l2(x, w) for x, w in zip(ctl, want)]
    print(f"5' backward, plain against autograd, {dtype} {shape}: "
          + " ".join(f"{n} {r:.2e}" for n, r in zip(GRADS, gaps))
          + "; control " + " ".join(f"{n} {r:.2e}"
                                    for n, r in zip(GRADS, ctl_gaps)))
    assert max(gaps) <= PLAIN_TOL, gaps
    if dtype == "bf16":
        # g's rounding reaches dx, dgamma, dbeta and dw; db sums g unrounded
        assert min(ctl_gaps[:4]) > PLAIN_TOL, ctl_gaps
        assert ctl_gaps[4] <= PLAIN_TOL


def test_the_twin_with_float64_sums_is_close():
    """The float64 twin rounds at the same places; at this size its
    distance to the plain version is a few float32 orders of rounding,
    far below the control's."""
    t = _tensors(_block_args(16, 128, 64, seed=5))
    got = PU.fused_gn_silu_conv3_bwd_plain(*t)
    twin = PU.fused_gn_silu_conv3_bwd_plain(*t, sum_dtype=torch.float64)
    for name, x, w in zip(GRADS, got, twin):
        assert x.dtype == torch.float32, name
        assert rel_l2(x, w) <= PLAIN_TOL, name


# --------------------------------------------------------------------------
# the public function on the CPU
# --------------------------------------------------------------------------
def test_the_cpu_takes_the_plain_version_and_launches_nothing():
    t = _tensors(_block_args(16, 128, 64, seed=6))
    w = t[3].to(torch.bfloat16)
    PK.reset_launches()
    got = PU.fused_gn_silu_conv3_bwd(*t[:3], w, *t[4:])
    want = PU.fused_gn_silu_conv3_bwd_plain(*t[:3], w, *t[4:])
    for x, y in zip(got, want):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    # the custom VJP's backward on the CPU stays autograd of the plain chain
    ins = [a.clone().requires_grad_() for a in t[:5]]
    y = PU.make_trainable_fused_block(32)(*ins)
    torch.autograd.grad(y, ins, t[5])
    assert PK.LAUNCHES["fused_gn_silu_conv3_bwd"] == 0
    assert PK.LAUNCHES["fused_gn_silu_conv3"] == 0


def test_an_empty_batch_gives_zero_parameter_gradients():
    t = _tensors(_block_args(8, 64, 32))
    t[0], t[5] = t[0][:0], t[5][:0]
    dx, dgamma, dbeta, dw, db = PU.fused_gn_silu_conv3_bwd_plain(*t)
    assert dx.shape == (0, 8, 64)
    for v in (dgamma, dbeta, dw, db):
        assert not v.any()


@pytest.mark.parametrize("case, error, match", [
    ("x float64", TypeError, "x: want torch.float32"),
    ("w float32", TypeError, "w: want torch.bfloat16"),
    ("w 2-D", ValueError, r"w: want \(3, 64, Cout\)"),
    ("w other C", ValueError, "w: want shape"),
    ("gamma short", ValueError, "gamma: want shape"),
    ("g other Cout", ValueError, "g: want shape"),
    ("g float64", TypeError, "g: want torch.float32"),
    ("b missing a column", ValueError, "b: want shape"),
], ids=str)
def test_the_arguments_are_checked(case, error, match):
    x, gamma, beta, w, b, g = _tensors(_block_args(8, 64, 32))
    w = w.to(torch.bfloat16)
    bad = {"x float64": dict(x=x.double()), "w float32": dict(w=w.float()),
           "w 2-D": dict(w=w[0]), "w other C": dict(w=w[:, :32]),
           "gamma short": dict(gamma=gamma[1:]),
           "g other Cout": dict(g=g[..., 1:]),
           "g float64": dict(g=g.double()),
           "b missing a column": dict(b=b[1:])}[case]
    kw = dict(x=x, gamma=gamma, beta=beta, w=w, b=b, g=g) | bad
    with pytest.raises(error, match=match):
        PU.fused_gn_silu_conv3_bwd(**kw)


# --------------------------------------------------------------------------
# the tile plan
# --------------------------------------------------------------------------
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_every_shape_gets_a_plan_that_fits(shape, b):
    l, c, cout = shape
    p = plan(b, l, c, cout)
    g = _num_groups(c)
    assert p.smem <= LIMIT and p.wsmem <= LIMIT
    assert p.smem == PU._bwd_smem(p.samples, l, c, cout, g, p.wgs * p.nb,
                                  p.stages)
    assert p.wsmem == PU._wgrad_smem(p.nbb, p.wstages)
    assert 2 <= p.stages <= PU.BWD_STAGES
    assert 2 <= p.wstages <= PU.WGRAD_STAGES
    assert 1 <= p.samples <= b and p.samples * l <= 64
    assert p.tiles_m == -(-b // p.samples)
    # the ring holds the GroupNorm backward's sums a (row, group) later
    assert p.stages * p.wgs * p.nb * 64 * 64 * 2 >= 64 * g * 8
    # two blocks an SM: one box a warpgroup, two stages, each block's
    # shared memory and the 1 KB the SM keeps a block within the SM's
    assert p.blocks in (1, 2)
    if p.blocks == 2:
        assert p.nb == 1 and p.stages == 2
        assert 2 * (p.smem + 1024) <= LIMIT + 1024
    # kernel 5's plan takes the shape too
    PU.plan_gn_silu_conv3(b, l, c, cout, LIMIT, N_SM)


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_the_grids_cover_every_row_and_column_once(shape, b):
    """dgrad: block t takes samples S t .. S t + S - 1 (those below B) and
    every channel box, a pass of wgs nb boxes at a time.  wgrad: block i
    takes split i // (tiles_c tiles_o), channel box and column tile from
    its remainder, and the split's chunks of the padded rows."""
    l, c, cout = shape
    p = plan(b, l, c, cout)
    rows = np.zeros(b, np.int32)
    for t in range(p.tiles_m):
        rows[t * p.samples:min((t + 1) * p.samples, b)] += 1
    assert (rows == 1).all()
    boxes = p.wgs * p.nb
    seen = [it * boxes + j for it in range(c // 64 // boxes)
            for j in range(boxes)]
    assert seen == list(range(c // 64))
    per = p.tiles_c * p.tiles_o
    cover = np.zeros((p.chunks, p.tiles_c, p.tiles_o), np.int32)
    for i in range(p.wgrad_grid):
        z, rem = divmod(i, per)
        tc, to = divmod(rem, p.tiles_o)
        q0, q1 = z * p.cps, min((z + 1) * p.cps, p.chunks)
        assert q0 < q1, i
        cover[q0:q1, tc, to] += 1
    assert (cover == 1).all()
    cols = np.zeros(cout, np.int32)
    for to in range(p.tiles_o):
        cols[to * 64 * p.nbb:(to + 1) * 64 * p.nbb] += 1
    assert (cols == 1).all() and p.tiles_c * 64 == c
    assert p.chunks * 64 >= b * (l + 2) > (p.chunks - 1) * 64


@pytest.mark.parametrize("shape", [*SHAPES, *BIG], ids=str)
def test_a_shape_planned_at_b1_plans_at_every_batch(shape):
    l, c, cout = shape
    plan(1, l, c, cout)
    for b in (7, 384, 1024, 6144):
        p = plan(b, l, c, cout)
        assert p.smem <= LIMIT and 1 <= p.samples * l <= 64


def test_short_grids_are_spread_over_the_sms():
    """An 8-level chain holds 8 samples a tile, and two blocks fit an SM
    (264 slots): at B = 384 (48 tiles) and B = 1024 (128) the plan takes
    4 samples a tile, as kernel 5's spreads its grid; at B = 4096 all 8.
    A ragged Cout (a branch around the k steps) keeps one block an SM."""
    for b, tiles in ((384, 96), (1024, 256)):
        p = plan(b, 8, 256, 256)
        assert (p.samples, p.tiles_m, p.blocks) == (4, tiles, 2)
    assert plan(4096, 8, 256, 256).samples == 8
    assert plan(1024, 15, 128, 80).blocks == 1


def test_the_wide_chain_steps_its_samples_down():
    """GN_STEPPED: eight samples of (8, 1024, 512) would need more shared
    memory than the card has; the plan takes fewer."""
    p = plan(1024, *GN_STEPPED)
    assert p.samples < 8
    assert PU._bwd_smem(8, 8, 1024, 512, 32, 2, 2) > LIMIT


@pytest.mark.parametrize("shape, reason", [
    ((64, 96, 64), "C a multiple of 64"),
    ((64, 192, 64), r"C / groups = 6"),
    ((65, 128, 128), "L <= 64"),
    ((64, 128, 40), "Cout a multiple of 16"),
    ((64, 1024, 1024), "shared memory"),
], ids=str)
def test_refused_shapes_give_the_reason(shape, reason):
    with pytest.raises(ValueError, match=reason):
        plan(16, *shape)


def test_check_kernel_shapes_refuses_what_only_the_backward_refuses(
        monkeypatch):
    """(64, 1024, 1024): kernel 5 plans it, the backward's gb slab and dxn
    do not fit; a trainer is refused before its first step."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _H100())
    PU.plan_gn_silu_conv3(16, 64, 1024, 1024, LIMIT, N_SM)
    with pytest.raises(ValueError, match="backward.*shared memory"):
        PU.check_kernel_shapes({(64, 1024, 1024): 1}, "cuda")
    PU.check_kernel_shapes(CHAINS, "cuda", batch=1024)
    PU.check_kernel_shapes(dict.fromkeys(BIG, 1), "cuda", batch=1024)


# --------------------------------------------------------------------------
# the passes' arithmetic, emulated
# --------------------------------------------------------------------------
def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(a).to(torch.bfloat16).double().numpy()


def emulate(x, gamma, beta, w, g, p):
    """float64 numpy emulation of the kernel's three passes, by its plan's
    tiles: (dx, dgamma, dbeta, dw, db)."""
    bsz, l, c = x.shape
    cout = w.shape[2]
    gr = _num_groups(c)
    xg = x.reshape(bsz, l, gr, -1)
    mean = xg.mean(axis=(1, 3), keepdims=True)
    rstd = 1 / np.sqrt(((xg - mean) ** 2).mean(axis=(1, 3), keepdims=True)
                       + PU.EPS)
    xh = ((xg - mean) * rstd).reshape(x.shape)
    a = xh * gamma + beta
    sig = 1 / (1 + np.exp(-a))
    xn, gb, wb = _bf16(a * sig), _bf16(g), _bf16(w)
    # pass 1: a tile's gb slab, sample s at rows s (L + 2) + 1 .., and the
    # row each output row reads at tap k: r + 2s + 2 - k
    dxn = np.zeros(x.shape)
    pv = np.zeros((p.tiles_m, 2 * c + cout))
    for t in range(p.tiles_m):
        sv = min(p.samples, bsz - t * p.samples)
        smp = slice(t * p.samples, t * p.samples + sv)
        slab = np.zeros((p.samples * (l + 2), cout))
        for s in range(sv):
            slab[s * (l + 2) + 1:s * (l + 2) + 1 + l] = gb[t * p.samples + s]
        r = np.arange(sv * l)
        base = r + 2 * (r // l) + 2
        acc = sum(slab[base - k] @ wb[k].T for k in range(3))
        dxn[smp] = _bf16(acc).reshape(sv, l, c)
        da = dxn[smp] * sig[smp] * (1 + a[smp] * (1 - sig[smp]))
        pv[t, :c] = (da * xh[smp]).sum(axis=(0, 1))
        pv[t, c:2 * c] = da.sum(axis=(0, 1))
        pv[t, 2 * c:] = g[smp].sum(axis=(0, 1))
    da = dxn * sig * (1 + a * (1 - sig))
    tt = (da * gamma).reshape(xg.shape)
    xhg = xh.reshape(xg.shape)
    dx = (rstd * (tt - tt.mean(axis=(1, 3), keepdims=True)
                  - xhg * (tt * xhg).mean(axis=(1, 3), keepdims=True)))
    # pass 2: the padded rows, a zero row past each edge of a sample; tap
    # k's box starts k - 1 rows on, zeros outside the matrix
    rows = bsz * (l + 2)
    xn_pad = np.zeros((p.chunks * 64 + 2, c))     # row i at i + 1
    gb_pad = np.zeros((p.chunks * 64, cout))
    for s in range(bsz):
        xn_pad[s * (l + 2) + 2:s * (l + 2) + 2 + l] = xn[s]
        gb_pad[s * (l + 2) + 1:s * (l + 2) + 1 + l] = gb[s]
    part = np.zeros((p.splits, 3, c, cout))
    for z in range(p.splits):
        for q in range(z * p.cps, min((z + 1) * p.cps, p.chunks)):
            p0 = q * 64
            for k in range(3):
                part[z, k] += (xn_pad[p0 + k:p0 + k + 64].T
                               @ gb_pad[p0:p0 + 64])
    assert not xn_pad[rows + 1:].any() and not gb_pad[rows:].any()
    # pass 3: the partials in order
    dw = _bf16(np.cumsum(part, axis=0)[-1])
    v = np.cumsum(pv, axis=0)[-1]
    return dx.reshape(x.shape), v[:c], v[c:2 * c], dw, v[2 * c:]


@pytest.mark.parametrize("b, shape", [
    (16, (8, 64, 32)), (7, (15, 128, 80)), (5, (60, 64, 48)),
    (16, (16, 256, 64)), (9, (8, 384, 48))], ids=str)
def test_the_passes_emulated_are_the_plain_version(b, shape):
    l, c, cout = shape
    rng = np.random.default_rng(7)
    x = rng.standard_normal((b, l, c)) + 0.5
    gamma = 1 + 0.2 * rng.standard_normal(c)
    beta = 0.1 * rng.standard_normal(c)
    lim = np.sqrt(6 / (3 * (c + cout)))
    w = rng.uniform(-lim, lim, (3, c, cout))
    g = rng.standard_normal((b, l, cout))
    p = plan(b, l, c, cout)
    got = emulate(x, gamma, beta, w, g, p)
    t = [torch.from_numpy(v) for v in (x, gamma, beta, w, np.zeros(cout), g)]
    want = PU.fused_gn_silu_conv3_bwd_plain(*t, sum_dtype=torch.float64)
    for name, u, v in zip(GRADS, got, want):
        assert u.shape == tuple(v.shape), name
        assert rel_l2(u, v) <= 1e-6, (name, rel_l2(u, v))
