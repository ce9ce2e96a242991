"""Kernels 2 and 3's tensor-core kernel on the CPU: its plan
(``ops.kernels.plan_mlp_forward``), the pack's device layout, and the
three-part split of kernel 2's float32 activations.

The CUDA kernel runs only on the card; what surrounds it is Python and is
checked here against an H100's numbers (232,448 bytes of shared memory a
block, 132 SMs, clusters of 16): every plan fits and covers every row and
every output column, widths up to 2048 plan at every batch, and refusals
give their reason, at the latest when a server packs its weights.  The
device layout holds the weights with zeros around them, and the plain
versions read on it give the reference's result bit for bit, which
matches the Pallas kernels (interpret mode).  ``split_bf16x3`` is the
arithmetic kernel 2 runs on the tensor cores: three bf16 parts whose
products sum to the float32 product.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops import kernels as JK
from climsim_tpu_torch.ops import kernels as K

LIMIT, N_SM = 232_448, 132
V2RH = (557, 1024, 1024, 1024, 1024, 368)
RAGGED = (557, 97, 64, 30, 368)
WIDE = (557, 1536, 1536, 1536, 1536, 368)    # past what 8 CTAs cover
BATCHES = (1, 7, 50, 384, 6144)


def plan(b, widths, int8=False, max_cluster=16, limit=LIMIT):
    return K.plan_mlp_forward(b, widths, limit, N_SM, max_cluster, int8)


def net(widths, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.standard_normal(o)).astype(np.float32)
          for o in widths[1:]]
    return ws, bs


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("widths", [V2RH, RAGGED, WIDE],
                         ids=["v2rh", "ragged", "wide"])
def test_every_plan_fits(widths, b, int8):
    p = plan(b, widths, int8)
    assert p.smem == K._mlp_smem(int8, p.nwg, p.nb, p.stages) <= LIMIT
    assert 2 <= p.stages <= K.MLP_STAGES
    assert p.cluster in K.MLP_CLUSTERS and 1 <= p.nb <= K.MLP_MAX_NB
    assert p.nwg in (1, 2) and p.rows == 64 * p.nwg
    assert p.grid == p.tiles_m * p.cluster <= 2**31 - 1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("widths", [V2RH, RAGGED, WIDE],
                         ids=["v2rh", "ragged", "wide"])
def test_the_grid_covers_every_row_and_column_once(widths, b, int8):
    """Cluster i takes rows p.rows i .. (those below B), one cluster a row
    tile; in every layer, x included, the cluster's CTAs own the CHUNK-
    column chunks round robin, at most nb each, so nb chunks a CTA cover
    every layer, and the widest needs them all (no CTA idles a chunk)."""
    p = plan(b, widths, int8)
    assert p.tiles_m * p.rows >= b > (p.tiles_m - 1) * p.rows
    chunks = [-(-w // K.CHUNK) for w in widths]
    assert max(chunks) <= p.nb * p.cluster
    assert max(chunks) > (p.nb - 1) * p.cluster


def test_the_plan_follows_the_sweep():
    """Clusters of 16 over 64-row tiles while the tiles fit in one wave of
    them (132 // 16 = 8 clusters: B <= 512), then clusters of 8 over
    128-row tiles; a card that schedules no cluster of 16 gets 8."""
    for b, want in ((1, (16, 1, 1)), (384, (16, 1, 1)), (512, (16, 1, 1)),
                    (513, (8, 2, 2)), (6144, (8, 2, 2))):
        p = plan(b, V2RH)
        assert (p.cluster, p.nwg, p.nb) == want, b
    assert plan(384, V2RH, max_cluster=8).cluster == 8
    assert plan(64, V2RH, max_cluster=8).nwg == 1


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("hidden", [1088, 1536, 2048])
def test_widths_past_1024_keep_clusters_of_16_at_every_batch(hidden, int8):
    """8 CTAs of two chunks cover 1024 columns; past that, where the plan
    would take clusters of 8 (past one wave of 64-row tiles), it keeps
    clusters of 16 over 128-row tiles instead, so a width up to 2048 that
    plans at one row plans at every batch (a server pads requests up to
    6144 rows).  A card that schedules no cluster of 16 refuses them."""
    widths = (557, hidden, hidden, hidden, hidden, 368)
    for b, want in ((1, (16, 1)), (384, (16, 1)), (512, (16, 1)),
                    (513, (16, 2)), (1536, (16, 2)), (6144, (16, 2))):
        p = plan(b, widths, int8)
        assert (p.cluster, p.nwg, p.nb) == want + (2,), b
        assert p.smem <= LIMIT and p.stages >= 2
    with pytest.raises(ValueError, match="widths up to 1024"):
        plan(1, widths, int8, max_cluster=8)


@pytest.mark.parametrize("kw, reason", [
    (dict(widths=V2RH, max_cluster=4), "no cluster of 8"),
    (dict(widths=(557, 2112, 368)), "widths up to 2048"),
    (dict(widths=(557, 2112, 368), b=6144), "widths up to 2048"),
    (dict(widths=(557, 1024, 368), limit=48 * 1024), "shared memory"),
    (dict(widths=(8,) * 18), "1..16 layers"),
    (dict(widths=(557, 0, 368)), "positive widths"),
    (dict(widths=V2RH, b=0), "rows 0"),
], ids=str)
def test_refused_calls_give_the_reason(kw, reason):
    kw = dict(kw)
    b = kw.pop("b", 384)
    with pytest.raises(ValueError, match=reason):
        plan(b, **kw)


def test_the_device_plan_falls_back_to_clusters_of_8(monkeypatch):
    """On the card the largest cluster the card schedules for the plan is
    asked of it (cudaOccupancyMaxActiveClusters), never found by a failed
    launch: where a cluster of 16 does not schedule, the plan takes 8."""
    class _H100:
        shared_memory_per_block_optin = LIMIT
        multi_processor_count = N_SM

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _H100())
    asked = []

    def active(dev, int8, p):
        asked.append(p.cluster)
        return 0 if p.cluster == 16 else 7

    monkeypatch.setattr(K, "_active_clusters", active)
    mlp = K.pack_mlp(*net(RAGGED, 0), torch.bfloat16, device="cpu")
    p = K._mlp_plan(384, mlp, torch.device("cuda"))
    assert p.cluster == 8 and asked == [16, 8]
    monkeypatch.setattr(K, "_active_clusters", lambda dev, int8, p: 0)
    with pytest.raises(ValueError, match="schedules no cluster"):
        K._mlp_plan(384, mlp, torch.device("cuda"))


def _h100(monkeypatch, active):
    """torch.cuda's device properties an H100's, and ``active(plan)`` the
    clusters of ``plan`` the card holds at once."""
    class _H100:
        shared_memory_per_block_optin = LIMIT
        multi_processor_count = N_SM

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _H100())
    monkeypatch.setattr(K, "_active_clusters",
                        lambda dev, int8, p: active(p))


@pytest.mark.parametrize("dt", [torch.bfloat16, "int8"], ids=["bf16", "int8"])
def test_a_server_checks_the_plan_when_it_packs(monkeypatch, dt):
    """``check_mlp_forward`` plans on the card at every batch it is given
    and raises with the plan's reason: widths past 2048 at any batch, and
    past 1024 where no cluster of 16 schedules.  On the CPU, and for
    float32 weights (the FMA kernel), there is nothing to check."""
    _h100(monkeypatch, lambda p: 7)
    cuda = torch.device("cuda")
    for widths in (V2RH, WIDE, RAGGED):
        mlp = K.pack_mlp(*net(widths, 0), dt, device="cpu")
        K.check_mlp_forward(mlp, cuda, (1, 6144))
    too_wide = K.pack_mlp(*net((557, 2112, 368), 0), dt, device="cpu")
    with pytest.raises(ValueError, match="widths up to 2048"):
        K.check_mlp_forward(too_wide, cuda, (1, 6144))
    K.check_mlp_forward(too_wide, "cpu", (1, 6144))
    K.check_mlp_forward(K.pack_mlp(*net((557, 2112, 368), 0), torch.float32,
                                   device="cpu"), cuda, (1, 6144))
    _h100(monkeypatch, lambda p: 0 if p.cluster == 16 else 7)
    wide = K.pack_mlp(*net(WIDE, 0), dt, device="cpu")
    with pytest.raises(ValueError, match="widths up to 1024"):
        K.check_mlp_forward(wide, cuda, (1,))


def test_the_fast_wrapper_checks_the_plan_at_one_row_and_max_batch(
        monkeypatch):
    from climsim_tpu_torch.models import build_model
    from climsim_tpu_torch.norms import load_asset_norms
    from climsim_tpu_torch.online import wrapper as PW
    from climsim_tpu_torch.varspec import get_varspec

    asked = []
    monkeypatch.setattr(K, "check_mlp_forward",
                        lambda mlp, dev, batches: asked.append(
                            (mlp.widths, str(dev), tuple(batches))))
    spec = get_varspec("v2_rh")
    model = build_model("mlp_online", spec, hidden=(64, 64),
                        generator=torch.Generator().manual_seed(0))
    PW.make_fast_mlp_wrapper(model, load_asset_norms("v2_rh"), spec,
                             "int8", device="cpu", max_batch=3072)
    assert asked == [((557, 64, 64, 368), "cpu", (1, 3072))]


@pytest.mark.parametrize("dt", [torch.bfloat16, "int8"], ids=["bf16", "int8"])
@pytest.mark.parametrize("widths", [V2RH, RAGGED], ids=["v2rh", "ragged"])
def test_the_device_layout_is_the_weights_with_zeros_around(widths, dt):
    """bf16 and int8 packs hold one store, the kernel's: every layer's
    weights at (sum of the padded widths before it, 0), biases and scales
    at the padded widths before it, zero everywhere else; ``layers()``
    yields the unpadded views of it."""
    ws, bs = net(widths, 3)
    mlp = K.pack_mlp(ws, bs, dt, device="cpu")
    kp = [-(-w // K.CHUNK) * K.CHUNK for w in widths]
    assert mlp.padded
    assert mlp.w.shape == (sum(kp[:-1]), max(kp[1:]))
    assert mlp.b.shape == (sum(kp[1:]),)
    assert (mlp.scale is None) == (dt != "int8")
    if dt == "int8":
        qs, scales = K.quantize_weights_int8(ws)
    else:
        qs, scales = [torch.from_numpy(w).to(dt) for w in ws], None
    seen_w = torch.zeros(mlp.w.shape, dtype=torch.bool)
    seen_b = torch.zeros(mlp.b.shape, dtype=torch.bool)
    ro = bo = 0
    for i, (w, b, s) in enumerate(mlp.layers()):
        din, dout = widths[i], widths[i + 1]
        assert w.shape == (din, dout) and w.dtype == mlp.w.dtype
        assert w.data_ptr() == mlp.w[ro:, :].data_ptr()     # a view
        assert torch.equal(w, qs[i])
        assert torch.equal(b, torch.from_numpy(bs[i]))
        assert torch.equal(mlp.b[bo:bo + dout], b)
        if scales is not None:
            assert torch.equal(s, scales[i])
            assert torch.equal(mlp.scale[bo:bo + dout], s)
        seen_w[ro:ro + din, :dout] = True
        seen_b[bo:bo + dout] = True
        ro, bo = ro + kp[i], bo + kp[i + 1]
    assert (mlp.w[~seen_w] == 0).all() and (mlp.b[~seen_b] == 0).all()
    if mlp.scale is not None:
        assert (mlp.scale[~seen_b] == 0).all()
    # a pack of another's layers is the same store
    again = K.pack_layers(mlp.layers())
    assert again.widths == mlp.widths and torch.equal(again.w, mlp.w)
    assert torch.equal(again.b, mlp.b)


def test_float32_packs_have_no_device_layout():
    """float32 weights keep the FMA kernel's layout: every layer row-major,
    concatenated, unpadded."""
    widths = RAGGED
    ws, bs = net(widths, 4)
    mlp = K.pack_mlp(ws, bs, torch.float32, device="cpu")
    assert not mlp.padded and mlp.scale is None
    assert torch.equal(mlp.w, torch.from_numpy(
        np.concatenate([w.reshape(-1) for w in ws])))
    assert torch.equal(mlp.b, torch.from_numpy(np.concatenate(bs)))
    with pytest.raises(ValueError, match="do not match widths"):
        K.PackedMLP(widths, torch.zeros(mlp.w.numel(), dtype=torch.bfloat16),
                    mlp.b)


@pytest.mark.parametrize("b", [1, 7, 50])
@pytest.mark.parametrize("dt", [torch.bfloat16, "int8"], ids=["bf16", "int8"])
def test_plain_on_the_padded_pack_is_bit_equal_and_matches_pallas(dt, b):
    """The plain version read on the padded pack gives, bit for bit, the
    chain of float32 products of the rounded (bf16) or quantized (int8)
    weights, read from the weights themselves, and that matches the Pallas
    kernel in interpret mode at the tolerance of
    tests/test_torch_kernels.py (rtol 2e-4, atol 1e-4)."""
    widths = (557, 96, 64, 368)
    ws, bs = net(widths, 11)
    x = np.random.default_rng(b).standard_normal(
        (b, widths[0])).astype(np.float32)
    x[0, 3] = np.inf
    mlp = K.pack_mlp(ws, bs, dt, device="cpu")
    xt = torch.from_numpy(x)
    h = xt
    if dt == "int8":
        fn, fj = K.fused_mlp_forward_int8_plain, JK.fused_mlp_forward_int8
        qs, scales = JK.quantize_weights_int8(ws)
        pallas = np.asarray(fj(jnp.asarray(x), qs, scales, bs, relu_tail=8,
                               tile_b=64))
        for i, (q, s, bi) in enumerate(zip(qs, scales, bs)):
            h = (h.to(torch.bfloat16).float()
                 @ torch.from_numpy(np.asarray(q, np.float32))) \
                * torch.from_numpy(np.asarray(s)) + torch.from_numpy(bi)
            h = torch.relu(h) if i < len(ws) - 1 else h
    else:
        fn = K.fused_mlp_forward_plain
        pallas = np.asarray(JK.fused_mlp_forward(
            jnp.asarray(x), [jnp.asarray(w).astype(jnp.bfloat16) for w in ws],
            bs, relu_tail=8, tile_b=64))
        for i, (w, bi) in enumerate(zip(ws, bs)):
            h = h @ torch.from_numpy(w).to(dt).float() + torch.from_numpy(bi)
            h = torch.relu(h) if i < len(ws) - 1 else h
    want = torch.cat([h[:, :-8], torch.relu(h[:, -8:])], dim=1)
    got = fn(xt, mlp, 8)
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=2e-4, atol=1e-4)


def _split_sum(h):
    hi, mid, lo = K.split_bf16x3(h)
    assert hi.dtype == mid.dtype == lo.dtype == torch.bfloat16
    return hi, mid, lo, hi.float() + mid.float() + lo.float()


def test_split_is_exact_for_finite_float32():
    """hi + mid + lo == h exactly for every finite h of magnitude >= 2**-110
    (the float32 range down to there, signed zeros, the largest finite
    value), and within 2**-133 (bf16's subnormal spacing) below it, float32
    subnormals included."""
    rng = np.random.default_rng(0)
    normal = np.ldexp(rng.uniform(1.0, 2.0, 20000),
                      rng.integers(-110, 127, 20000))
    special = [0.0, -0.0, np.finfo(np.float32).max,
               -np.finfo(np.float32).max, 2.0**-110, np.finfo(np.float32).tiny]
    h = torch.from_numpy(np.concatenate([
        normal * rng.choice([-1.0, 1.0], normal.size), special])
        .astype(np.float32))
    assert (h.abs() >= 2.0**-110).sum() == h.numel() - 3
    hi, mid, lo, s = _split_sum(h)
    big = h.abs() >= 2.0**-110
    assert torch.equal(s[big], h[big])
    assert float(s[-6]) == 0.0 and float(s[-5]) == 0.0
    tiny = torch.tensor([1e-45, 3e-40, 1e-38, 2.0**-133, 2.0**-140,
                         -5e-39, 2.0**-115], dtype=torch.float32)
    _, _, _, st = _split_sum(tiny)
    assert float((st - tiny).abs().max()) <= 2.0**-133
    assert torch.equal(_split_sum(torch.tensor([2.0**-133]))[3],
                       torch.tensor([2.0**-133]))


def test_split_of_nonfinite_values_keeps_float32s_products():
    """NaN and +-inf go whole into hi, with mid = lo = 0, so the three
    products sum to float32's inf * w and NaN (inf - inf would have given
    NaN for inf)."""
    h = torch.tensor([float("nan"), float("inf"), -float("inf")])
    hi, mid, lo, _ = _split_sum(h)
    assert torch.isnan(hi[0]) and hi[1] == float("inf") and \
        hi[2] == -float("inf")
    assert (mid == 0).all() and (lo == 0).all()
    w = torch.tensor([0.5, -3.0, 2.0], dtype=torch.bfloat16).float()
    for wi in w:
        got = (hi.float() * wi + mid.float() * wi) + lo.float() * wi
        want = h * wi
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(got[~torch.isnan(got)], want[~torch.isnan(want)])


def test_three_bf16_passes_give_the_float32_product():
    """One layer as kernel 2 runs it: three bf16 x bf16 products (hi, mid,
    lo) summed in float32 against the exact (float64) product of the same
    float32 activations and bf16 weights.  Tolerance: 1e-6 of sum |h| |w|,
    a float32 dot's own summation error (float32's own product is within
    it); two passes are some 25 times further, and one bf16 pass, the
    change of numerics the split avoids, thousands of times."""
    rng = np.random.default_rng(0)
    h = torch.from_numpy((rng.standard_normal((64, 557)) * np.exp(
        rng.uniform(-5, 5, (64, 557)))).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((557, 96)) / np.sqrt(557))
                         .astype(np.float32)).to(torch.bfloat16).float()
    exact = h.double() @ w.double()
    scale = h.double().abs() @ w.double().abs()

    def err(y):
        return float(((y.double() - exact).abs() / scale).max())

    hi, mid, lo = (p.float() for p in K.split_bf16x3(h))
    three = (hi @ w + mid @ w) + lo @ w
    assert err(three) <= 1e-6
    assert err(h @ w) <= 1e-6
    assert err(hi @ w + mid @ w) > 1e-6
    assert err(h.to(torch.bfloat16).float() @ w) > 1e-3
    assert err(hi @ w) > 1e-3
