"""Kernel 6's plan and arithmetic on the CPU (``ops.fused_mlp_train``).

The CUDA kernels run only on the card; what surrounds them is Python and
is checked here against an H100's numbers (232,448 bytes of shared memory
a block, 132 SMs): every plan fits, its tiles cover every product, the
dW products' split-K chunks are whole multiples of ``tile_b`` that cover
the batch once in ascending order, and the scratch the wrapper allocates
is the plan's.  A plain emulation of the kernels' arithmetic (the padded
bf16 pack, the RN-bf16 saves, the mask read back from them, split-K in the
plan's chunk order, db from per-tile sums in the kernel's order) is held
against the Pallas custom VJP in interpret mode within the tolerances of
tests/test_torch_fused_train.py (forward rtol 1e-5 / atol 1e-6; dW and db
rel-L2 <= 1e-5).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu.ops.fused_mlp_train import make_fused_mlp_train as jax_fused
from climsim_tpu_torch import bench_mlp_train as BM
from climsim_tpu_torch.ops import fused_mlp_train as FT
from climsim_tpu_torch.ops import kernels as K

LIMIT, N_SM = 232_448, 132
V1 = (124, 768, 640, 512, 640, 640, 128)
V2RH = (557, 1024, 1024, 1024, 1024, 368)
RAGGED = (124, 130, 128, 10)
NETS = {"v1": V1, "v2rh": V2RH, "ragged": RAGGED}
BATCHES = (1, 7, 384, 32768, 65536)
TILE_B = (128, 512)


def plan(widths, b, tile_b=128, **kw):
    """The planner's plan; ``kw`` (dw_bn, dh_bn, chunks) replans it as
    ``bench_mlp_train --sweep`` does."""
    p = FT.plan_mlp_train(widths, b, tile_b, LIMIT, N_SM)
    return BM.replan(p, LIMIT, **kw) if kw else p


def padded(w):
    return -(-w // 64) * 64


@pytest.mark.parametrize("tile_b", TILE_B)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("net", NETS)
def test_every_plan_fits(net, b, tile_b):
    widths = NETS[net]
    p = plan(widths, b, tile_b)
    assert p.forward == K.plan_mlp_forward(b, widths, LIMIT, N_SM, 16)
    assert p.forward.smem <= LIMIT
    tiles = [t for t in p.dw + p.dh if t is not None]
    assert len(p.dw) == len(p.dh) == len(widths) - 1 and p.dh[0] is None
    for t in tiles:
        assert t.bn in FT.GEMM_BN and 2 <= t.stages <= FT.GEMM_MAX_STAGES
        assert t.smem == FT._gemm_smem(t.bn, t.stages) <= LIMIT
    # at the default widths (dW 256 columns, dh 64): a dW block takes an
    # SM and the most stages; two dh blocks share one
    assert all(t.bn == 256 and t.stages == 4 for t in p.dw)
    assert all(t.bn == 64 and K._ctas_an_sm(t.smem, LIMIT) == 2
               for t in p.dh[1:])
    args = list(p.args())
    assert len(args) == FT.PLAN_HEAD + FT.PLAN_LAYER * (len(widths) - 1)


@pytest.mark.parametrize("tile_b", TILE_B)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("net", NETS)
def test_tiles_cover_every_product(net, b, tile_b):
    """dW_l: 128 x bn tiles over (d_l, d_{l+1}); dh_{l-1}: 128-row tiles
    over the batch and bn-column tiles over d_l padded to 64, which the
    dh buffer holds; no grid dimension past the card's limits."""
    widths = NETS[net]
    p = plan(widths, b, tile_b)
    for l, (dw, dh) in enumerate(zip(p.dw, p.dh)):
        tm = -(-widths[l] // FT.GEMM_BM)
        tn = -(-widths[l + 1] // dw.bn)
        assert tm * FT.GEMM_BM >= widths[l] > (tm - 1) * FT.GEMM_BM
        assert tn * dw.bn >= widths[l + 1] > (tn - 1) * dw.bn
        assert tm * tn * dw.chunks <= 2**31 - 1 and dw.chunks <= 65535
        if l:
            rows = -(-b // FT.GEMM_BM)
            assert rows * FT.GEMM_BM >= b > (rows - 1) * FT.GEMM_BM
            assert rows <= 65535
            assert -(-padded(widths[l]) // dh.bn) * dh.bn >= padded(widths[l])


@pytest.mark.parametrize("tile_b", TILE_B)
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("net", NETS)
def test_split_k_chunks(net, b, tile_b):
    """Whole multiples of tile_b (and of the GEMM's 64-row steps), the last
    ending at B, ascending, covering the batch once; as many as fill the
    SMs once, never more than the multiples there are."""
    widths = NETS[net]
    p = plan(widths, b, tile_b)
    unit = math.lcm(tile_b, FT.GEMM_BK)
    for l, dw in enumerate(p.dw):
        assert dw.rows % tile_b == 0 and dw.rows % FT.GEMM_BK == 0
        bounds = p.chunk_bounds(l)
        assert len(bounds) == dw.chunks == -(-b // dw.rows)
        assert bounds[0][0] == 0 and bounds[-1][1] == b
        for (s0, e0), (s1, _) in zip(bounds, bounds[1:]):
            assert e0 == s1 and (e0 - s0) % tile_b == 0
        tiles = -(-widths[l] // 128) * -(-widths[l + 1] // dw.bn)
        per_sm = FT._gemm_blocks(True, dw.bn)
        assert dw.chunks <= max(1, per_sm * N_SM // tiles)
        assert dw.chunks <= -(-b // unit)


@pytest.mark.parametrize("b", (1, 7, 384, 32768))
@pytest.mark.parametrize("net", NETS)
def test_scratch_is_the_plans(net, b):
    """What the wrapper allocates (``_scratch``) is what the plan sizes,
    and the sizes are the ones the kernels write: kernel 2's activation
    chunks, each hidden h at its padded width, x at its padded width, the
    widest dh twice, and every chunk's dW partial and every row tile's db
    sums."""
    widths = NETS[net]
    p = plan(widths, b)
    act, save, xb, dh0, dh1, partial = FT._scratch(p, "cpu")
    f = p.forward
    n_chunks = max(-(-w // 64) for w in widths[:-1])
    assert act.numel() == 2 * f.tiles_m * n_chunks * 3 * f.rows * 64
    assert save.numel() == max(1, b * sum(padded(w) for w in widths[1:-1]))
    assert xb.numel() == b * padded(widths[0])
    assert dh0.numel() == dh1.numel() == b * max(map(padded, widths[1:]))
    want = sum(len(p.chunk_bounds(l)) * widths[l] * widths[l + 1]
               for l in range(len(widths) - 1))
    want += -(-b // FT.PREP_ROWS) * widths[-1]
    want += sum(-(-b // 128) * padded(w) for w in widths[1:-1])
    assert partial.numel() == p.partial == want
    assert partial.dtype == torch.float32 and save.dtype == torch.bfloat16


@pytest.mark.parametrize("widths", [(124, 2049, 128), (124, 0, 128),
                                    (8,) * 18, (2049, 16)],
                         ids=["wide", "empty", "deep", "wide-input"])
def test_unsupported_widths_raise_at_make(widths):
    with pytest.raises(ValueError):
        FT.make_fused_mlp_train(widths)
    with pytest.raises(ValueError):
        plan(widths, 384)


def test_widest_widths_plan_at_every_batch():
    """Widths of 2048 plan at B = 1 and B = 65536 alike: the plan takes at
    some batch no width it refuses at another."""
    widths = (2048, 2048, 2048)
    FT.make_fused_mlp_train(widths)
    for b in (1, 65536):
        plan(widths, b)


def test_sweep_overrides():
    base = plan(V1, 32768)
    assert BM.replan(base, LIMIT) == base
    p = plan(V1, 32768, dw_bn=128, dh_bn=128, chunks=2)
    assert all(t.bn == 128 and t.chunks == 2 for t in p.dw)
    assert all(t.bn == 128 for t in p.dh[1:]) and p.dh[0] is None
    assert p.forward == base.forward and p.save == base.save
    for t, dw in [(t, True) for t in p.dw] + [(t, False) for t in p.dh[1:]]:
        assert t.stages == FT._gemm_stages(t.bn, LIMIT,
                                           FT._gemm_blocks(dw, t.bn))
        assert t.smem == FT._gemm_smem(t.bn, t.stages) <= LIMIT
    # the partials' scratch is resized to the new chunk counts
    prods = [i * o for i, o in zip(V1[:-1], V1[1:])]
    assert p.partial - base.partial == sum(
        (t.chunks - o.chunks) * n for t, o, n in zip(p.dw, base.dw, prods))
    assert [c for l in range(len(p.dw)) for c in p.chunk_bounds(l)] == \
        [(0, 16384), (16384, 32768)] * len(p.dw)
    with pytest.raises(ValueError):
        plan(V1, 384, dw_bn=96)
    with pytest.raises(ValueError):
        plan(V1, 384, dh_bn=256)
    with pytest.raises(ValueError):
        plan(V1, 384, tile_b=0)


@pytest.mark.parametrize("net", ("v1", "v2rh"))
def test_bounds_count_the_products_the_backward_needs(net):
    """The backward's bound counts, layer by layer, the recompute of the
    hidden layers (not the last, whose output the backward never reads),
    dW of every layer and dh of every layer but the first; the three-pass
    floor takes the forward's and the recompute's products three times."""
    widths, b = NETS[net], 32768
    layers = list(zip(widths[:-1], widths[1:]))
    recompute = sum(i * o for i, o in layers[:-1])
    dw = sum(i * o for i, o in layers)
    dh = sum(i * o for i, o in layers[1:])
    got = BM.bounds_ms(widths, b)
    peak = BM.BF16_OPS_S
    for d, ops, floor in (("fwd", dw, 3 * dw),
                          ("bwd", recompute + dw + dh,
                           3 * recompute + dw + dh)):
        assert got[d]["bound_by"] == "operations"
        assert got[d]["bound_ms"] == pytest.approx(2 * b * ops / peak * 1e3,
                                                   rel=1e-12)
        assert got[d]["three_pass_floor_ms"] == pytest.approx(
            2 * b * floor / peak * 1e3, rel=1e-12)
    if net == "v1":   # the figures PERF.md states
        assert round(got["bwd"]["bound_ms"], 3) == 0.333
        assert round(got["bwd"]["three_pass_floor_ms"], 3) == 0.552
        assert round(got["fwd"]["three_pass_floor_ms"], 3) == 0.345


# --------------------------------------------------------------------------
# the kernels' arithmetic, emulated
# --------------------------------------------------------------------------
def _rn(t):
    return t.to(torch.bfloat16).float()


def emulate(x, dy, ws, bs, p):
    """(y, dW list, db list, masks) computed as the kernels compute them,
    in float32: the pack's bf16 weights; each hidden h saved as RN-bf16;
    the relu mask read back as saved >= 2**-126; dW_l as the sum, in chunk order,
    of each split-K chunk's bf16 product; db from the per-tile column sums
    (PREP_ROWS rows for dy, 128 for a dh product), added as the kernel
    adds them: 32 lanes, each its tiles ascending, then a butterfly."""
    pack = FT.pack_train_params_plain(ws, bs)
    layers = [(w.float(), b) for w, b, _ in pack.layers()]
    n = len(layers)
    h, saved = x, []
    for i, (w, b) in enumerate(layers):
        z = h @ w + b
        h = torch.relu(z) if i < n - 1 else z
        if i < n - 1:
            saved.append(_rn(h))
    y = h

    def tile_sums(t, rows):
        return torch.stack([t[s:s + rows].sum(0)
                            for s in range(0, t.shape[0], rows)])

    def in_order(parts):
        s = parts[0].clone()
        for q in parts[1:]:
            s += q
        return s

    def by_lanes(parts):
        lanes = [in_order(parts[k::32]) if k < len(parts)
                 else torch.zeros_like(parts[0]) for k in range(32)]
        for x in (16, 8, 4, 2, 1):
            lanes = [lanes[k] + lanes[k ^ x] for k in range(32)]
        return lanes[0]

    dws, dbs, masks = [None] * n, [None] * n, []
    dh = dy
    dbs[n - 1] = by_lanes(tile_sums(dy, FT.PREP_ROWS))
    for l in range(n - 1, -1, -1):
        a = _rn(x) if l == 0 else saved[l - 1]
        d = _rn(dh)
        dws[l] = in_order([a[s:e].t() @ d[s:e]
                           for s, e in p.chunk_bounds(l)])
        if l:
            mask = saved[l - 1] >= torch.finfo(torch.float32).tiny
            masks.append(mask)
            dh = torch.where(mask, d @ layers[l][0].t(), torch.zeros(()))
            dbs[l - 1] = by_lanes(tile_sums(dh, FT.GEMM_BM))
    return y, dws, dbs, masks


def _net(widths, rows, seed):
    rng = np.random.default_rng(seed)
    ws = [(rng.normal(size=(i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.normal(size=o)).astype(np.float32) for o in widths[1:]]
    x = rng.normal(size=(rows, widths[0])).astype(np.float32)
    dy = (rng.normal(size=(rows, widths[-1])) / rows).astype(np.float32)
    return ws, bs, x, dy


def _jax_vjp(widths, tile_b, ws, bs, x, dy):
    fn = jax_fused(widths, tile_b)
    y, vjp = jax.vjp(fn, jnp.asarray(x), [jnp.asarray(w) for w in ws],
                     [jnp.asarray(b) for b in bs])
    _, gw, gb = vjp(jnp.asarray(dy))
    return (np.asarray(y), [np.asarray(g) for g in gw],
            [np.asarray(g) for g in gb])


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return np.linalg.norm(a - b) / (np.linalg.norm(b) + 1e-30)


@pytest.mark.parametrize("widths,rows,tile_b", [
    ((124, 192, 160, 128), 96, 16),
    ((124, 192, 160, 128), 96, 32),
    ((124, 192, 160, 128), 96, 96),
    ((12, 10, 8, 3), 7, 128),
    (RAGGED, 256, 64),
], ids=["net-16", "net-32", "net-96", "small-odd", "ragged-256"])
def test_emulation_matches_the_pallas_vjp(widths, rows, tile_b):
    """The JAX test's batch of 96, and ragged widths.  (The Pallas kernel
    reads past the batch where tile_b does not divide it: a batch it
    divides, or one tile.  At B = 384 of the first widths the float32
    order alone, the plain version's as the emulation's, is 1.4e-5 from
    the Pallas VJP in dW_0 at this seed.)"""
    ws, bs, x, dy = _net(widths, rows, 3)
    # a plan with several chunks a layer, so their order is exercised
    p = plan(widths, rows, tile_b, chunks=3)
    assert any(len(p.chunk_bounds(l)) > 1 for l in range(len(ws))) or \
        rows <= tile_b
    y, dws, dbs, _ = emulate(torch.from_numpy(x), torch.from_numpy(dy),
                             [torch.from_numpy(w) for w in ws],
                             [torch.from_numpy(b) for b in bs], p)
    jy, jw, jb = _jax_vjp(widths, tile_b, ws, bs, x, dy)
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5, atol=1e-6)
    for a, b in zip(dws + dbs, jw + jb):
        assert a.shape == b.shape
        assert _rel_l2(a.numpy(), b) <= 1e-5, _rel_l2(a.numpy(), b)


def test_emulation_chunk_order_is_the_plans():
    """The emulated dW is the chunk-ordered sum, and two plans of one batch
    differ only in the order of float32 sums (the JAX test's tile_b
    tolerance, rtol 2e-2 / atol 1e-4)."""
    widths = (124, 192, 160, 128)
    ws, bs, x, dy = _net(widths, 512, 4)
    args = (torch.from_numpy(x), torch.from_numpy(dy),
            [torch.from_numpy(w) for w in ws],
            [torch.from_numpy(b) for b in bs])
    one = emulate(*args, plan(widths, 512, 128, chunks=1))
    four = emulate(*args, plan(widths, 512, 128, chunks=4))
    for a, b in zip(one[1] + one[2], four[1] + four[2]):
        np.testing.assert_allclose(a, b, rtol=2e-2, atol=1e-4)


def _mask_edge(h):
    """(emulated db, masks, JAX's db, the plain db) of a net whose first
    hidden unit has zero weights and bias ``h``, so its h is ``h`` in
    float32 on every row."""
    widths = (8, 4, 3)
    ws, bs, x, dy = _net(widths, 16, 5)
    ws[0][:, 0] = 0.0
    bs[0][0] = np.float32(h)
    tx, tdy = torch.from_numpy(x), torch.from_numpy(dy)
    tw = [torch.from_numpy(w) for w in ws]
    tb = [torch.from_numpy(b) for b in bs]
    _, _, dbs, masks = emulate(tx, tdy, tw, tb, plan(widths, 16))
    hid = torch.relu(tx @ FT._bf16(tw[0]) + tb[0])
    assert bool((hid[:, 0] == h).all())
    _, jw, jb = _jax_vjp(widths, 128, ws, bs, x, dy)
    _, pdb = FT.fused_mlp_train_bwd_plain(tx, tdy, tw, tb)
    return dbs, masks, jb, pdb


def _agree_elsewhere(dbs, jb, pdb):
    for a, p, b in zip(dbs[0][1:], pdb[0][1:], jb[0][1:]):
        assert abs(float(a) - float(b)) <= 1e-6 + 1e-5 * abs(float(b))
        assert abs(float(p) - float(b)) <= 1e-6 + 1e-5 * abs(float(b))


def test_mask_edge_of_the_saved_h():
    """A hidden unit with zero weights and bias 2**-140: h = 2**-140 in
    float32, which bf16 rounds to 0.  JAX on the CPU flushes that h in the
    relu, so its VJP masks the unit (db 0); the kernels' mask (saved h >=
    2**-126) and the plain version's (float32 h >= 2**-126) mask it too."""
    dbs, masks, jb, pdb = _mask_edge(2.0 ** -140)
    assert not masks[0][:, 0].any()
    assert float(dbs[0][0]) == 0.0
    assert float(jb[0][0]) == 0.0
    assert float(pdb[0][0]) == 0.0
    _agree_elsewhere(dbs, jb, pdb)


def test_mask_flushes_a_subnormal_saved_h():
    """h = 2**-130: a float32 subnormal whose bf16 copy is a nonzero bf16
    subnormal, so a mask of saved h > 0 would keep the unit.  JAX flushes
    it; the emulated kernels and the plain version give db 0 as well."""
    dbs, masks, jb, pdb = _mask_edge(2.0 ** -130)
    assert FT._bf16(torch.tensor(2.0 ** -130)).item() == 2.0 ** -130
    assert not masks[0][:, 0].any()
    assert float(jb[0][0]) == 0.0
    assert float(dbs[0][0]) == 0.0
    assert float(pdb[0][0]) == 0.0
    _agree_elsewhere(dbs, jb, pdb)
