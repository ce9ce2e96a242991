"""Kernels 1 and 4 of the port (the input transform and the v5 constraint
head) on the CPU: their tile plans at an H100's limits, the strided inputs
kernel 4 takes, an input that starts mid-row for kernel 1, and both against
the JAX package (kernel 4's Pallas kernel in interpret mode, kernel 1's XLA
chain), at the JAX tests' tolerances (tests/test_pallas_kernels.py:28,
:69)."""

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
from climsim_tpu_torch.online import wrapper as PW
from climsim_tpu_torch.ops import kernels as PK
from climsim_tpu_torch.varspec import VarSpec
from climsim_tpu_torch.varspec import get_varspec as port_varspec

# an H100 SXM: shared memory a block can opt in to, SMs, L2 bytes
SMEM, N_SM, L2 = 232448, 132, 50 * 2**20
H100 = (SMEM, N_SM, L2)
WIDTHS = (124, 557, 1405, 1525)   # v1, v2_rh, v5, the raw v4 row
BATCHES = (1, 2, 3, 4, 5, 7, 383, 384, 385, 6144, 32768, 65536)
HEAD_TOL = (2e-4, 1e-9)
TRANSFORM_TOL = (1e-5, 1e-7)


@pytest.mark.parametrize("mode", ["plan", "pipelined"])
@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("d", WIDTHS)
def test_transform_plan_covers_rows_in_16_byte_tiles(d, b, mode):
    """The plan at each shape, and the pipelined plan there (what an x
    that is 16-byte aligned gets past half the L2)."""
    p = PK.plan_input_transform(b, d, *H100,
                                direct=None if mode == "plan" else False)
    assert 2 <= p.stages <= PK.TRANSFORM_STAGES
    assert PK._transform_smem(p.rows, d, p.stages) <= SMEM
    assert p.threads <= PK.TRANSFORM_THREADS and p.threads % 32 == 0
    assert p.threads % p.row_threads == 0
    if mode == "plan":
        # direct where x fits half the L2
        assert p.direct == (4 * b * d <= L2 // 2)
    if p.direct:
        # a tile a CTA, its columns over col_blocks CTAs of one column a
        # thread: ordinary loads and stores, no shared memory
        phases = p.threads // p.row_threads
        assert p.tiles == p.grid and p.smem == 0
        assert p.cols == 1 and p.col_blocks == -(-d // 256)
        assert p.row_threads * p.col_blocks >= d
        assert p.rows % phases == 0
        assert p.rows <= PK.TRANSFORM_DIRECT_ROWS * phases
    else:
        assert p.row_threads * p.cols >= d > p.row_threads * (p.cols - 1)
        assert p.col_blocks == 1 and 1 <= p.grid <= min(p.tiles, 2 * N_SM)
        assert p.rows % 4 == 0 and p.rows >= 4
        assert p.smem == PK._transform_smem(p.rows, d, p.stages)
    seen = np.zeros(b, np.int64)
    # the kernel's order: CTA i takes tiles i, i + grid, ...
    tiles = [(cta, t * p.rows, min(p.rows, b - t * p.rows))
             for cta in range(p.grid) for t in range(cta, p.tiles, p.grid)]
    for cta, row0, n in tiles:
        assert 0 <= cta < p.grid and 1 <= n <= p.rows
        seen[row0:row0 + n] += 1
        if p.direct:
            continue
        # a tile of a 16-byte aligned x starts 16-byte aligned; the copy
        # engine takes its bytes down to a multiple of 16, the rest is
        # under 16 bytes (ordinary loads and stores)
        assert row0 * d * 4 % 16 == 0
        copied = n * d * 4 & ~15
        assert copied % 16 == 0 and n * d * 4 - copied < 16
        if n == p.rows:
            assert copied == n * d * 4
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("b", BATCHES)
def test_head_plan_covers_rows_in_16_byte_tiles(b):
    p = PK.plan_constraint_head(b, *H100)
    assert 1 <= p.rows <= PK.HEAD_TILE_ROWS <= PK.HEAD_MAX_ROWS
    assert 2 <= p.stages <= PK.HEAD_STAGES
    # direct where y, t, qc and qi fit half the L2: a tile a CTA
    assert p.direct == (4 * b * (308 + 180) <= L2 // 2)
    assert p.grid == p.tiles if p.direct else p.grid <= 2 * N_SM
    assert p.rows <= (PK.HEAD_DIRECT_ROWS if p.direct else PK.HEAD_TILE_ROWS)
    assert p.smem == (0 if p.direct else PK._head_smem(p.rows, p.stages))
    assert PK._head_smem(p.rows, p.stages) <= SMEM
    assert PK.HEAD_COL_THREADS + 60 * p.rows <= p.threads <= 1024
    assert p.threads % 32 == 0
    assert p.tiles == -(-b // p.rows) and 1 <= p.grid <= p.tiles
    # every row once; y (308 floats a row) and out (368) tiles are whole
    # multiples of 16 bytes at any row count
    assert 308 * 4 % 16 == 0 and 368 * 4 % 16 == 0
    rows = sorted(r for t in range(p.tiles)
                  for r in range(t * p.rows, min(b, (t + 1) * p.rows)))
    assert rows == list(range(b))
    # the batch spreads over the SMs before tiles grow
    assert p.rows <= -(-b // N_SM)


def test_transform_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="takes 1..1536 columns"):
        PK.plan_input_transform(1, PK.TRANSFORM_MAX_WIDTH + 1, *H100)
    with pytest.raises(ValueError, match="shared memory"):
        PK.plan_input_transform(1, 1525, 64 * 1024, N_SM, L2)  # small card
    with pytest.raises(ValueError, match="rows 0"):
        PK.plan_input_transform(0, 557, *H100)
    with pytest.raises(ValueError, match="multiple of 4"):
        PK.plan_input_transform(384, 557, *H100, tile_rows=6, direct=False)
    with pytest.raises(ValueError, match="tile_rows 13"):
        PK.plan_constraint_head(384, *H100, tile_rows=13)
    PK.check_input_transform(PK.TRANSFORM_MAX_WIDTH, "cpu")
    with pytest.raises(ValueError, match="takes 1..1536 columns"):
        PK.check_input_transform(PK.TRANSFORM_MAX_WIDTH + 1, "cpu")


def test_too_wide_transform_raises_when_built():
    """A width kernel 1 cannot take is refused by make_input_transform, not
    at the first call."""
    v4 = port_varspec("v4")
    wide = VarSpec("v4x2", v4.inputs + v4.inputs, v4.outputs)
    assert wide.input_len == 3050
    with pytest.raises(ValueError, match="input transform kernel"):
        PT.make_input_transform(wide, load_asset_norms("v4"),
                                PT.TransformConfig(), device="cpu")


# the transform configs of kernel 1's two served widths: (spec, the port's
# config, the reference's)
OFFSET_CASES = {
    557: ("v2_rh", PT.TransformConfig(input_clip=True, input_clip_rhonly=True),
          T.TransformConfig(input_clip=True, input_clip_rhonly=True)),
    1405: ("v5", PT.v5_online_config(), T.v5_online_config()),
}


@pytest.mark.parametrize("d", sorted(OFFSET_CASES))
def test_transform_on_a_view_that_starts_mid_row(d):
    """x[1:] of a 49-row array: its start is 4 bytes past a 16-byte
    boundary at D = 557 (the kernel reads it by ordinary loads), and the
    transform gives it the bits of its contiguous copy and the JAX
    transform's values."""
    version, pcfg, jcfg = OFFSET_CASES[d]
    spec, stats = get_varspec(version), load_asset_norms(version)
    x = synthetic_inputs(spec, 49, load_default_grid(), seed=5)
    x[3, 7], x[5, 11] = np.nan, np.inf
    full = torch.from_numpy(x)
    view = full[1:]
    assert view.is_contiguous() and spec.input_len == d
    assert (view.data_ptr() - full.data_ptr()) % 16 == 4
    consts = PT.input_transform_consts(spec, stats, pcfg, "cpu")
    PK.reset_launches()
    got = PK.fused_input_transform(view, consts)
    assert PK.LAUNCHES["fused_input_transform"] == 0   # CPU: plain version
    assert torch.equal(got, PK.fused_input_transform(view.clone(), consts))
    want = np.asarray(T.make_input_transform(spec, stats, jcfg)(
        jnp.asarray(x[1:])))
    np.testing.assert_allclose(got.numpy(), want, *TRANSFORM_TOL)


def _v4_rows(b, seed):
    """A raw (b, 1525) float32 row with t, qc, qi at columns 0:60, 120:180,
    180:240 (the v4 layout), and a normalized (b, 308) v5 output."""
    rng = np.random.default_rng(seed)
    raw = rng.normal(size=(b, 1525)).astype(np.float32)
    raw[:, 0:60] = 260 + 30 * rng.random((b, 60))
    raw[:, 120:180] = np.abs(rng.normal(size=(b, 60))) * 1e-5
    raw[:, 180:240] = np.abs(rng.normal(size=(b, 60))) * 1e-5
    y = rng.normal(size=(b, 308)).astype(np.float32)
    return raw, y


@pytest.mark.parametrize("b", [1, 7, 24])
def test_head_takes_strided_views(b):
    """t, qc and qi as views of the raw (B, 1525) row give the bits of
    their contiguous copies, and both match the Pallas kernel (interpret
    mode) at the JAX test's tolerance."""
    raw, y = _v4_rows(b, seed=b)
    stats = load_asset_norms("v5")
    consts = PK.constraint_head_consts(stats.out_scale, 15, device="cpu")
    x = torch.from_numpy(raw)
    views = (x[:, 0:60], x[:, 120:180], x[:, 180:240])
    assert all(v.stride() == (1525, 1) for v in views)
    yt = torch.from_numpy(y)
    got = PK.fused_constraint_head(yt, *views, consts, 1200.0)
    copies = PK.fused_constraint_head(
        yt, *(v.contiguous() for v in views), consts, 1200.0)
    assert PK.LAUNCHES["fused_constraint_head"] == 0
    assert torch.equal(got, copies)
    pallas = np.asarray(K.make_fused_constraint_head(
        stats, strato_lev_out=15, tile_b=16)(
        jnp.asarray(y), *(jnp.asarray(raw[:, s]) for s in (
            slice(0, 60), slice(120, 180), slice(180, 240)))))
    for a in (got, copies):
        np.testing.assert_allclose(a.numpy(), pallas, *HEAD_TOL)


def test_head_refuses_a_column_stride():
    raw, y = _v4_rows(7, seed=1)
    x = torch.from_numpy(raw)
    consts = PK.constraint_head_consts(load_asset_norms("v5").out_scale, 15,
                                       device="cpu")
    t, qc, qi = x[:, 0:60], x[:, 120:180], x[:, 180:240]
    for bad in (x[:, 300:420:2], x[:, 0:60].t().contiguous().t()):
        assert bad.shape == (7, 60) and bad.stride(1) != 1
        for args in ((bad, qc, qi), (t, bad, qi), (t, qc, bad)):
            with pytest.raises(ValueError, match="unit column stride"):
                PK.fused_constraint_head(torch.from_numpy(y), *args, consts,
                                         1200.0)
    # rows that overlap (a row stride under 60) are refused too
    overlap = torch.as_strided(x, (7, 60), (30, 1))
    with pytest.raises(ValueError, match="row stride"):
        PK.fused_constraint_head(torch.from_numpy(y), overlap, qc, qi,
                                 consts, 1200.0)


def test_v4_wrapper_reads_the_raw_row_in_place(monkeypatch):
    """make_wrapper's v4 path hands the head t, qc and qi as views of the
    raw row (no device copy) and its v5 path the combined-cloud split."""
    seen = []
    head = PK.fused_constraint_head

    def spy(y, t, qc, qi, consts, dt):
        seen.append([(a.stride(), a.data_ptr()) for a in (t, qc, qi)])
        return head(y, t, qc, qi, consts, dt)

    monkeypatch.setattr(PK, "fused_constraint_head", spy)
    spec4 = port_varspec("v4")
    x = torch.from_numpy(synthetic_inputs(spec4, 5, load_default_grid(),
                                          seed=2))
    proj = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1405, 308)).astype(np.float32) / 40)
    wrap = PW.make_wrapper(lambda xn: xn @ proj, load_asset_norms("v5"),
                           PW.WrapperConfig(input_version="v4"),
                           device="cpu")
    out = wrap(x)
    assert out.shape == (5, 368) and torch.isfinite(out).all()
    base = x.data_ptr()
    assert seen == [[((1525, 1), base), ((1525, 1), base + 120 * 4),
                     ((1525, 1), base + 180 * 4)]]


def _bad_transform_args():
    x = torch.zeros(4, 557)
    c = torch.zeros(7, 557)
    return {"x float64": (x.double(), c), "consts float64": (x, c.double()),
            "x 1-D": (x[0], c), "x too wide": (torch.zeros(4, 558), c),
            "consts 6 rows": (x, c[:6]), "x not a tensor": (x.numpy(), c),
            "x not contiguous": (torch.zeros(557, 4).t(), c),
            "consts not contiguous": (x, torch.zeros(557, 7).t()),
            "x on meta": (x.to("meta"), c)}


@pytest.mark.parametrize("case", sorted(_bad_transform_args()))
def test_transform_refuses_bad_arguments(case):
    """The wrapper's quick common-case test does not let a bad argument
    through: every check that raised before still raises."""
    x, c = _bad_transform_args()[case]
    with pytest.raises((TypeError, ValueError)):
        PK.fused_input_transform(x, c)


def _bad_head_args():
    raw, y = _v4_rows(5, seed=3)
    x, y = torch.from_numpy(raw), torch.from_numpy(y)
    c = PK.constraint_head_consts(load_asset_norms("v5").out_scale, 15,
                                  device="cpu")
    t, qc, qi = x[:, 0:60], x[:, 120:180], x[:, 180:240]
    return {"y float64": (y.double(), t, qc, qi, c, 1200.0),
            "y 307 wide": (y[:, :307], t, qc, qi, c, 1200.0),
            "y not contiguous": (torch.zeros(308, 5).t(), t, qc, qi, c,
                                 1200.0),
            "consts 1 row": (y, t, qc, qi, c[:1], 1200.0),
            "t 4 rows": (y, t[:4], qc, qi, c, 1200.0),
            "qc float64": (y, t, qc.double(), qi, c, 1200.0),
            "qi 59 levels": (y, t, qc, x[:, 180:239], c, 1200.0),
            "dt 0": (y, t, qc, qi, c, 0.0)}


@pytest.mark.parametrize("case", sorted(_bad_head_args()))
def test_head_refuses_bad_arguments(case):
    with pytest.raises((TypeError, ValueError)):
        PK.fused_constraint_head(*_bad_head_args()[case])


@pytest.mark.parametrize("rows", [1, 7, 384])
def test_head_output_template_gives_contiguous_outputs(rows):
    """kernel 4's output comes from torch.empty_like of a kept stride-0
    template; the kernel stores whole rows, so it must be contiguous."""
    out = torch.empty_like(PK._head_out(rows, torch.device("cpu")))
    assert out.shape == (rows, PK.CONTRACT_OUT) and out.is_contiguous()
    assert out.dtype == torch.float32
