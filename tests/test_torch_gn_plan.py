"""Kernel 5's tile plan (``ops.unet_fused.plan_gn_silu_conv3``) on the CPU.

The CUDA kernel runs only on the card; its plan and shape rules are Python
and are checked here against an H100's numbers (the ``_H100`` stub: 232,448
bytes of shared memory a block, 132 SMs): every unet_v5 chain gets a plan
that fits at every batch, a row tile holds whole samples, the grid covers
every (row, column) once, and the order of the K sum -- the one thing a
sample's output bits depend on besides its own inputs -- is the same at
every batch.  Shapes the kernel cannot take are refused with the reason.
"""

import numpy as np
import pytest
import torch

from climsim_tpu_torch.bench_gn_conv3 import chain_bound_ms, unet_v5_chains
from climsim_tpu_torch.models.unet import _num_groups
from climsim_tpu_torch.ops import unet_fused as PU
from test_torch_unet_train import _H100

CHAINS = unet_v5_chains()
BATCHES = (1, 7, 16, 384, 1024)
# the fused chains of a unet_v5 at model_channels=256 (BIG_KW), written out
# so that collecting the tests builds no model; the test below holds them
# to the model's own
BIG_KW = dict(model_channels=256, channel_mult=(1, 2, 2, 2), num_blocks=4,
              attn_resolutions=(8,), fused_gn_conv=True)
BIG_CHAINS = {
    (64, 256, 256): 13, (32, 256, 256): 1, (32, 256, 512): 1,
    (32, 512, 512): 13, (16, 512, 512): 15, (8, 512, 512): 18,
    (8, 1024, 512): 5, (16, 1024, 512): 5, (32, 1024, 512): 4,
    (32, 768, 512): 1, (64, 512, 512): 1, (64, 768, 256): 1,
    (64, 512, 256): 4}
RAGGED = ((60, 64, 48), (15, 128, 80))
LIMIT, N_SM = _H100.shared_memory_per_block_optin, _H100.multi_processor_count


def plan(b, l, c, cout, tiles=None):
    return PU.plan_gn_silu_conv3(b, l, c, cout, LIMIT, N_SM, tiles)


def test_the_unet_v5_forward_has_82_chains_of_13_shapes():
    assert len(CHAINS) == 13 and sum(CHAINS.values()) == 82


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", [*CHAINS, *RAGGED], ids=str)
def test_every_chain_gets_a_plan_that_fits(shape, b):
    l, c, cout = shape
    p = plan(b, l, c, cout)
    assert p.smem <= LIMIT
    assert p.smem == PU._smem_bytes(p.samples, l, c, _num_groups(c), p.nt,
                                    p.stages)
    assert 2 <= p.stages <= PU.STAGES
    assert (p.nwg, p.nt) in PU._TILES
    # whole samples a tile, within its rows
    assert 1 <= p.samples <= b and p.samples * l <= p.rows
    assert 1 <= p.grid <= 2**31 - 1


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", [*CHAINS, *RAGGED], ids=str)
def test_the_grid_covers_every_row_and_column_once(shape, b):
    """Block i takes row tile i // tiles_n (samples S t .. S t + S - 1,
    those below B) and columns n_tile (i % tiles_n) .. + n_tile (those
    below Cout), as the kernel does."""
    l, c, cout = shape
    p = plan(b, l, c, cout)
    cover = np.zeros((b * l, cout), np.int32)
    for i in range(p.grid):
        t, n = divmod(i, p.tiles_n)
        rows = slice(t * p.samples * l, min((t + 1) * p.samples, b) * l)
        cols = slice(n * p.n_tile, min((n + 1) * p.n_tile, cout))
        assert rows.start < rows.stop and cols.start < cols.stop, i
        cover[rows, cols] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("shape", [*CHAINS, *RAGGED], ids=str)
def test_the_k_order_does_not_depend_on_the_batch(shape):
    """Every output sums the (3C, Cout) matrix's rows in 64-row stages,
    tap 0, 1, 2 and C ascending within a tap, whatever the batch and so
    whatever the tiling: 50 rows served alone or padded to 384 get the
    same bits."""
    l, c, cout = shape
    want = tuple((q * 64 // c, q * 64 % c) for q in range(3 * c // 64))
    plans = [plan(b, l, c, cout) for b in (*BATCHES, 50)]
    plans += [plan(384, l, c, cout, t) for t in PU._TILES
              if PU._smem_bytes(min(64 * t[0] // l, 384), l, c,
                                _num_groups(c), t[1], 2) <= LIMIT]
    assert {p.k_order for p in plans} == {want}
    assert len({(p.nwg, p.nt, p.samples) for p in plans}) > 1


@pytest.mark.parametrize("shape", list(CHAINS), ids=str)
def test_short_grids_are_spread_over_the_sms(shape):
    """Where the most samples a tile would leave SMs idle, the plan takes
    fewer (down to half the rows) and stays within one block an SM."""
    l, c, cout = shape
    p = plan(384, l, c, cout)
    most = min(p.rows // l, 384)
    full = -(-384 // most) * p.tiles_n
    if p.samples < most:
        assert full < N_SM and p.grid <= N_SM
        assert 2 * p.samples >= most
    else:
        assert full == p.grid


@pytest.mark.parametrize("shape, reason", [
    ((64, 96, 64), "C a multiple of 64"),
    ((64, 192, 64), r"C / groups = 6"),
    ((65, 128, 128), "L <= 64"),
    ((64, 128, 40), "Cout a multiple of 16"),
    ((64, 2048, 64), "shared memory"),
], ids=str)
def test_refused_shapes_give_the_reason(shape, reason):
    with pytest.raises(ValueError, match=reason):
        plan(16, *shape)


def test_shape_error_reads_the_card(monkeypatch):
    """``_shape_error`` plans with the device's own limits: a card with
    less shared memory refuses what an H100 takes."""
    class _Small(_H100):
        shared_memory_per_block_optin = 48 * 1024

    dev = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _H100())
    assert PU._shape_error(384, 32, 512, 256, dev) is None
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _Small())
    assert "shared memory" in PU._shape_error(384, 32, 512, 256, dev)


def test_chain_bound_is_bytes_at_the_served_batch():
    """The bound of a chain: its bytes over 3.35 TB/s (x in, y out, the
    parameters and the bf16 weights once) against its bf16 products over
    989 TFLOP/s; at B = 384 every chain is bound by its bytes, 0.477 ms
    over the 82."""
    total = 0.0
    for (l, c, cout), n in CHAINS.items():
        ms, by = chain_bound_ms(384, l, c, cout)
        assert by == "bytes"
        total += n * ms
    assert total == pytest.approx(0.4765, abs=5e-4)


def test_big_chains_are_the_models():
    from climsim_tpu_torch import get_varspec
    from climsim_tpu_torch.models.unet import ClimSimUNet

    m = ClimSimUNet(get_varspec("v5"), **BIG_KW)
    assert m.fused_chains(1024) == BIG_CHAINS


def test_f1_the_wide_chains_plan_at_the_trainers_batch():
    """The five (8, 1024, 512) chains of the 256-channel unet_v5: eight
    samples a tile would need 233,888 B of shared memory at B = 1024, so
    the plan takes fewer (it raised here before)."""
    assert BIG_CHAINS[(8, 1024, 512)] == 5
    p = plan(1024, 8, 1024, 512)
    assert p.smem <= LIMIT and 1 <= p.samples < 8
    assert PU._smem_bytes(8, 8, 1024, 32, p.nt, 2) > LIMIT


@pytest.mark.parametrize("shape", [*CHAINS, *RAGGED, *BIG_CHAINS], ids=str)
def test_a_shape_planned_at_b1_plans_at_every_batch(shape):
    l, c, cout = shape
    k_order = plan(1, l, c, cout).k_order
    for b in (7, 384, 1024, 6144):
        p = plan(b, l, c, cout)
        assert p.k_order == k_order
        assert p.smem <= LIMIT and 2 <= p.stages
        assert (p.nwg, p.nt) in PU._TILES
        assert 1 <= p.samples <= b and p.samples * l <= p.rows
        assert p.tiles_m == -(-b // p.samples)


@pytest.mark.parametrize("b", (1024, 6144))
@pytest.mark.parametrize("shape", list(BIG_CHAINS), ids=str)
def test_the_stepped_down_grid_covers_every_row_and_column_once(shape, b):
    l, c, cout = shape
    p = plan(b, l, c, cout)
    rows = np.zeros(b * l, np.int32)
    for t in range(p.tiles_m):
        rows[t * p.samples * l:min((t + 1) * p.samples, b) * l] += p.tiles_n
    assert (rows == -(-cout // p.n_tile)).all()
    assert p.tiles_n * p.n_tile >= cout > (p.tiles_n - 1) * p.n_tile


def test_check_kernel_shapes_checks_the_trainers_batch(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: _H100())
    PU.check_kernel_shapes(BIG_CHAINS, "cuda", batch=1024)
    PU.check_kernel_shapes(BIG_CHAINS, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        PU.check_kernel_shapes({(64, 2048, 64): 1}, "cuda", batch=1024)


def test_the_trainer_checks_its_batch(monkeypatch):
    """unet_trainer hands its sample batch's size to the check: a chain
    the kernel takes at B = 1 only would be refused at build time."""
    from climsim_tpu_torch.train import recipes

    seen = []
    monkeypatch.setattr(PU, "check_kernel_shapes",
                        lambda chains, dev, batch=1: seen.append(batch))
    model = type("M", (), {"fused_gn_conv": True,
                           "fused_chains": lambda self: BIG_CHAINS})()
    x = np.zeros((1024, 4), np.float32)
    recipes._check_fused(model, "cuda", (x, x))
    recipes._check_fused(model, "cuda")
    assert seen == [1024, 1]
