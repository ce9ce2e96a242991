"""The port's DeviceResidentLoader (climsim_tpu_torch.data.pipeline) on
the CPU.

The uploaded host shuffle is numpy's and must equal the JAX loader's bit
for bit.  The per-epoch permutations are torch's Philox draws, not JAX's
threefry ones, so the rest checks the loader's invariants, and the epoch
runner against the Python loop, exactly."""

import numpy as np
import pytest
import torch

from climsim_tpu.data.pipeline import DeviceResidentLoader as JaxLoader
from climsim_tpu.varspec import get_varspec
from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
from climsim_tpu_torch.parallel import mesh as PM
from climsim_tpu_torch.train import recipes as PR

N, D = 1024, 6


def _data():
    """Row r carries r in column 0 (exact in float32) beside noise."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, D)).astype(np.float32)
    x[:, 0] = np.arange(N)
    y = rng.standard_normal((N, 3)).astype(np.float32)
    y[:, 0] = np.arange(N)
    return x, y


def _epoch(loader):
    xs, ys = zip(*[(xb.numpy(), yb.numpy()) for xb, yb in loader])
    return np.concatenate(xs), np.concatenate(ys)


@pytest.mark.parametrize("block", [None, 64])
def test_upload_order_equals_jax(block):
    x, y = _data()
    ours = DeviceResidentLoader(x, y, 256, seed=3, block_shuffle=block,
                                device="cpu")
    ref = JaxLoader(x, y, 256, seed=3, block_shuffle=block)
    np.testing.assert_array_equal(ours.x.numpy(), np.asarray(ref.x))
    np.testing.assert_array_equal(ours.y.numpy(), np.asarray(ref.y))
    assert ours.steps_per_epoch == ref.steps_per_epoch == 4


@pytest.mark.parametrize("block", [None, 64])
def test_epochs_are_permutations_of_the_split(block):
    x, y = _data()
    ld = DeviceResidentLoader(x, y, 256, seed=1, block_shuffle=block,
                              device="cpu")
    orders = []
    for _ in range(3):
        ex, ey = _epoch(ld)
        assert ex.shape == (N, D) and ey.shape == (N, 3)
        ids = ex[:, 0].astype(np.int64)
        np.testing.assert_array_equal(np.sort(ids), np.arange(N))
        np.testing.assert_array_equal(ey[:, 0], ex[:, 0])  # x, y together
        np.testing.assert_array_equal(ex, x[ids])
        orders.append(ids)
    assert not np.array_equal(orders[0], orders[1])


def test_blocks_stay_whole():
    """Each 64-row block of an epoch is a block of the uploaded order,
    rows in their uploaded order."""
    x, y = _data()
    ld = DeviceResidentLoader(x, y, 256, seed=2, block_shuffle=64,
                              device="cpu")
    up = ld.x[:, 0].numpy().astype(np.int64).reshape(-1, 64)
    seen = set()
    for blk in _epoch(ld)[0][:, 0].astype(np.int64).reshape(-1, 64):
        k = int(np.flatnonzero(up[:, 0] == blk[0])[0])
        np.testing.assert_array_equal(blk, up[k])
        seen.add(k)
    assert seen == set(range(N // 64))


def test_no_shuffle_keeps_order_and_drops_the_remainder():
    x, y = _data()
    ld = DeviceResidentLoader(x[:1000], y[:1000], 256, shuffle=False,
                              block_shuffle=64, device="cpu")
    assert ld.block is None and ld.steps_per_epoch == 3
    np.testing.assert_array_equal(_epoch(ld)[0], x[:768])


def test_split_must_divide_into_blocks():
    x, y = _data()
    with pytest.raises(ValueError):
        DeviceResidentLoader(x[:1000], y[:1000], 100, block_shuffle=64,
                             device="cpu")
    with pytest.raises(ValueError):   # a batch 3 ranks cannot split
        DeviceResidentLoader(x, y, 256, rules=PM.ShardingRules(
            PM.Mesh(3, 0, torch.device("cpu"), None)))


def test_set_epoch_reproduces_an_epoch():
    x, y = _data()
    ld = DeviceResidentLoader(x, y, 256, seed=4, block_shuffle=64,
                              device="cpu")
    epochs = [_epoch(ld)[0] for _ in range(3)]
    ld.set_epoch(1)
    np.testing.assert_array_equal(_epoch(ld)[0], epochs[1])
    np.testing.assert_array_equal(_epoch(ld)[0], epochs[2])
    again = DeviceResidentLoader(x, y, 256, seed=4, block_shuffle=64,
                                 device="cpu")
    np.testing.assert_array_equal(_epoch(again)[0], epochs[0])


@pytest.mark.parametrize("block", [None, 128])
def test_epoch_runner_equals_the_python_loop(block):
    """run(state, 2) is two passes of ``for xb, yb in loader``, bit for
    bit: the same draws, the same parameters, per-epoch mean losses."""
    from climsim_tpu.grid import load_default_grid
    from climsim_tpu.norms import load_asset_norms
    from climsim_tpu_torch.data.synthetic import synthetic_split

    spec, stats = get_varspec("v1"), load_asset_norms("v1")
    x, y = synthetic_split(spec, 768, load_default_grid(), seed=0)

    def trainer():
        return PR.mlp_trainer(spec, stats, (x, y), 5, hidden=(32, 16),
                              steps_per_epoch=3, device="cpu")

    a, b = trainer(), trainer()
    la = DeviceResidentLoader(x, y, 256, seed=6, block_shuffle=block,
                              device="cpu")
    lb = DeviceResidentLoader(x, y, 256, seed=6, block_shuffle=block,
                              device="cpu")
    sa, ma = la.make_epoch_runner(a.train_step)(a.state, 2)
    sb, means = b.state, []
    for _ in range(2):
        losses = []
        for xb, yb in lb:
            sb, m = b.train_step(sb, xb, yb)
            losses.append(m["loss"])
        means.append(torch.stack(losses).mean())
    assert ma["loss"].shape == (2,)
    assert torch.equal(ma["loss"], torch.stack(means))
    assert sa.step == sb.step == 6
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
