"""The port's native shard loader (climsim_tpu_torch.data.native) on the
CPU: it builds its own copy of the C++ engine with g++, its batches equal
the JAX NativeLoader's for the same seed (where the JAX package's library
is built), its gather equals numpy's, and a build that cannot succeed
raises, in NativeLoader and in make_loader alike."""

import os

import numpy as np
import pytest
import torch

from climsim_tpu.data import native as JN
from climsim_tpu_torch.data import native as PN
from climsim_tpu_torch.data.pipeline import BatchLoader
from climsim_tpu_torch.parallel import mesh as PM


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(1000, 124)).astype(np.float32)
    y = rng.normal(size=(1000, 128)).astype(np.float32)
    xp, yp = str(d / "train_input.npy"), str(d / "train_target.npy")
    np.save(xp, x)
    np.save(yp, y)
    return xp, yp, x, y


def _epoch(loader):
    return [(a.numpy().copy(), b.numpy().copy()) for a, b in loader]


def test_builds_its_own_library(shards):
    xp, yp, _, _ = shards
    ld = PN.NativeLoader(xp, yp, 64, device="cpu")
    path = PN.library_path()
    assert path.exists() and path.parent.parent == PN.BUILD_ROOT
    assert (ld.num_samples, ld.dx, ld.dy) == (1000, 124, 128)
    assert ld.steps_per_epoch == 15
    ld.close()


@pytest.mark.parametrize("shuffle", [True, False])
def test_batches_equal_the_jax_loader(shards, shuffle):
    """Two epochs (seeds 7 and 8 in the engine), batch 96, against the JAX
    NativeLoader over the JAX package's own build of the same source."""
    if not JN.available():
        pytest.skip("the JAX package's libclimload.so is not built")
    xp, yp, _, _ = shards
    ours = PN.NativeLoader(xp, yp, 96, threads=3, ring=3, shuffle=shuffle,
                           seed=7, device="cpu")
    ref = JN.NativeLoader(xp, yp, 96, threads=3, ring=3, shuffle=shuffle,
                          seed=7)
    for _ in range(2):
        got, want = _epoch(ours), list(ref)
        assert len(got) == len(want) == 10
        for (a, b), (c, d) in zip(got, want):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)
    ours.close()
    ref.close()


def test_epochs_are_shuffled_permutations(shards):
    xp, yp, x, y = shards
    ld = PN.NativeLoader(xp, yp, 100, threads=2, ring=2, seed=3,
                         device="cpu")
    orders = []
    for _ in range(2):
        got = _epoch(ld)
        ex = np.concatenate([a for a, _ in got])
        ey = np.concatenate([b for _, b in got])
        # each row is a row of the split, its target beside it
        rows = {r.tobytes(): i for i, r in enumerate(x)}
        ids = np.array([rows[r.tobytes()] for r in ex])
        np.testing.assert_array_equal(np.sort(ids), np.arange(1000))
        np.testing.assert_array_equal(ey, y[ids])
        orders.append(ids)
    assert not np.array_equal(orders[0], orders[1])
    assert not np.array_equal(orders[0], np.arange(1000))


def test_gather_equals_numpy(shards):
    xp, yp, x, y = shards
    ld = PN.NativeLoader(xp, yp, 64, threads=3, device="cpu")
    idx = np.array([0, 5, 999, 17] * 40, np.int64)
    gx, gy = ld.gather(idx)
    np.testing.assert_array_equal(gx, x[idx])
    np.testing.assert_array_equal(gy, y[idx])
    with pytest.raises(IndexError):
        ld.gather(np.array([1000]))
    ld.close()


def test_refuses_a_shard_it_cannot_read(shards, tmp_path):
    xp, _, x, _ = shards
    bad = str(tmp_path / "f64.npy")
    np.save(bad, x.astype(np.float64))
    with pytest.raises(OSError):
        PN.NativeLoader(bad, xp, 8, device="cpu")
    # a global batch the processes cannot split
    with pytest.raises(ValueError):
        PN.NativeLoader(xp, xp, 8, rules=PM.ShardingRules(
            PM.Mesh(3, 0, torch.device("cpu"), None)))


def test_make_loader_takes_native_unless_asked(shards):
    xp, yp, x, _ = shards
    ld = PN.make_loader(xp, yp, 100, seed=1, device="cpu")
    assert isinstance(ld, PN.NativeLoader)
    ld.close()
    alt = PN.make_loader(xp, yp, 100, seed=1, prefer_native=False,
                         device="cpu")
    assert isinstance(alt, BatchLoader)
    want = BatchLoader(x, np.load(yp), 100, seed=1, device="cpu")
    for (a, _), (b, _) in zip(alt, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fault", ["no_compiler", "bad_source"])
def test_failed_build_raises(shards, tmp_path, monkeypatch, fault):
    """No silent fallback: without g++, or with a source g++ refuses, the
    build, NativeLoader and make_loader raise RuntimeError."""
    xp, yp, _, _ = shards
    monkeypatch.setattr(PN, "_lib", None)
    monkeypatch.setattr(PN, "BUILD_ROOT", tmp_path / "build")
    if fault == "no_compiler":
        monkeypatch.setenv("PATH", str(tmp_path))
    else:
        src = tmp_path / "climload.cpp"
        src.write_text("this is not C++\n")
        monkeypatch.setattr(PN, "SOURCE", src)
    with pytest.raises(RuntimeError):
        PN.build()
    with pytest.raises(RuntimeError):
        PN.NativeLoader(xp, yp, 8, device="cpu")
    with pytest.raises(RuntimeError):
        PN.make_loader(xp, yp, 8, device="cpu")
    assert not os.path.exists(PN.library_path())
