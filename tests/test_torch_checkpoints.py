"""The port's checkpoints (climsim_tpu_torch.train.checkpoints) against
climsim_tpu.train.checkpoints: the same metric sequence through both
TopKCheckpointers gives the same topk.json entries (metric, step; the
port's files end in .pt where JAX's end in .msgpack) and the same files
on disk, after eviction, a reopened directory (resume) and a moved one
(relocation); the best entry loads back bit for bit.  A write that fails
midway leaves the previous checkpoint intact."""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from climsim_tpu.train import checkpoints as JC
from climsim_tpu_torch.train import checkpoints as PC


def _module(seed: int) -> torch.nn.Module:
    g = torch.Generator().manual_seed(seed)
    m = torch.nn.Linear(4, 3)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return m


def _entries(directory: str, suffix: str) -> list:
    with open(os.path.join(directory, "topk.json")) as f:
        entries = json.load(f)
    for _, step, name in entries:
        assert name == f"ckpt_step{step}{suffix}"
    return [(m, s) for m, s, _ in entries]


def _files(directory: str, suffix: str) -> set:
    return {f[:-len(suffix)] for f in os.listdir(directory)
            if f.startswith("ckpt_") and f.endswith(suffix)}


STREAM = [(0.9, 1), (0.5, 2), (0.7, 3), (0.95, 4), (0.4, 5), (0.6, 6),
          (0.45, 7)]


@pytest.mark.parametrize("mode", ["min", "max"])
def test_topk_matches_jax(tmp_path, mode):
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jk, pk = JC.TopKCheckpointer(jdir, k=3, mode=mode), \
        PC.TopKCheckpointer(pdir, k=3, mode=mode)
    for metric, step in STREAM[:4]:
        tree = {"w": np.full(2, float(step), np.float32)}
        assert pk.maybe_save(metric, step, _module(step)) == \
            jk.maybe_save(metric, step, tree)
    assert _entries(pdir, ".pt") == _entries(jdir, ".msgpack")
    # resume: reopen both directories and go on
    jk, pk = JC.TopKCheckpointer(jdir, k=3, mode=mode), \
        PC.TopKCheckpointer(pdir, k=3, mode=mode)
    for metric, step in STREAM[4:]:
        tree = {"w": np.full(2, float(step), np.float32)}
        assert pk.maybe_save(metric, step, _module(step)) == \
            jk.maybe_save(metric, step, tree)
    assert _entries(pdir, ".pt") == _entries(jdir, ".msgpack")
    assert _files(pdir, ".pt") == _files(jdir, ".msgpack")
    assert len(_files(pdir, ".pt")) == 3
    assert pk.best()[:2] == jk.best()[:2]
    pk.save_last(7, _module(7))
    jk.save_last(7, {"w": np.zeros(2, np.float32)})
    for d in (pdir, jdir):
        with open(os.path.join(d, "last.json")) as f:
            assert json.load(f) == {"step": 7}
    # relocation: entries are basenames, resolved in the new directory
    moved = str(tmp_path / "moved")
    shutil.move(pdir, moved)
    best = PC.TopKCheckpointer(moved, k=3, mode=mode)
    step = best.best()[1]
    got = best.load_best(torch.nn.Linear(4, 3))
    for k, v in _module(step).state_dict().items():
        torch.testing.assert_close(got.state_dict()[k], v, rtol=0, atol=0)
    assert set(best.load_best()) == {"weight", "bias"}


def test_save_is_atomic(tmp_path, monkeypatch):
    """A failure midway through a write leaves the last good file."""
    path = str(tmp_path / "state.pt")
    PC.save_state(path, _module(1))
    real_save = torch.save

    def broken(obj, f, *a, **kw):
        real_save(obj, f, *a, **kw)
        with open(f, "r+b") as fh:
            fh.truncate(10)
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", broken)
    with pytest.raises(OSError):
        PC.save_state(path, _module(2))
    monkeypatch.setattr(torch, "save", real_save)
    got = PC.load_state(path, torch.nn.Linear(4, 3))
    torch.testing.assert_close(got.weight, _module(1).weight, rtol=0, atol=0)


def test_state_round_trip_and_timed_saves(tmp_path):
    """Nested modules and tensors come back as saved, through
    weights_only loading; the timed checkpointer writes at most once an
    interval."""
    tree = {"reg": _module(3), "cls": _module(4), "step": 5,
            "x": torch.arange(3.0)}
    path = str(tmp_path / "tree.pt")
    PC.save_state(path, tree)
    back = PC.load_state(path)
    assert back["step"] == 5
    torch.testing.assert_close(back["x"], torch.arange(3.0))
    torch.testing.assert_close(back["cls"]["weight"], _module(4).weight)
    timed = PC.TimedCheckpointer(str(tmp_path / "timed.pt"),
                                 interval_seconds=3600.0)
    assert timed.maybe_save(_module(1))
    assert not timed.maybe_save(_module(2))
    got = PC.load_state(timed.path, torch.nn.Linear(4, 3))
    torch.testing.assert_close(got.weight, _module(1).weight, rtol=0, atol=0)
