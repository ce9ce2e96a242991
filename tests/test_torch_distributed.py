"""The port's data-parallel training (parallel.mesh, the rules of
train.step, train.step_shardmap, the loaders over processes,
DistributedCheckpointer, run over N ranks) on the CPU over gloo.

In-process: the loaders' rank slices tile the global batches (the
counterparts of tests/test_multihost.py:25-50), the refusals, and a
1-rank group whose steps are the steps without rules, bit for bit.
Spawned (tests/torch_dp_ranks.py, 2 ranks through a FileStore): the
mlp_trainer's DDP and explicit steps, HSR across its stage boundary, and
run_experiment at num_data_shards=2 with its checkpoint.

Tolerances: the ranks' losses equal (atol 0); 2 ranks against 1 process
rtol 1e-6 (tests/test_multihost.py:168: the same sums in another order);
the 1-process run against JAX's mlp_trainer rtol 1e-5, the parity of
tests/test_torch_train.py; checkpoints bit-equal.
"""

import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from climsim_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import identity_norms as jax_identity_norms
from climsim_tpu.train import recipes as JR
from climsim_tpu.varspec import get_varspec as jax_varspec
from climsim_tpu_torch import run as PRUN
from climsim_tpu_torch.config import PRESETS
from climsim_tpu_torch.data import native as PN
from climsim_tpu_torch.data import pipeline as PP
from climsim_tpu_torch.parallel import mesh as PM
from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
from climsim_tpu_torch.train.step_shardmap import make_shardmap_train_step
from climsim_tpu_torch.utils.migrate import port_flax_mlp

import torch_dp_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))


def _x(n=64, d=3):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    return x, -x


def _rules(world, rank):
    """Rank ``rank`` of ``world`` on the CPU, without a process group (the
    loaders read only the rank and the world size)."""
    return PM.ShardingRules(PM.Mesh(world, rank, torch.device("cpu"), None))


def _batches(make, pidx, pcount, epochs=2):
    ld = make(rules=_rules(pcount, pidx))
    out = []
    for _ in range(epochs):
        out += [tuple(np.asarray(t) for t in b) for b in ld]
    if hasattr(ld, "close"):
        ld.close()
    return out


def _native(tmp_path, **kw):
    x, y = _x(64, 3)
    xp, yp = str(tmp_path / "x.npy"), str(tmp_path / "y.npy")
    np.save(xp, x)
    np.save(yp, y)
    return PN.NativeLoader(xp, yp, 16, threads=2, seed=3, device="cpu", **kw)


LOADERS = {
    "BatchLoader": lambda tmp, **kw: PP.BatchLoader(
        *_x(), 16, seed=3, device="cpu", **kw),
    "ChunkedLoader": lambda tmp, **kw: PP.ChunkedLoader(
        *_x(), 8, 2, seed=3, device="cpu", **kw),
    "BootstrapLoader": lambda tmp, **kw: PP.BootstrapLoader(
        *_x(), 8, 3, seed=3, steps_per_epoch=4, device="cpu", **kw),
    "DeviceResidentLoader": lambda tmp, **kw: PP.DeviceResidentLoader(
        *_x(), 16, seed=3, device="cpu", **kw),
    "DeviceResidentLoader_blocks": lambda tmp, **kw: PP.DeviceResidentLoader(
        *_x(), 16, seed=3, block_shuffle=4, device="cpu", **kw),
    "NativeLoader": _native,
}


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_local_indices_partition_global_batch(name, tmp_path):
    """Every process draws the global permutation and takes its contiguous
    part of each batch's last batch axis: the parts of ranks 0 and 1
    side by side are the 1-process batch, epoch after epoch."""
    make = functools.partial(LOADERS[name], tmp_path)
    whole = _batches(make, 0, 1)
    parts = [_batches(make, r, 2) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 2
    axis = 0 if whole[0][0].ndim == 2 else 1
    for g, p0, p1 in zip(whole, *parts):
        for a, b0, b1 in zip(g, p0, p1):
            assert b0.shape[axis] == a.shape[axis] // 2
            np.testing.assert_array_equal(
                np.concatenate([b0, b1], axis=axis), a)
    ld = PP.BatchLoader(*_x(), 16, seed=3, rules=_rules(2, 1))
    idx = next(ld._index_stream())
    np.testing.assert_array_equal(ld.local_indices(idx), idx[8:])


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_global_batch_size_must_divide(name, tmp_path):
    """A global batch the ranks cannot split raises, and so does a rank
    outside the world."""
    make = functools.partial(LOADERS[name], tmp_path)
    with pytest.raises(ValueError):
        make(rules=_rules(3, 0))
    with pytest.raises(ValueError):
        make(rules=_rules(2, 2))


def test_remainder_batches_refused_over_processes():
    with pytest.raises(ValueError, match="drop_remainder"):
        PP.BatchLoader(*_x(), 16, rules=_rules(2, 0), drop_remainder=False)


def test_mesh_refusals_and_placements():
    with pytest.raises(ValueError, match="model axis of 2 does not divide"):
        PM.Mesh(1, 0, torch.device("cpu"), None, 2)
    if not dist.is_initialized():
        with pytest.raises(RuntimeError, match="process group"):
            PM.make_mesh(num_data=1, num_model=2, device="cpu")
        with pytest.raises(RuntimeError, match="process group"):
            PM.make_mesh(device="cpu")
    rules = PM.ShardingRules(PM.Mesh(4, 2, torch.device("cpu"), None))
    a = np.arange(8 * 3).reshape(8, 3)      # rank 2 of 4: rows 4 and 5
    np.testing.assert_array_equal(rules.local(a, rules.batch), a[4:6])
    np.testing.assert_array_equal(rules.local(a.T, rules.chunk), a.T[:, 4:6])
    np.testing.assert_array_equal(rules.local(a.T, rules.ensemble_batch),
                                  a.T[:, 4:6])
    with pytest.raises(ValueError):
        rules.local(a.T, rules.batch)        # 3 rows over 4 ranks


def test_torchrun_env_absent_does_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert PM.distributed_init_if_needed("gloo") is False


@pytest.fixture()
def one_rank(tmp_path):
    """A 1-rank gloo group in this process, torn down after the test."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        yield PM.ShardingRules(PM.make_mesh(num_data=1, device="cpu"))
    finally:
        dist.destroy_process_group()


def test_one_rank_steps_are_the_steps_without_rules(one_rank, tmp_path):
    """At world size 1 the DDP step, the explicit all-reduce step, eval,
    predict and the loaders are the ones without rules, bit for bit; a
    1-rank DistributedCheckpointer restores the state bit for bit and
    lists committed steps only."""
    rules = one_rank
    x, y = R.data()
    w = R.mlp_init()
    runs = {}
    for name in ("plain", "ddp", "explicit"):
        tr = R.mlp(None if name == "plain" else rules, w)
        step = (make_shardmap_train_step(tr.loss_fn, tr.optimizer, rules)
                if name == "explicit" else tr.train_step)
        ld = PP.BatchLoader(x, y, 64, None if name == "plain" else rules,
                            seed=7, device="cpu")
        runs[name] = (R.run_steps(tr, step, ld), R.params(tr.model), tr)
    for name in ("ddp", "explicit"):
        assert runs[name][0] == runs["plain"][0]
        for k, v in runs["plain"][1].items():
            torch.testing.assert_close(runs[name][1][k], v, rtol=0, atol=0)
    plain, ddp = runs["plain"][2], runs["ddp"][2]
    xt, yt = torch.from_numpy(x[:64]), torch.from_numpy(y[:64])
    assert float(ddp.eval_step(ddp.model, xt, yt)["loss"]) == float(
        plain.eval_step(plain.model, xt, yt)["loss"])
    np.testing.assert_array_equal(ddp.predict(ddp.model, x[:70], 32),
                                  plain.predict(plain.model, x[:70], 32))

    ck = DistributedCheckpointer(str(tmp_path / "dcp"))
    ck.save(ddp.state.step, ddp.state)
    os.makedirs(tmp_path / "dcp" / "step_9")          # an uncommitted write
    os.makedirs(tmp_path / "dcp" / "step_x")
    ck.wait()
    assert ck.steps() == [4]
    fresh = R.mlp(None, w)
    got = ck.restore(fresh.state)
    assert got.step == 4 and got.lr_scale == ddp.state.lr_scale
    for k, v in R.params(ddp.model).items():
        torch.testing.assert_close(got.params.state_dict()[k], v, rtol=0,
                                   atol=0)
    for a, b in zip(got.opt_state.state.values(),
                    ddp.state.opt_state.state.values()):
        for n in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)
    assert torch.equal(got.rng.get_state(), ddp.state.rng.get_state())


def test_one_rank_rpn_and_replicas_are_the_runs_without_rules(one_rank):
    """The RPN ensemble's step (its gradients and losses through one
    all-reduce) and multi-seed replicas (each its own DDP wrapper) at
    world size 1: bit-equal to the same runs without rules."""
    from climsim_tpu_torch.norms import identity_norms
    from climsim_tpu_torch.train import multiseed as PMS
    from climsim_tpu_torch.train import recipes as PR
    from climsim_tpu_torch.train.rpn_recipe import rpn_trainer

    rules = one_rank
    x, y = R.data()
    norms = identity_norms(R.SPEC)
    out = {}
    for arm in ("plain", "rules"):
        r = None if arm == "plain" else rules
        rpn = rpn_trainer(R.SPEC, norms, None, 0, ensemble_size=3,
                          hidden=(16,), compute_dtype=torch.float32,
                          rules=r, device="cpu")
        ld = PP.BootstrapLoader(x, y, 32, 3, rules=r, steps_per_epoch=3,
                                device="cpu")
        rl = [rpn.train_step(xb, yb) for xb, yb in ld]
        ms = PMS.multiseed(PR.mlp_trainer, R.SPEC, norms, None, [0, 1],
                           rules=r, hidden=(16,), compute_dtype=torch.float32,
                           device="cpu")
        state, ml = ms.state, []
        for xb, yb in PP.BatchLoader(x, y, 64, r, seed=1, device="cpu"):
            state, m = ms.train_step(state, xb, yb)
            ml.append(m["loss"])
        out[arm] = (torch.stack(rl), rpn.ensemble.state_dict(),
                    torch.stack(ml), [p.state_dict() for p in state.params])
    p, q = out["plain"], out["rules"]
    for a, b in ((p[0], q[0]), (p[2], q[2])):
        torch.testing.assert_close(b, a, rtol=0, atol=0)
    for a, b in zip([p[1], *p[3]], [q[1], *q[3]]):
        for k, v in a.items():
            torch.testing.assert_close(b[k], v, rtol=0, atol=0)


_UNET = dict(model_channels=8, channel_mult=(1,), num_blocks=1)
RECIPES = {   # varspec, trainer keywords (tiny widths)
    "mlp_trainer": ("v1", dict(hidden=(16,))),
    "mlp_v2_trainer": ("v1", dict(hidden=(16, 16))),
    "ed_trainer": ("v1", {}),
    "online_mlp_trainer": ("v2_rh", dict(hidden=(16,))),
    "cnn_trainer": ("v1", dict(depth=2, channels=8)),
    "hsr_trainer": ("v1", dict(hidden=16, layers=1)),
    "cvae_trainer": ("v1", dict(latent=4, hidden=16, layers=1)),
    "unet_trainer": ("v5", dict(model_kw=_UNET)),
    "unet_classifier_trainer": ("v5", dict(model_kw=_UNET)),
}


@pytest.mark.parametrize("name", sorted(RECIPES))
def test_one_rank_recipes_are_the_runs_without_rules(name, one_rank,
                                                     monkeypatch):
    """Every recipe's steps (HSR's two stages) through its DDP wrapper at
    world size 1: bit-equal to the steps without rules.  Only HSR's
    wrapper searches for unused parameters; its MSE stage without that
    search makes DDP raise at the next step."""
    from climsim_tpu_torch import get_varspec, load_asset_norms
    from climsim_tpu_torch.norms import identity_norms
    from climsim_tpu_torch.train import recipes as PR

    vs, kw = RECIPES[name]
    spec = get_varspec(vs)
    norms = load_asset_norms("v5") if vs == "v5" else identity_norms(spec)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((32, spec.input_len))
                         .astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((32, spec.output_len))
                         .astype(np.float32))
    out, w = {}, None
    for arm in ("plain", "rules"):
        tr = getattr(PR, name)(spec, norms, None, 0,
                               rules=None if arm == "plain" else one_rank,
                               device="cpu", **kw)
        w = w or R.params(tr.model)
        tr.model.load_state_dict(w)
        steps = [tr.train_step] * 2 + [tr.stage2_step] * (
            2 if tr.stage2_step else 0)
        state, losses = tr.state, []
        for step in steps:
            state, m = step(state, x, y)
            losses.append(float(m["loss"]))
        out[arm] = (losses, R.params(tr.model))
        wrapper = one_rank._wrapped.get(id(tr.model))
        if wrapper is not None:
            assert wrapper.find_unused_parameters == (name == "hsr_trainer")
    assert out["rules"][0] == out["plain"][0]
    for k, v in out["plain"][1].items():
        torch.testing.assert_close(out["rules"][1][k], v, rtol=0, atol=0)
    if name == "hsr_trainer":   # the MSE stage without the search
        real = PR.make_train_step
        monkeypatch.setattr(PR, "make_train_step", lambda *a, **k: real(
            *a, **dict(k, unused_parameters=False)))
        tr = PR.hsr_trainer(spec, norms, None, 0, rules=one_rank,
                            device="cpu", **kw)
        with pytest.raises(RuntimeError, match="find_unused_parameters"):
            state = tr.state
            for _ in range(2):
                state, _ = tr.train_step(state, x, y)


def _spawn(case, tmp_path, inp, world=2, timeout=240):
    """Run ``case`` on ``world`` ranks; returns each rank's results."""
    path = str(tmp_path / "in.pt")
    torch.save(inp, path)
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dp_ranks.py"), case,
         str(r), str(world), str(tmp_path / "store"), path,
         str(tmp_path / f"out{r}.pt")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            assert p.returncode == 0, out[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [torch.load(str(tmp_path / f"out{r}.pt"), weights_only=False)
            for r in range(world)]


def test_two_ranks_mlp_match_one_process_and_jax(tmp_path, monkeypatch):
    """2 ranks of mlp_trainer (hidden (32, 32), 4 steps, global batch 64,
    tests/test_multihost.py:141-168): the ranks' losses equal; within
    rtol 1e-6 of the port's 1-process run on the same global batches,
    which is within rtol 1e-5 of JAX's mlp_trainer from the same weights;
    the DDP step and the explicit all-reduce step within rtol 1e-6 of
    each other; eval and predict the 1-process ones."""
    x, y = R.data()
    spec = jax_varspec("v1")
    monkeypatch.setattr("climsim_tpu.models.ClimSimMLP", functools.partial(
        FlaxClimSimMLP, compute_dtype=jnp.float32))
    jt = JR.mlp_trainer(spec, jax_identity_norms(spec), (x, y),
                        jax.random.PRNGKey(0), hidden=(32, 32),
                        steps_per_epoch=4)
    w = port_flax_mlp(jax.tree.map(np.asarray, jt.state.params))
    ranks = _spawn("mlp", tmp_path, {"weights": w})

    tr = R.mlp(None, w)
    single = R.run_steps(tr, tr.train_step, PP.BatchLoader(
        x, y, 64, seed=7, device="cpu"))
    js, jax_losses = jt.state, []
    for xb, yb in JaxBatchLoader(x, y, batch_size=64, seed=7):
        js, m = jt.train_step(js, xb, yb)
        jax_losses.append(float(m["loss"]))
    np.testing.assert_allclose(single, jax_losses, rtol=1e-5)

    for name in ("ddp", "explicit"):
        assert len(ranks[0][name]) == 4 and np.isfinite(ranks[0][name]).all()
        np.testing.assert_allclose(ranks[0][name], ranks[1][name], rtol=0,
                                   atol=0)
        np.testing.assert_allclose(ranks[0][name], single, rtol=1e-6)
        for k, v in ranks[0][name + "_params"].items():
            torch.testing.assert_close(ranks[1][name + "_params"][k], v,
                                       rtol=0, atol=0)
            torch.testing.assert_close(v, tr.model.state_dict()[k],
                                       rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(ranks[0]["ddp"], ranks[0]["explicit"],
                               rtol=1e-6)
    fresh = R.mlp(None, w)
    want = float(fresh.eval_step(fresh.model, torch.from_numpy(x[:64]),
                                 torch.from_numpy(y[:64]))["loss"])
    for r in ranks:
        np.testing.assert_allclose(r["eval"], want, rtol=1e-6)
        np.testing.assert_allclose(r["predict"], fresh.predict(
            fresh.model, x[:70], 32), rtol=1e-6, atol=1e-6)


def test_two_ranks_hsr_across_its_stage_boundary(tmp_path):
    """HSR under DDP: 2 MSE steps (its log-precision net unused: DDP's
    reducer must know, and F6's zero gradients must leave every rank's
    Adam equal), then 2 NLL steps through stage2_step on the same
    reducer; the ranks equal, within rtol 1e-6 of 1 process."""
    w = R.hsr(None).model.state_dict()
    ranks = _spawn("hsr", tmp_path, {"weights": w})
    x, y = R.data()
    tr = R.hsr(None, w)
    single = R.run_steps(tr, tr.train_step, PP.BatchLoader(
        x, y, 64, seed=7, device="cpu"), 2, tr.stage2_step)
    assert len(single) == 4
    np.testing.assert_allclose(ranks[0]["losses"], ranks[1]["losses"],
                               rtol=0, atol=0)
    np.testing.assert_allclose(ranks[0]["losses"], single, rtol=1e-6)
    for k, v in ranks[0]["params"].items():
        torch.testing.assert_close(ranks[1]["params"][k], v, rtol=0, atol=0)
        torch.testing.assert_close(v, tr.model.state_dict()[k], rtol=1e-5,
                                   atol=1e-7)


def test_two_ranks_run_experiment_and_checkpoint(tmp_path, monkeypatch):
    """run_experiment at train.num_data_shards=2 against =1, the mlp recipe
    at float32 compute (torch_dp_ranks.float32_mlp says why): the epochs'
    train and validation losses within rtol 1e-6; rank 0 alone wrote the
    top-K checkpoints.  The state the 2 ranks saved through
    DistributedCheckpointer restores into 1 process bit-equal to rank
    0's live parameters, optimizer moments, step and generator."""
    cfg = PRESETS["mlp_v1"].override(
        'model_kw={"hidden": [16]}', "train.epochs=2",
        "data.num_synthetic=512", "data.batch_size=64")
    ckpt = tmp_path / "ckpt"
    ranks = _spawn("run", tmp_path, {
        "config": json.loads(cfg.to_json()), "ckpt": str(ckpt),
        "dcp": str(tmp_path / "dcp")})
    monkeypatch.setattr(R.recipes, "mlp_trainer", R.recipes.mlp_trainer)
    R.float32_mlp()
    one = PRUN.run_experiment(cfg, verbose=False, device="cpu")
    want = [(r["train_loss"], r["val_loss"]) for r in one["history"].rows]
    assert ranks[0]["history"] == ranks[1]["history"]
    np.testing.assert_allclose(ranks[0]["history"], want, rtol=1e-6)
    assert (ckpt / "topk.json").exists() and (ckpt / "last.pt").exists()
    assert (ckpt / "run_manifest.json").exists()

    ck = DistributedCheckpointer(str(tmp_path / "dcp"))
    assert ck.steps() == [ranks[0]["step"]]
    tmpl = PRUN.build_trainer(cfg, one["spec"], one["stats"], None, 99,
                              None, 1, one["grid"], False, "cpu").state
    got = ck.restore(tmpl)
    assert got.step == ranks[0]["step"]
    for k, v in ranks[0]["params"].items():
        torch.testing.assert_close(got.params.state_dict()[k], v, rtol=0,
                                   atol=0)
    for a, b in zip(got.opt_state.state.values(), ranks[0]["opt"].values()):
        for n in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(a[n], b[n], rtol=0, atol=0)
    assert torch.equal(got.rng.get_state(), ranks[0]["rng"])
