"""The port's model axis (parallel.mesh at num_model > 1, the loaders under
a (data, model) mesh, the RPN's members and multi-seed replicas split over
ranks) on the CPU over gloo.

In-process: the placements over both axes, pad_to_multiple against the
JAX package's, and BootstrapLoader's split against the 1-process draws,
sliced.  Spawned (tests/torch_dp_ranks.py, ranks through a FileStore):
make_mesh's coordinates and groups, the RPN over (1, 2) and (2, 2) and a
2-seed multiseed over (1, 2), against the port's 1-process runs and the
JAX package's on a mesh of its virtual CPU devices.

Tolerances: a model axis alone, (1, 2), changes no member's operations,
so it is bit-equal to 1 process; (2, 2) splits each member's batch too,
so it is bit-equal to the (2, 1) run (the same sums, in the same order)
and, like it, within float order of 1 process.  Against JAX: losses rtol
1e-5 and parameters atol 2e-6 (tests/test_torch_zoo_train.py's RPN
parity).
"""

import functools
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
from climsim_tpu.data.pipeline import BootstrapLoader as JaxBootstrapLoader
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import identity_norms as jax_identity_norms
from climsim_tpu.parallel import mesh as JPM
from climsim_tpu.train import multiseed as JMS
from climsim_tpu.train import recipes as JR
from climsim_tpu.train import rpn_recipe as JRR
from climsim_tpu.varspec import get_varspec as jax_varspec
from climsim_tpu_torch.data import pipeline as PP
from climsim_tpu_torch.parallel import mesh as PM
from climsim_tpu_torch.utils.migrate import port_flax_mlp, port_flax_rpn

import torch_dp_ranks as R

HERE = os.path.dirname(os.path.abspath(__file__))
CPU = torch.device("cpu")


def _rules(world, rank, num_model=1):
    """Rank ``rank`` of a ``world``-rank mesh with a model axis of
    ``num_model``, without a process group (the loaders and placements
    read only the coordinates)."""
    return PM.ShardingRules(PM.Mesh(world, rank, CPU, None, num_model))


def spawn(case, tmp_path, inp, world, timeout=180):
    """Run ``case`` of tests/torch_dp_ranks.py on ``world`` ranks."""
    tmp_path.mkdir(parents=True, exist_ok=True)
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


def test_mesh_coordinates_groups_and_refusals(tmp_path):
    """4 ranks: rank d * M + m is at (d, m); its data group holds the ranks
    of its m, its model group those of its d; a mean runs over the data
    group and a gather over the model group, in model order.  A mesh
    over the prefix [0, 1] leaves ranks 2 and 3 out (None).  Refusals: a
    shape that does not cover the ranks, ranks outside the world, a
    model axis that does not divide a Mesh."""
    ranks = spawn("mesh", tmp_path, {}, 4)
    for r, out in enumerate(ranks):
        d, m = divmod(r, 2)
        a = out[(2, 2)]
        assert a["coords"] == (d, m)
        assert a["data"] == [m, m + 2] and a["model"] == [2 * d, 2 * d + 1]
        assert a["mean"] == (m + m + 2) / 2
        assert a["gather"] == [2 * d, -2 * d, 2 * d + 1, -(2 * d + 1)]
        b = out[(1, 4)]
        assert b["coords"] == (0, r) and b["data"] == [r]
        assert b["model"] == [0, 1, 2, 3] and b["mean"] == r
        assert b["gather"] == [v for k in range(4) for v in (k, -k)]
        assert out["prefix"] == ((0, r, [0, 1]) if r < 2 else None)
    with pytest.raises(ValueError, match="divide"):
        PM.Mesh(3, 0, CPU, None, 2)
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "one"), 1), rank=0, world_size=1)
    try:
        with pytest.raises(ValueError, match="2 x 1"):
            PM.make_mesh(2, 1, device="cpu")
        with pytest.raises(ValueError, match="ranks"):
            PM.make_mesh(1, 1, device="cpu", ranks=[1])
        with pytest.raises(ValueError, match="model axis"):
            PM.make_mesh(num_model=2, device="cpu")
        assert PM.make_mesh(1, 1, device="cpu").data_group is not None
    finally:
        dist.destroy_process_group()


def test_placements_over_both_axes_and_pad_to_multiple():
    """Placement.local splits a model-axis dimension by m as a data-axis
    one by d; ShardingRules.split gives the members' range; the rank and
    world size the loaders read are the data axis's.  pad_to_multiple is
    the JAX package's."""
    a = np.arange(4 * 6 * 2).reshape(4, 6, 2)
    for rank in range(6):              # a (3, 2) mesh
        d, m = divmod(rank, 2)
        r = _rules(6, rank, 2)
        assert (r.rank, r.world_size, r.model_rank, r.model_size) == (
            d, 3, m, 2)
        np.testing.assert_array_equal(r.local(a, r.ensemble_batch),
                                      a[2 * m:2 * m + 2, 2 * d:2 * d + 2])
        np.testing.assert_array_equal(r.local(a, r.ensemble),
                                      a[2 * m:2 * m + 2])
        np.testing.assert_array_equal(r.local(a, r.replicated), a)
        np.testing.assert_array_equal(r.local(a[0], r.batch),
                                      a[0, 2 * d:2 * d + 2])
        assert r.split(4) == (2 * m, 2 * m + 2)
        assert r.lead == (rank == 0)
    with pytest.raises(ValueError, match="model"):
        _rules(6, 0, 2).local(a[:3], PM.ENSEMBLE)
    with pytest.raises(ValueError, match="members"):
        _rules(6, 0, 2).split(3)
    for n, k in ((5, 4), (8, 4), (1, 3), (7, 1)):
        x = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
        got, want = PM.pad_to_multiple(x, k), JPM.pad_to_multiple(x, k)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == n


def _x(n=64, d=3):
    x = np.arange(n * d, dtype=np.float32).reshape(n, d)
    return x, -x


def _boot(rules):
    return PP.BootstrapLoader(*_x(), 8, 4, rules=rules, seed=3,
                              steps_per_epoch=3, device="cpu")


def test_bootstrap_loader_split_equals_the_sliced_draws():
    """Over a (2, 2) mesh each rank's (E/2, B/2, D) batches are the
    1-process loader's (E, B, D) batches at its members and rows, epoch
    after epoch and after set_epoch; the ranks that share a data index
    get the same rows of their members.  A member count the model axis
    does not divide raises."""
    whole = _boot(None)
    want = [[xb.numpy().copy() for xb, _ in whole] for _ in range(2)]
    whole.set_epoch(1)
    assert all(np.array_equal(a, b.numpy()) for a, (b, _) in
               zip(want[1], whole))
    for rank in range(4):
        d, m = divmod(rank, 2)
        ld = _boot(_rules(4, rank, 2))
        got = [[xb.numpy().copy() for xb, _ in ld] for _ in range(2)]
        ld.set_epoch(1)
        got.append([xb.numpy().copy() for xb, _ in ld])
        for g, w in zip(got, want + want[1:]):
            assert len(g) == len(w) == 3
            for a, b in zip(g, w):
                np.testing.assert_array_equal(
                    a, b[2 * m:2 * m + 2, 4 * d:4 * d + 4])
    with pytest.raises(ValueError, match="members"):
        PP.BootstrapLoader(*_x(), 8, 3, rules=_rules(4, 0, 2), device="cpu")
    # BatchLoader splits over the data axis only
    for rank in range(4):
        ld = PP.BatchLoader(*_x(), 16, rules=_rules(4, rank, 2), seed=3,
                            device="cpu")
        ref = PP.BatchLoader(*_x(), 16, rules=_rules(2, rank // 2), seed=3,
                             device="cpu")
        for (a, _), (b, _) in zip(ld, ref):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@functools.lru_cache(maxsize=None)
def _jax_rpn(mesh):
    """JAX's rpn_trainer at float32 over a (D, M) mesh of the virtual CPU
    devices (ens_sharding=rules.ensemble), 3 steps over its
    BootstrapLoader: the initial weights ported, the (E,) losses a step,
    the final parameters ported."""
    spec = jax_varspec("v1")
    jrules = JPM.ShardingRules(JPM.make_mesh(
        *mesh, devices=jax.devices()[:mesh[0] * mesh[1]]))
    real = JRR.RPNEnsemble
    JRR.RPNEnsemble = functools.partial(real, compute_dtype=jnp.float32)
    try:
        x, y = R.data()
        jt = JRR.rpn_trainer(spec, jax_identity_norms(spec), x,
                             jax.random.PRNGKey(0), ensemble_size=4,
                             hidden=(16,), ens_sharding=jrules.ensemble)
    finally:
        JRR.RPNEnsemble = real
    w0 = port_flax_rpn(*(jax.tree.map(np.asarray, p)
                         for p in (jt.params, jt.prior)))
    params, opt, losses = jt.params, jt.opt_state, []
    for xb, yb in JaxBootstrapLoader(x, y, 32, 4, rules=jrules, seed=5,
                                     steps_per_epoch=3):
        params, opt, jl = jt.train_step(params, opt, jt.prior, xb, yb)
        losses.append(np.asarray(jl))
    w1 = port_flax_rpn(*(jax.tree.map(np.asarray, p)
                         for p in (params, jt.prior)))
    return w0, np.stack(losses), w1


def _whole(ranks, key="params"):
    """The members of the ranks at data index 0, in model order."""
    d0 = sorted((r for r in ranks if r["coords"][0] == 0),
                key=lambda r: r["first"])
    return {k: torch.cat([r[key][k] for r in d0]) for k in d0[0][key]}


@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
def test_rpn_over_the_model_axis(mesh, tmp_path):
    """The RPN (E = 4, hidden (16,), float32) over ``mesh``: each rank
    keeps E/M members; the gathered (E,) step losses, eval_losses and
    posterior are the same on every rank; (1, 2) is bit-equal to 1
    process, (2, 2) to the (2, 1) run; both within the JAX package's
    tolerance of JAX's rpn_trainer on the same mesh of virtual CPU
    devices, from the same weights."""
    w0, jax_losses, jax_w1 = _jax_rpn(mesh)
    ranks = spawn("rpn", tmp_path / "m", {"mesh": mesh, "weights": w0},
                  mesh[0] * mesh[1])
    if mesh[0] == 1:
        want = R.rpn_run(None, weights=w0)
        want["params"] = {k: v for k, v in want["params"].items()}
    else:
        two = spawn("rpn", tmp_path / "d", {"mesh": (mesh[0], 1),
                                            "weights": w0}, mesh[0])
        want = dict(two[0], params=_whole(two))
    for r in ranks:
        assert r["first"] == 4 // mesh[1] * r["coords"][1]
        assert all(v.shape[0] == 4 // mesh[1] for v in r["params"].values())
        for k in ("losses", "eval", "posterior"):
            torch.testing.assert_close(r[k], want[k], rtol=0, atol=0)
    got = _whole(ranks)
    for k, v in want["params"].items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    np.testing.assert_allclose(ranks[0]["losses"].numpy(), jax_losses,
                               rtol=1e-5)
    for k, v in jax_w1.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=2e-6, err_msg=k)


def test_multiseed_over_the_model_axis(tmp_path, monkeypatch):
    """2 seeds of mlp_trainer over (1, 2): each rank builds one replica;
    the gathered (K,) losses and predict are the 1-process ones, bit for
    bit, and each replica's parameters too; within rtol 1e-5 / atol 2e-6
    of JAX's multiseed(rules=...) on a (1, 2) mesh from the same
    weights."""
    spec = jax_varspec("v1")
    monkeypatch.setattr("climsim_tpu.models.ClimSimMLP", functools.partial(
        FlaxClimSimMLP, compute_dtype=jnp.float32))
    jrules = JPM.ShardingRules(JPM.make_mesh(1, 2,
                                             devices=jax.devices()[:2]))
    x, y = R.data()
    jms = JMS.multiseed(JR.mlp_trainer, spec, jax_identity_norms(spec),
                        (x, y), seeds=[0, 1], rules=jrules, hidden=(16,),
                        steps_per_epoch=2)
    weights = [port_flax_mlp(jax.tree.map(np.asarray, p))
               for p in jms.unstack_params()]
    state, jl = jms.state, []
    for i, (xb, yb) in enumerate(JaxBatchLoader(x, y, 64, seed=3)):
        if i == 2:
            break
        state, m = jms.train_step(state, xb, yb)
        jl.append(np.asarray(m["loss"]))
    jw = [port_flax_mlp(jax.tree.map(np.asarray, p))
          for p in jms.unstack_params(state.params)]

    ranks = spawn("multiseed", tmp_path, {"mesh": (1, 2),
                                          "weights": weights}, 2)
    one = R.multiseed_run(None, weights=weights)
    for r in ranks:
        assert len(r["params"]) == 1
        torch.testing.assert_close(r["losses"], one["losses"], rtol=0,
                                   atol=0)
        torch.testing.assert_close(r["predict"], one["predict"], rtol=0,
                                   atol=0)
        for k, v in r["params"][0].items():
            torch.testing.assert_close(v, one["params"][r["first"]][k],
                                       rtol=0, atol=0)
            np.testing.assert_allclose(v.numpy(), jw[r["first"]][k].numpy(),
                                       rtol=0, atol=2e-6, err_msg=k)
    np.testing.assert_allclose(one["losses"].numpy(), np.stack(jl),
                               rtol=1e-5)
