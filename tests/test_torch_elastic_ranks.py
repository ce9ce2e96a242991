"""The port's elastic training under a process group, on the CPU over
gloo: ranks spawned through a FileStore (tests/torch_dp_ranks.py) that
fail and are relaunched at another world size, and one run under
torchrun's elastic agent (tests/torch_elastic_worker.py) whose worker
fails on the first attempt.

Under a group a failure ends the workers, and the new ones resume from
the DistributedCheckpointer's last committed epoch.  Oracles: a restart
at the same world size is the uninterrupted run bit for bit; a model
axis of 2 resumed in 1 process is the 1-process run bit for bit (a model
axis alone changes no member's operations); a data axis resumed at
another size is within rtol 1e-4 / atol 1e-6 (tests/test_elastic.py's
bound across mesh sizes) of the 1-process run.
"""

import os
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from climsim_tpu_torch.train import elastic as PE
from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer

import torch_dp_ranks as R
from test_torch_model_axis import spawn

HERE = os.path.dirname(os.path.abspath(__file__))


def same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)


def test_shrink_resumes_on_fewer_ranks(tmp_path):
    """2 ranks commit epoch 0's checkpoint and fail in epoch 1 with no
    restart left; a relaunch on 1 rank resumes at epoch 1 from their
    checkpoint: its report spans both launches (the mesh shrank from
    (2, 1) to (1, 1), epoch 0's loss is theirs, one recovery timed from
    their failure marks), and it ends within the bound of the 1-process
    run."""
    w = R.mlp_init()
    ck = str(tmp_path / "ck")
    inp = {"dir": ck, "epochs": 3, "weights": w}
    first = spawn("elastic", tmp_path / "a", dict(inp, fail=(1, 1)), 2)
    assert all(r == {"failed": True} for r in first)
    assert sorted(f for f in os.listdir(ck) if f.startswith("failed")) == [
        "failed_at.rank0", "failed_at.rank1"]
    (one,) = spawn("elastic", tmp_path / "b", inp, 1)
    rep = one["report"]
    assert [tuple(m) for m in rep["mesh_history"]] == [(2, 1), (1, 1)]
    assert rep["epochs_completed"] == 3 and len(rep["epoch_losses"]) == 3
    assert len(rep["recovery_seconds"]) == 1 and rep["expansions"] == 0
    assert not any(f.startswith("failed") for f in os.listdir(ck))
    assert DistributedCheckpointer(ck).steps() == [1, 2, 3]
    clean, rep_c = PE.elastic_fit(*R.elastic_factories(w), 3, device="cpu")
    for k, v in R.params(clean.params).items():
        torch.testing.assert_close(one["params"][k], v, rtol=1e-4,
                                   atol=1e-6, msg=k)
    torch.testing.assert_close(torch.tensor(rep["epoch_losses"]),
                               torch.tensor(rep_c.epoch_losses), rtol=1e-5,
                               atol=0)


def test_expansion_and_leftover_ranks(tmp_path):
    """1 rank commits epoch 0; a relaunch on 3 ranks sizes its data axis
    to 2 (a global batch of 64 does not split over 3), counts an
    expansion, and its third rank takes no part (its report says idle)."""
    w = R.mlp_init()
    ck = str(tmp_path / "ck")
    inp = {"dir": ck, "epochs": 1, "weights": w}
    spawn("elastic", tmp_path / "a", inp, 1)
    ranks = spawn("elastic", tmp_path / "b", dict(inp, epochs=2), 3)
    for r in ranks[:2]:
        rep = r["report"]
        assert [tuple(m) for m in rep["mesh_history"]] == [(1, 1), (2, 1)]
        assert rep["expansions"] == 1 and rep["epochs_completed"] == 2
        assert not rep["idle"]
    same(ranks[0]["params"], ranks[1]["params"])
    assert ranks[2]["report"]["idle"] and "params" not in ranks[2]


def test_under_a_group_without_checkpointer_raises(tmp_path, monkeypatch):
    """Under a process group a restarted worker resumes from its
    checkpointer, so elastic_fit without one refuses to start, naming the
    argument; and torchrun's --max-restarts above max_failures is
    refused."""
    dist.init_process_group("gloo", store=dist.FileStore(
        str(tmp_path / "one"), 1), rank=0, world_size=1)
    try:
        tf, lf = R.elastic_factories(R.mlp_init())
        with pytest.raises(ValueError, match="checkpointer="):
            PE.elastic_fit(tf, lf, 1, device="cpu")
        with pytest.raises(ValueError, match="checkpointer="):
            PE.elastic_rpn_fit(*R.rpn_factories(), 1, 4, device="cpu")
        monkeypatch.setenv("TORCHELASTIC_MAX_RESTARTS", "5")
        with pytest.raises(ValueError, match="max_failures=3"):
            PE.elastic_fit(tf, lf, 1, device="cpu",
                           checkpointer=DistributedCheckpointer(
                               str(tmp_path / "ck")))
    finally:
        dist.destroy_process_group()


def test_rpn_members_redistribute_from_two_ranks_to_one(tmp_path):
    """elastic_rpn_fit over (1, 2): 2 members a rank, epoch 0 committed,
    then both fail; resumed in 1 process (1, 1), each member restored from
    the checkpoint by its global index: bit-equal to the uninterrupted
    1-process run."""
    ck = str(tmp_path / "ck")
    first = spawn("elastic", tmp_path / "a", {"dir": ck, "epochs": 2,
                                              "rpn": True, "fail": (1, 1)},
                  2)
    assert all(r == {"failed": True} for r in first)
    tr, rep = PE.elastic_rpn_fit(*R.rpn_factories(), 2, 4, device="cpu",
                                 checkpointer=DistributedCheckpointer(ck))
    assert rep.mesh_history == [(1, 2), (1, 1)]
    assert rep.epochs_completed == 2 and len(rep.epoch_losses) == 2
    clean, rep_c = PE.elastic_rpn_fit(*R.rpn_factories(), 2, 4,
                                      device="cpu")
    assert rep.epoch_losses == rep_c.epoch_losses
    same(R.params(clean.ensemble), R.params(tr.ensemble))
    for a, b in zip(clean.opt_state.state.values(),
                    tr.opt_state.state.values()):
        for n in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(b[n], a[n], rtol=0, atol=0)
    assert tr.step == clean.step == 6


def test_multiseed_seed_axis_resumes_in_one_process(tmp_path):
    """A 2-seed multiseed through elastic_fit at num_model=2 on 2 ranks
    (the seed axis split, one replica a rank), epoch 0 committed, then
    resumed in 1 process holding both replicas: bit-equal to the
    uninterrupted 1-process run."""
    from climsim_tpu_torch.norms import identity_norms
    from climsim_tpu_torch.train.multiseed import multiseed

    init = multiseed(R.recipes.mlp_trainer, R.SPEC, identity_norms(R.SPEC),
                     None, [0, 1], hidden=(16,), compute_dtype=torch.float32,
                     device="cpu")
    weights = [R.params(p) for p in init.state.params]
    ck = str(tmp_path / "ck")
    inp = {"dir": ck, "epochs": 2, "weights": weights, "seeds": (0, 1),
           "num_model": 2}
    first = spawn("elastic", tmp_path / "a", dict(inp, fail=(1, 2)), 2)
    assert all(r == {"failed": True} for r in first)
    state, rep = PE.elastic_fit(*R.elastic_factories(weights, (0, 1)), 2,
                                device="cpu",
                                checkpointer=DistributedCheckpointer(ck))
    assert rep.mesh_history == [(1, 2), (1, 1)]
    clean, rep_c = PE.elastic_fit(*R.elastic_factories(weights, (0, 1)), 2,
                                  device="cpu")
    assert rep.epoch_losses == rep_c.epoch_losses
    for a, b in zip(clean.params, state.params):
        same(R.params(a), R.params(b))


def _torchrun(tmp_path, fail, weights, timeout=240):
    env = {**os.environ, "OMP_NUM_THREADS": "1", "GLOO_SOCKET_IFNAME": "lo"}
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
              "LOCAL_RANK"):
        env.pop(k, None)
    p = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "--max-restarts", "1",
         os.path.join(HERE, "torch_elastic_worker.py"), str(tmp_path),
         "1" if fail else "0", weights], capture_output=True, text=True,
        env=env, timeout=timeout)
    assert p.returncode == 0, (p.stdout + p.stderr)[-4000:]
    return torch.load(str(tmp_path / "out.pt"), weights_only=False)


def test_agent_restart_is_the_uninterrupted_run(tmp_path):
    """torchrun --standalone --nproc-per-node 2 --max-restarts 1: rank 1
    fails in epoch 1 on the first attempt, the agent stops rank 0 and
    restarts both, and they resume from epoch 1's checkpoint.  The final
    parameters and the epoch losses are the uninterrupted 2-rank run's,
    bit for bit; the report counts the agent's restart."""
    weights = str(tmp_path / "w.pt")
    torch.save(R.mlp_init(), weights)
    (tmp_path / "clean").mkdir()
    (tmp_path / "fail").mkdir()
    clean = _torchrun(tmp_path / "clean", False, weights)
    got = _torchrun(tmp_path / "fail", True, weights)
    assert clean["report"]["failures"] == 0
    rep = got["report"]
    assert rep["failures"] == 1 and rep["epochs_completed"] == 3
    assert [tuple(m) for m in rep["mesh_history"]] == [(2, 1), (2, 1)]
    assert len(rep["recovery_seconds"]) == 1
    assert rep["epoch_losses"] == clean["report"]["epoch_losses"]
    same(clean["params"], got["params"])
