"""The port's elastic training (train.elastic) in one process, on the CPU:
the counterparts of tests/test_elastic.py's cases that have a meaning
with one process a device (the spawned and agent-driven cases are in
tests/test_torch_elastic_ranks.py).

Oracles: a run that fails mid-epoch and recovers is the uninterrupted
run, bit for bit (the interrupted epoch replays from its host snapshot
with the same batches, on the same device); it is within rtol 1e-4 /
atol 1e-6 (tests/test_elastic.py's bound) of JAX's elastic_fit on one
CPU device with the same injector, from the same weights; ``set_epoch``
replay is exact; a checkpointer-backed run resumes from the last
committed epoch.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import models as JM
from climsim_tpu.data.pipeline import BatchLoader as JaxBatchLoader
from climsim_tpu.models import ClimSimMLP as FlaxClimSimMLP
from climsim_tpu.norms import identity_norms as jax_identity_norms
from climsim_tpu.train import elastic as JE
from climsim_tpu.train import recipes as JR
from climsim_tpu.varspec import get_varspec as jax_varspec
from climsim_tpu_torch import run as PRUN
from climsim_tpu_torch.config import PRESETS
from climsim_tpu_torch.data import pipeline as PP
from climsim_tpu_torch.train import elastic as PE
from climsim_tpu_torch.train.checkpoints import DistributedCheckpointer
from climsim_tpu_torch.utils.migrate import port_flax_mlp

import torch_dp_ranks as R

CPU = torch.device("cpu")


def injector(at=(1, 1), error=None):
    """Raise ``error`` (a DeviceFailure) once, before step ``at``."""
    fired = []

    def inject(epoch, step):
        if (epoch, step) == at and not fired:
            fired.append(1)
            raise error or PE.DeviceFailure("simulated loss")

    inject.fired = fired
    return inject


def same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k, v in a.items():
        torch.testing.assert_close(b[k], v, rtol=0, atol=0, msg=k)


def test_probe_and_mesh_sizing():
    assert PE.probe_devices([CPU]) == [CPU]
    # no CUDA here: the default candidates are none, and a CUDA device
    # fails its probe; nothing falls back to the CPU
    assert PE.probe_devices() == [] if not torch.cuda.is_available() else True
    if not torch.cuda.is_available():
        assert PE.probe_devices(["cuda:0", CPU], timeout=10) == [CPU]
    assert PE.usable_data_size(8, 1, 128) == 8
    assert PE.usable_data_size(5, 1, 128) == 4
    assert PE.usable_data_size(7, 2, 96) == 3
    with pytest.raises(ValueError):
        PE.usable_data_size(0, 1, 128)
    assert PE.usable_model_size(8, 8) == 8
    assert PE.usable_model_size(5, 8) == 4
    assert PE.usable_model_size(3, 8) == 2
    with pytest.raises(ValueError):
        PE.usable_model_size(0, 8)
    for n, m, b in ((8, 1, 128), (5, 1, 128), (7, 2, 96), (3, 1, 7)):
        assert PE.usable_data_size(n, m, b) == JE.usable_data_size(n, m, b)
    for n, e in ((8, 8), (5, 8), (3, 8), (6, 4)):
        assert PE.usable_model_size(n, e) == JE.usable_model_size(n, e)


def test_is_device_error_has_no_catch_all():
    """CUDA, accelerator and NCCL / backend errors by type and message;
    a bug is not one, though its message names a device."""
    yes = [PE.DeviceFailure(), torch.distributed.DistBackendError("x"),
           RuntimeError("CUDA error: an illegal memory access was "
                        "encountered"),
           RuntimeError("NCCL error in: ProcessGroupNCCL.cpp, unhandled "
                        "cuda error (run with NCCL_DEBUG=INFO)"),
           RuntimeError("CUDA error: unspecified launch failure")]
    if hasattr(torch, "AcceleratorError"):
        yes.append(torch.AcceleratorError.__new__(torch.AcceleratorError))
    no = [ValueError("bad shape"), RuntimeError("expected all tensors to be "
                                                "on the same device"),
          KeyError("device"), RuntimeError("dma")]
    assert all(PE._is_device_error(e) for e in yes)
    assert not any(PE._is_device_error(e) for e in no)


def test_set_epoch_replays_exactly():
    x, y = R.data()
    loader = PP.BatchLoader(x, y, 64, seed=7, device="cpu")
    epochs = [[xb[:, 0].clone() for xb, _ in loader] for _ in range(2)]
    loader.set_epoch(1)
    for a, (b, _) in zip(epochs[1], loader):
        torch.testing.assert_close(b[:, 0], a, rtol=0, atol=0)
    dl = PP.DeviceResidentLoader(x, y, 64, seed=3, device="cpu")
    e0 = [xb[:, 0].clone() for xb, _ in dl]
    list(dl)
    dl.set_epoch(0)
    for a, (b, _) in zip(e0, dl):
        torch.testing.assert_close(b[:, 0], a, rtol=0, atol=0)


@functools.lru_cache(maxsize=None)
def _jax_run(fail):
    """JAX's elastic_fit on one CPU device: mlp_trainer (float32, hidden
    (32, 32)) over its BatchLoader, 3 epochs, a DeviceFailure at epoch 1
    step 1 when ``fail``.  Returns the initial weights ported, the final
    ones and the report."""
    spec = jax_varspec("v1")
    x, y = R.data()
    JM.ClimSimMLP = functools.partial(FlaxClimSimMLP,
                                      compute_dtype=jnp.float32)
    try:
        def tf(rules):
            return JR.mlp_trainer(spec, jax_identity_norms(spec), (x, y),
                                  jax.random.PRNGKey(0), rules=rules,
                                  hidden=(32, 32), steps_per_epoch=4)

        def lf(rules):
            return JaxBatchLoader(x, y, 64, rules=rules, seed=7), None

        w0 = port_flax_mlp(jax.tree.map(np.asarray, tf(None).state.params))
        state, rep = JE.elastic_fit(tf, lf, 3, devices=jax.devices()[:1],
                                    fused=False,
                                    fault_injector=injector(
                                        error=JE.DeviceFailure("loss"))
                                    if fail else None)
    finally:
        JM.ClimSimMLP = FlaxClimSimMLP
    return w0, port_flax_mlp(jax.tree.map(np.asarray, state.params)), rep


def test_one_process_recovery_is_the_uninterrupted_run():
    """A DeviceFailure at epoch 1, step 1: the trainer and loader are
    rebuilt, the snapshot restored, epoch 1 replayed; the run is the
    uninterrupted one bit for bit (parameters, Adam, step, generator,
    epoch losses), and within JAX's bound of JAX's elastic_fit with the
    same injector."""
    w0, jax_w, jax_rep = _jax_run(True)
    tf, lf = R.elastic_factories(w0)
    clean, rep_c = PE.elastic_fit(tf, lf, 3, device="cpu")
    assert rep_c.failures == 0 and rep_c.mesh_history == [(1, 1)]
    inject = injector()
    state, rep = PE.elastic_fit(tf, lf, 3, device="cpu",
                                fault_injector=inject)
    assert inject.fired and rep.failures == 1 and rep.epochs_completed == 3
    assert rep.mesh_history == [(1, 1), (1, 1)]
    assert len(rep.recovery_seconds) == 1
    assert rep.epoch_losses == rep_c.epoch_losses
    same(R.params(clean.params), R.params(state.params))
    for a, b in zip(clean.opt_state.state.values(),
                    state.opt_state.state.values()):
        for n in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(b[n], a[n], rtol=0, atol=0)
    assert state.step == clean.step == 12
    assert torch.equal(state.rng.get_state(), clean.rng.get_state())
    assert jax_rep.failures == 1
    np.testing.assert_allclose(rep.epoch_losses, jax_rep.epoch_losses,
                               rtol=1e-4)
    for k, v in jax_w.items():
        np.testing.assert_allclose(state.params.state_dict()[k].numpy(),
                                   v.numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_fused_runner_path_recovers_bit_equal():
    """DeviceResidentLoader's epoch runner under elastic_fit (the fault
    raised before the runner's call): bit-equal to the clean run."""
    x, y = R.data()
    w = R.mlp_init()

    def lf(rules):
        return PP.DeviceResidentLoader(x, y, 64, rules, seed=0,
                                       device="cpu"), None

    tf = R.elastic_factories(w)[0]
    clean, _ = PE.elastic_fit(tf, lf, 3, device="cpu")
    inject = injector(at=(1, 0))
    state, rep = PE.elastic_fit(tf, lf, 3, device="cpu",
                                fault_injector=inject)
    assert inject.fired and rep.failures == 1
    same(R.params(clean.params), R.params(state.params))


def test_max_failures_lost_device_and_real_errors():
    """A flapping card gives up after max_failures recoveries; a
    DeviceFailure that names this process's device leaves no device and
    raises; an error that is not a device's propagates at once; a model
    axis in one process is refused."""
    tf, lf = R.elastic_factories(R.mlp_init())

    def always(epoch, step):
        raise PE.DeviceFailure("flapping")

    with pytest.raises(PE.DeviceFailure):
        PE.elastic_fit(tf, lf, 2, device="cpu", fault_injector=always,
                       max_failures=2)
    with pytest.raises(RuntimeError, match="no healthy devices"):
        PE.elastic_fit(tf, lf, 2, device="cpu", fault_injector=injector(
            error=PE.DeviceFailure(lost=[CPU])))
    with pytest.raises(ValueError, match="bug"):
        PE.elastic_fit(tf, lf, 2, device="cpu",
                       fault_injector=injector(error=ValueError("bug")))
    with pytest.raises(ValueError, match="torchrun"):
        PE.elastic_fit(tf, lf, 2, device="cpu", num_model=2)


class _FailingOnce:
    """A validation loader whose iteration fails once, in epoch ``at``."""

    def __init__(self, loader, at):
        self.loader, self.at, self.epoch, self.fired = loader, at, 0, False

    def __iter__(self):
        e, self.epoch = self.epoch, self.epoch + 1
        if e == self.at and not self.fired:
            self.fired = True
            raise PE.DeviceFailure("lost during validation")
        return iter(self.loader)


def test_validation_only_failure_commits_the_epoch():
    """A failure during validation keeps the epoch's training: the epoch
    is committed with val = nan, not replayed, and the run is the clean
    run bit for bit."""
    x, y = R.data()
    w = R.mlp_init()
    tf = R.elastic_factories(w)[0]
    val = PP.BatchLoader(x[:64], y[:64], 64, shuffle=False, device="cpu")

    def lf_clean(rules):
        return PP.BatchLoader(x, y, 64, rules, seed=7, device="cpu"), val

    failing = []

    def lf(rules):
        ld = _FailingOnce(val, 1) if not failing else val
        failing.append(ld)
        return PP.BatchLoader(x, y, 64, rules, seed=7, device="cpu"), ld

    clean, rep_c = PE.elastic_fit(tf, lf_clean, 3, device="cpu")
    state, rep = PE.elastic_fit(tf, lf, 3, device="cpu")
    assert failing[0].fired and rep.failures == 1
    assert rep.epochs_completed == 3 and len(rep.epoch_losses) == 3
    assert np.isnan(rep.val_losses[1])
    assert rep.val_losses[0] == rep_c.val_losses[0]
    assert rep.val_losses[2] == rep_c.val_losses[2]
    assert rep.epoch_losses == rep_c.epoch_losses
    same(R.params(clean.params), R.params(state.params))


def test_checkpointer_resume_in_one_process(tmp_path):
    """A checkpointed 2-epoch run, then a fresh call with the same
    directory and 4 epochs: it resumes at epoch 2 (the report, read
    beside the checkpoint, spans both calls) and ends bit-equal to the
    uninterrupted 4-epoch run."""
    tf, lf = R.elastic_factories(R.mlp_init())
    ck = DistributedCheckpointer(str(tmp_path / "ck"))
    _, rep1 = PE.elastic_fit(tf, lf, 2, device="cpu", checkpointer=ck)
    assert ck.steps() == [1, 2]
    state, rep = PE.elastic_fit(tf, lf, 4, device="cpu",
                                checkpointer=DistributedCheckpointer(
                                    str(tmp_path / "ck")))
    assert rep.epochs_completed == 4 and len(rep.epoch_losses) == 4
    assert rep.epoch_losses[:2] == rep1.epoch_losses
    assert rep.mesh_history == [(1, 1), (1, 1)]
    clean, rep_c = PE.elastic_fit(tf, lf, 4, device="cpu")
    assert rep.epoch_losses == rep_c.epoch_losses
    same(R.params(clean.params), R.params(state.params))
    assert state.step == clean.step


def test_rpn_one_process_recovery():
    """elastic_rpn_fit in one process: a failure mid-epoch restores the
    members, priors and Adam from the snapshot; bit-equal to the clean
    run."""
    rf, lf = R.rpn_factories()
    clean, rep_c = PE.elastic_rpn_fit(rf, lf, 2, 4, device="cpu")
    assert rep_c.mesh_history == [(1, 1)]
    inject = injector(at=(1, 2))
    tr, rep = PE.elastic_rpn_fit(rf, lf, 2, 4, device="cpu",
                                 fault_injector=inject)
    assert inject.fired and rep.failures == 1
    assert rep.epoch_losses == rep_c.epoch_losses
    same(R.params(clean.ensemble), R.params(tr.ensemble))
    assert tr.step == clean.step == 6


def test_run_experiment_elastic(tmp_path):
    """train.elastic=true through run_experiment: elastic_fit over the
    build_trainer and BatchLoader factories, its history numbered from
    the report, a checkpoint a committed epoch in <dir>/elastic; a rerun
    with more epochs resumes; HSR's staged loss and a warm restart are
    refused."""
    cfg = PRESETS["mlp_v1"].override(
        'model_kw={"hidden": [16]}', "train.epochs=2",
        "data.num_synthetic=512", "data.batch_size=64", "train.elastic=true",
        f'train.checkpoint_dir="{tmp_path}"')
    out = PRUN.run_experiment(cfg, verbose=False, device="cpu")
    rep = out["report"]
    assert rep.epochs_completed == 2 and rep.failures == 0
    assert [r["epoch"] for r in out["history"].rows] == [0, 1]
    assert np.isfinite(out["history"].rows[-1]["train_loss"])
    assert DistributedCheckpointer(str(tmp_path / "elastic")).steps() == [1,
                                                                          2]
    more = PRUN.run_experiment(cfg.override("train.epochs=3"), verbose=False,
                               device="cpu")
    assert [r["epoch"] for r in more["history"].rows] == [0, 1, 2]
    assert more["history"].rows[:2] == out["history"].rows
    with pytest.raises(ValueError, match="staged loss"):
        PRUN.run_experiment(cfg.override('model="hsr"'), verbose=False,
                            device="cpu")
    with pytest.raises(ValueError, match="restart_path"):
        PRUN.run_experiment(cfg.override(f'train.restart_path="{tmp_path}"'),
                            verbose=False, device="cpu")
