"""Elastic training: survive device loss at epoch granularity (the
counterpart of ``climsim_tpu.train.elastic``).

The reference has no failure detection or elastic recovery -- its story
is checkpoint and manual warm restart (SURVEY.md section 5.3; restart_path
at train_unet_h5loader.py:177-189).  The JAX package is one controller
that holds every device: it catches the failure, probes the devices and
rebuilds a smaller mesh in flight.  The port is one process a device,
and a dead card takes its process down (a CUDA error is sticky, and
NCCL's communicator aborts), so recovery has two regimes:

  * **One process, no process group.**  Recovery happens in the process,
    as in JAX: on a :class:`DeviceFailure` or an error that
    :func:`_is_device_error` accepts, the trainer and the loaders are
    rebuilt through their factories, the epoch-boundary host snapshot
    (:func:`_snapshot`: state dicts copied to host memory) is loaded onto
    the rebuilt trainer's device with its dtypes (:func:`_restore`), and
    the interrupted epoch replays after ``set_epoch``, batch for batch.
    A failure during validation only commits the epoch with ``val = nan``.
  * **Under a process group (launched by torchrun).**  The worker does
    not recover in the process: the failure ends it (a non-zero exit,
    once the checkpoint in flight is written), torchrun's elastic agent (``--max-restarts N``; ``--nnodes MIN:MAX``
    for a node's loss and return) stops the other workers and restarts
    the group, and the new workers resume from the checkpointer's last
    committed epoch.  The checkpointer (``DistributedCheckpointer``) is
    the snapshot, saved every epoch; the report's mesh history, epoch
    losses and recovery seconds are written beside it (``elastic.json``),
    so the report spans restarts.  A resume onto more ranks than the last
    mesh counts as an expansion: the agent re-rendezvouses when a node
    returns, where JAX re-probes (``reprobe_every``).

Semantics in both: exactly once at epoch granularity -- completed epochs
are never re-run; a partially trained epoch is discarded and replayed
from its start with the same batches.  Sizing: the data axis is the
largest that fits the ranks and divides the global batch
(:func:`usable_data_size`), the model axis the largest that divides the
members (:func:`usable_model_size`); the mesh is built over that prefix
of the ranks, and the ranks left over take no part in the steps and
return after the final barrier.
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import ShardingRules, make_mesh
from .loop import _host as host_losses
from .loop import evaluate

REPORT_FILE = "elastic.json"


class DeviceFailure(RuntimeError):
    """Raised (or injected) when devices are lost mid-run.

    ``lost``: the ``torch.device``s to treat as dead.  A real card's loss
    raises CUDA or NCCL errors instead; those are caught too."""

    def __init__(self, message: str = "device failure", lost=()):
        super().__init__(message)
        self.lost = tuple(torch.device(d) for d in lost)


def probe_devices(candidates=None, timeout: float = 30.0) -> list:
    """Health-check devices; return the survivors.

    Each probe is independent (put, sum, get), and all run concurrently
    in daemon threads against one shared deadline: a failing card often
    hangs rather than raises, so a probe that has not answered after
    ``timeout`` seconds in all marks its device dead.  ``candidates``
    defaults to every CUDA device of this process; nothing falls back to
    the CPU."""
    devs = [torch.device(d) for d in (
        candidates if candidates is not None else
        [f"cuda:{i}" for i in range(torch.cuda.device_count())])]
    ok = [False] * len(devs)

    def _probe(i, dev):
        try:
            x = torch.arange(8, dtype=torch.float32).to(dev)
            if float(x.sum().cpu()) == 28.0:
                ok[i] = True
        except Exception:  # noqa: BLE001 -- any failure marks it dead
            pass

    threads = [threading.Thread(target=_probe, args=(i, d), daemon=True)
               for i, d in enumerate(devs)]
    deadline = time.monotonic() + timeout
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    return [d for i, d in enumerate(devs) if ok[i]]


def usable_data_size(n_devices: int, num_model: int,
                     global_batch: int) -> int:
    """Largest data-axis size that (a) fits the healthy device count and
    (b) evenly shards the global batch."""
    for k in range(n_devices // num_model, 0, -1):
        if global_batch % k == 0:
            return k
    raise ValueError(
        f"no usable mesh: {n_devices} devices, num_model={num_model}, "
        f"batch {global_batch}")


def usable_model_size(n_devices: int, ensemble_size: int) -> int:
    """Largest model-axis size that fits the healthy device count and
    evenly shards the member axis (RPN and seed ensembles)."""
    for m in range(min(n_devices, ensemble_size), 0, -1):
        if ensemble_size % m == 0:
            return m
    raise ValueError(f"no usable model axis: {n_devices} devices for "
                     f"{ensemble_size} members")


@dataclass
class ElasticReport:
    """What happened during an elastic run (for logs and tests).  Under a
    process group it spans the agent's restarts: ``failures`` is
    ``TORCHELASTIC_RESTART_COUNT``, and the rest is read back from the
    checkpoint directory.  ``idle``: this rank was left over by the
    sizing and took no part in the steps."""

    epochs_completed: int = 0
    failures: int = 0
    mesh_history: list = field(default_factory=list)  # [(num_data, num_model)]
    epoch_losses: list = field(default_factory=list)
    val_losses: list = field(default_factory=list)  # aligned w/ epoch_losses
    recovery_seconds: list = field(default_factory=list)
    expansions: int = 0  # resumes onto more ranks than the last mesh
    idle: bool = False


# -- host snapshots (the one-process regime) ----------------------------
def _host(tree):
    """Tensors of a (nested) state dict cloned to host memory."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host(v) for v in tree)
    return tree


def _snapshot(state):
    """Full host copy of a train state: a ``TrainState`` (model,
    optimizer, step, lr_scale, generator), a ``SeedStates`` (each
    replica's) or an ``RPNTrainer`` (the members, their priors, Adam and
    the step)."""
    if hasattr(state, "states"):
        return [_snapshot(s) for s in state.states]
    if hasattr(state, "ensemble"):
        return {"model": _host(state.ensemble.state_dict()),
                "optim": _host(state.opt_state.state_dict()),
                "step": state.step}
    return {"model": _host(state.params.state_dict()),
            "optim": _host(state.opt_state.state_dict()),
            "step": state.step, "lr_scale": state.lr_scale,
            "rng": state.rng.get_state()}


def _restore(snapshot, fresh):
    """Load a host snapshot into the rebuilt trainer's state, in place:
    each tensor onto the fresh state's device with its dtype.  The
    snapshot is copied in, never shared, so it survives a second
    failure."""
    if hasattr(fresh, "states"):
        for s, snap in zip(fresh.states, snapshot):
            _restore(snap, s)
        return fresh
    module = fresh.ensemble if hasattr(fresh, "ensemble") else fresh.params
    module.load_state_dict(snapshot["model"])
    fresh.opt_state.load_state_dict(_host(snapshot["optim"]))
    fresh.step = snapshot["step"]
    if "rng" in snapshot:
        fresh.lr_scale = snapshot["lr_scale"]
        fresh.rng.set_state(snapshot["rng"])
    return fresh


def _is_device_error(e: BaseException) -> bool:
    """Errors that mean a device or its link died, as against a bug: CUDA
    and accelerator errors, NCCL's and the process group's backend
    errors, by type and by message (the counterpart of JAX's XLA runtime
    errors).  There is no catch-all."""
    if isinstance(e, DeviceFailure):
        return True
    types = tuple(t for t in (getattr(torch, "AcceleratorError", None),
                              getattr(dist, "DistBackendError", None))
                  if t is not None)
    if isinstance(e, types):
        return True
    msg = str(e).lower()
    return any(s in msg for s in (
        "cuda error", "cudaerror", "nccl error", "ncclsystemerror",
        "ncclunhandledcudaerror", "ncclremoteerror",
        "an illegal memory access", "unspecified launch failure",
        "uncorrectable ecc error", "fallen off the bus", "gpu is lost"))


# -- the report and the failure marks beside a checkpoint ---------------
def _read_report(directory: str, committed: int) -> ElasticReport:
    """The report written beside the checkpoint, cut to the ``committed``
    epochs (a write may have got ahead of its checkpoint)."""
    path = os.path.join(directory, REPORT_FILE)
    rep = ElasticReport()
    if os.path.exists(path):
        with open(path) as f:
            d = json.load(f)
        rep = ElasticReport(**{k: v for k, v in d.items()
                               if k in ElasticReport.__dataclass_fields__})
        rep.mesh_history = [tuple(m) for m in rep.mesh_history]
    rep.epoch_losses = rep.epoch_losses[:committed]
    rep.val_losses = rep.val_losses[:committed]
    rep.epochs_completed = committed
    return rep


def _write_report(directory: str, report: ElasticReport) -> None:
    path = os.path.join(directory, REPORT_FILE)
    d = asdict(report)
    d.pop("idle")
    with open(path + ".tmp", "w") as f:
        json.dump(d, f)
    os.replace(path + ".tmp", path)


def _mark_failure(directory: str, rank: int) -> None:
    """Record when this rank failed, for the restarted group's recovery
    seconds (best effort: a killed process writes nothing)."""
    try:
        with open(os.path.join(directory, f"failed_at.rank{rank}"), "w") as f:
            f.write(repr(time.time()))
    except OSError:
        pass


def _end_after_failure(ck, rank: int) -> None:
    """What a worker does before its failure ends it: mark the time, and
    let the save in flight finish (best effort, bounded): its state was
    staged on the host before the failure, and a restart resumes after
    the epoch it holds."""
    _mark_failure(ck.directory, rank)
    try:
        ck.wait(timeout=60.0)
    except Exception:  # noqa: BLE001 -- the failure itself is re-raised
        pass


def _take_failure_marks(directory: str) -> float | None:
    """The earliest failure mark left by the last group, removed."""
    marks = []
    for name in os.listdir(directory):
        if name.startswith("failed_at.rank"):
            path = os.path.join(directory, name)
            with open(path) as f:
                marks.append(float(f.read()))
            os.remove(path)
    return min(marks) if marks else None


# -- the two regimes ----------------------------------------------------
def _local_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _train_epoch(tr, train_loader, runner, epoch, fault_injector):
    """One epoch of ``tr``'s steps; returns (state, mean train loss).
    Real device failures surface at the loss's transfer at the latest."""
    state = tr.state
    if hasattr(train_loader, "set_epoch"):
        train_loader.set_epoch(epoch)
    if runner is not None:
        # the whole epoch in one runner call, as JAX's fused dispatch
        if fault_injector is not None:
            fault_injector(epoch, 0)
        state, m = runner(state, 1)
        return state, float(np.mean(m["loss"][0].double().cpu().numpy()))
    losses = []
    for i, (xb, yb) in enumerate(train_loader):
        if fault_injector is not None:
            fault_injector(epoch, i)
        state, metrics = tr.train_step(state, xb, yb)
        losses.append(metrics["loss"])
    # np.mean also takes the per-seed loss vectors of multiseed trainers
    return state, float(np.mean(host_losses(losses)))


def _group_setup(checkpointer, max_failures, what):
    """The checks and the restart count every worker under a group makes
    before it builds anything."""
    if checkpointer is None:
        raise ValueError(
            f"{what} under a process group needs checkpointer= (a "
            "DistributedCheckpointer): a restarted worker resumes from its "
            "last committed epoch, and without one it would silently start "
            "over")
    agent_max = os.environ.get("TORCHELASTIC_MAX_RESTARTS")
    if agent_max is not None and int(agent_max) > max_failures:
        raise ValueError(
            f"torchrun may restart the workers {agent_max} times "
            f"(--max-restarts) but max_failures={max_failures}")
    return int(os.environ.get("TORCHELASTIC_RESTART_COUNT", 0))


def _resume(ck, mesh_shape, restarts, state_or_none, rules):
    """Restore the last committed epoch into ``state_or_none`` and read
    the report; returns (epoch, report)."""
    done = ck.steps()
    epoch = done[-1] if done else 0
    report = _read_report(ck.directory, epoch)
    failed_at = _take_failure_marks(ck.directory) if rules.lead else None
    if epoch and state_or_none is not None:
        ck.restore(state_or_none, step=epoch)
    if report.mesh_history and (
            int(np.prod(mesh_shape)) > int(np.prod(report.mesh_history[-1]))):
        report.expansions += 1
    report.mesh_history.append(tuple(mesh_shape))
    report.failures = restarts
    if failed_at is not None:
        report.recovery_seconds.append(time.time() - failed_at)
    return epoch, report


def elastic_fit(trainer_factory: Callable[[ShardingRules | None], object],
                loader_factory: Callable[[ShardingRules | None], tuple],
                epochs: int,
                *,
                device="cuda",
                num_model: int = 1,
                global_batch: int | None = None,
                fused: bool = True,
                max_failures: int = 3,
                checkpointer=None,
                fault_injector: Callable[[int, int], None] | None = None,
                verbose: bool = False):
    """Run ``epochs`` of training, surviving device loss.

    Parameters
    ----------
    trainer_factory : rules -> Trainer (or a ``multiseed`` trainer)
        Rebuilds the recipe; ``rules`` is None in one process.  Its
        ``state`` is what is snapshot and restored.
    loader_factory : rules -> (train_loader, val_loader | None)
        Loaders must expose ``set_epoch`` for the replay (all
        data.pipeline loaders do).
    epochs : total epochs to complete (across failures and restarts).
    device : the device this process drives (a CUDA device without an
        index: ``cuda:LOCAL_RANK``).
    num_model : the mesh's model axis under a process group (a seed axis
        split over ranks); 1 in one process.
    global_batch : the loaders' global batch, for the sizing under a
        group; peeked from ``loader_factory(None)`` when omitted.
    fused : run each epoch through the train loader's
        ``make_epoch_runner`` where it has one.
    max_failures : in one process, re-raise after this many recoveries;
        under a group, the most restarts torchrun may make
        (``--max-restarts`` above it is refused).
    checkpointer : a ``DistributedCheckpointer``: every epoch is saved,
        and the run resumes from the last committed epoch.  Needed under
        a process group.
    fault_injector : (epoch, step) -> None, called before every train step
        (once an epoch on the fused path); raise :class:`DeviceFailure`
        from it to simulate a card's loss.

    Returns ``(state, report)``: the final train state (None on a rank
    left over by the sizing) and an :class:`ElasticReport`.
    """
    if dist.is_initialized():
        return _elastic_fit_group(
            trainer_factory, loader_factory, epochs, device, num_model,
            global_batch, fused, max_failures, checkpointer,
            fault_injector, verbose)
    if num_model != 1:
        raise ValueError(f"num_model={num_model} needs a process a device: "
                         "launch under torchrun")
    dev = torch.device(device)
    alive = [dev]
    report = ElasticReport()

    def build():
        if not probe_devices(alive):
            raise RuntimeError(f"no healthy devices remain ({dev} lost)")
        tr = trainer_factory(None)
        train_loader, val_loader = loader_factory(None)
        runner = (train_loader.make_epoch_runner(tr.train_step)
                  if fused and hasattr(train_loader, "make_epoch_runner")
                  else None)
        report.mesh_history.append((1, 1))
        return tr, train_loader, val_loader, runner

    epoch = 0
    if checkpointer is not None:
        done = checkpointer.steps()
        epoch = done[-1] if done else 0
        saved = _read_report(checkpointer.directory, epoch)
        report.epoch_losses, report.val_losses = (saved.epoch_losses,
                                                  saved.val_losses)
        report.mesh_history = saved.mesh_history
    tr, train_loader, val_loader, runner = build()
    if epoch:
        checkpointer.restore(tr.state, step=epoch)
        report.epochs_completed = epoch
    snapshot = _snapshot(tr.state)

    while epoch < epochs:
        new_snapshot = train_loss = None
        try:
            state, train_loss = _train_epoch(tr, train_loader, runner, epoch,
                                             fault_injector)
            # snapshot BEFORE validation: a failure during it keeps the
            # completed training (the epoch is committed with val = nan)
            new_snapshot = _snapshot(state)
            val_loss = (evaluate(tr.eval_step, state.params, val_loader)
                        if val_loader is not None else np.nan)
        except Exception as e:  # noqa: BLE001 -- triage below
            if not _is_device_error(e):
                raise
            report.failures += 1
            if report.failures > max_failures:
                raise
            t0 = time.perf_counter()
            if isinstance(e, DeviceFailure) and dev in e.lost:
                alive = []
            if verbose:
                print(f"elastic: failure #{report.failures} in epoch "
                      f"{epoch}; rebuilding", flush=True)
            tr, train_loader, val_loader, runner = build()
            if new_snapshot is not None:
                # training finished, only validation was interrupted:
                # commit the epoch (val recorded as nan) and move on
                snapshot = new_snapshot
                epoch += 1
                report.epochs_completed = epoch
                report.epoch_losses.append(train_loss)
                report.val_losses.append(float("nan"))
            _restore(snapshot, tr.state)
            if new_snapshot is not None and checkpointer is not None:
                checkpointer.save(epoch, tr.state)
                _write_report(checkpointer.directory, report)
            report.recovery_seconds.append(time.perf_counter() - t0)
            continue   # replay (or resume after) the interrupted epoch
        epoch += 1
        report.epochs_completed = epoch
        report.epoch_losses.append(train_loss)
        report.val_losses.append(float(val_loss))
        snapshot = new_snapshot
        if checkpointer is not None:
            checkpointer.save(epoch, tr.state)
            _write_report(checkpointer.directory, report)
        if verbose:
            print(f"elastic epoch {epoch - 1}: train {train_loss:.5f} "
                  f"val {val_loss:.5f}", flush=True)
    if checkpointer is not None:
        checkpointer.wait()
    return tr.state, report


def _elastic_fit_group(trainer_factory, loader_factory, epochs, device,
                       num_model, global_batch, fused, max_failures,
                       checkpointer, fault_injector, verbose):
    """elastic_fit under a process group: no recovery in the process; a
    failure ends it, and the agent restarts the group, which resumes
    from the checkpointer."""
    restarts = _group_setup(checkpointer, max_failures, "elastic_fit")
    dev = _local_device(device)
    if not probe_devices([dev]):
        raise RuntimeError(f"rank {dist.get_rank()}: {dev} failed its probe")
    if global_batch is None:
        global_batch = loader_factory(None)[0].batch_size
    world = dist.get_world_size()
    n_data = usable_data_size(world, num_model, global_batch)
    ranks = list(range(n_data * num_model))
    mesh = make_mesh(n_data, num_model, dev, ranks=ranks)
    ck = checkpointer.for_ranks(ranks)
    if mesh is None:   # left over: no part in the steps
        dist.barrier()
        return None, ElasticReport(failures=restarts, idle=True)
    rules = ShardingRules(mesh)
    tr = trainer_factory(rules)
    train_loader, val_loader = loader_factory(rules)
    runner = (train_loader.make_epoch_runner(tr.train_step)
              if fused and hasattr(train_loader, "make_epoch_runner")
              else None)
    epoch, report = _resume(ck, (n_data, num_model), restarts, tr.state,
                            rules)
    if verbose and rules.lead:
        print(f"elastic: mesh {(n_data, num_model)} of a world of {world}, "
              f"restart {restarts}, resuming at epoch {epoch}", flush=True)
    try:
        while epoch < epochs:
            state, train_loss = _train_epoch(tr, train_loader, runner, epoch,
                                             fault_injector)
            val_loss = (evaluate(tr.eval_step, state.params, val_loader)
                        if val_loader is not None else np.nan)
            epoch += 1
            ck.save(epoch, state)
            report.epochs_completed = epoch
            report.epoch_losses.append(train_loss)
            report.val_losses.append(float(val_loss))
            if rules.lead:
                _write_report(ck.directory, report)
                if verbose:
                    print(f"elastic epoch {epoch - 1}: train "
                          f"{train_loss:.5f} val {val_loss:.5f} (mesh "
                          f"{report.mesh_history[-1]})", flush=True)
    except BaseException:
        _end_after_failure(ck, dist.get_rank())
        raise
    ck.wait()
    dist.barrier()
    return tr.state, report


def elastic_rpn_fit(rpn_factory: Callable[[ShardingRules | None], object],
                    loader_factory: Callable[[ShardingRules | None], object],
                    epochs: int,
                    ensemble_size: int,
                    *,
                    device="cuda",
                    max_failures: int = 3,
                    checkpointer=None,
                    fault_injector: Callable[[int, int], None] | None = None,
                    verbose: bool = False):
    """Elastic training of the RPN ensemble, its members split over the
    model axis (``rpn_recipe.rpn_trainer(rules=...)``).

    In one process the epoch-boundary snapshot of the members, their
    priors, Adam and the step is restored into the rebuilt trainer after
    a failure.  Under a process group the model axis is the largest that
    divides ``ensemble_size`` and fits the ranks, and the ranks left over
    form a data axis (JAX ``elastic.py:396-398``): after a restart onto
    fewer ranks the members redistribute, each restored from the
    checkpointer by its global index.  ``checkpointer`` is the
    process-restart counterpart of JAX's in-memory snapshot; it adds no
    capability.

    rpn_factory : rules -> RPNTrainer (``rpn_trainer(..., rules=rules)``,
        from one seed: every rank draws the same ensemble).
    loader_factory : rules -> BootstrapLoader (with ``set_epoch``).

    Returns ``(trainer, report)``: the trainer holds this rank's members
    (``ensemble.net``, ``ensemble.prior``, ``opt_state``: JAX's params,
    prior and opt_state).
    """
    if dist.is_initialized():
        return _elastic_rpn_group(rpn_factory, loader_factory, epochs,
                                  ensemble_size, device, max_failures,
                                  checkpointer, fault_injector, verbose)
    dev = torch.device(device)
    alive = [dev]
    report = ElasticReport()

    def build():
        if not probe_devices(alive):
            raise RuntimeError(f"no healthy devices remain ({dev} lost)")
        report.mesh_history.append((1, 1))
        return rpn_factory(None), loader_factory(None)

    epoch = 0
    if checkpointer is not None:
        done = checkpointer.steps()
        epoch = done[-1] if done else 0
        saved = _read_report(checkpointer.directory, epoch)
        report.epoch_losses = saved.epoch_losses
        report.mesh_history = saved.mesh_history
    tr, loader = build()
    if epoch:
        checkpointer.restore(tr, step=epoch)
        report.epochs_completed = epoch
    snapshot = _snapshot(tr)
    while epoch < epochs:
        try:
            train_loss = _rpn_epoch(tr, loader, epoch, fault_injector)
        except Exception as e:  # noqa: BLE001 -- triage below
            if not _is_device_error(e):
                raise
            report.failures += 1
            if report.failures > max_failures:
                raise
            t0 = time.perf_counter()
            if isinstance(e, DeviceFailure) and dev in e.lost:
                alive = []
            if verbose:
                print(f"elastic-rpn: failure #{report.failures} in epoch "
                      f"{epoch}; rebuilding", flush=True)
            tr, loader = build()
            _restore(snapshot, tr)
            report.recovery_seconds.append(time.perf_counter() - t0)
            continue   # replay the interrupted epoch
        epoch += 1
        report.epochs_completed = epoch
        report.epoch_losses.append(train_loss)
        snapshot = _snapshot(tr)
        if checkpointer is not None:
            checkpointer.save(epoch, tr)
            _write_report(checkpointer.directory, report)
        if verbose:
            print(f"elastic-rpn epoch {epoch - 1}: train {train_loss:.5f}",
                  flush=True)
    if checkpointer is not None:
        checkpointer.wait()
    return tr, report


def _rpn_epoch(tr, loader, epoch, fault_injector) -> float:
    """One epoch of RPN steps; the member-mean loss (the transfer forces
    the epoch, so real device failures surface here)."""
    if hasattr(loader, "set_epoch"):
        loader.set_epoch(epoch)
    losses = []
    for i, (xb, yb) in enumerate(loader):
        if fault_injector is not None:
            fault_injector(epoch, i)
        losses.append(tr.train_step(xb, yb))
    return float(np.mean(torch.stack(losses).double().cpu().numpy()))


def _elastic_rpn_group(rpn_factory, loader_factory, epochs, ensemble_size,
                       device, max_failures, checkpointer, fault_injector,
                       verbose):
    restarts = _group_setup(checkpointer, max_failures, "elastic_rpn_fit")
    dev = _local_device(device)
    if not probe_devices([dev]):
        raise RuntimeError(f"rank {dist.get_rank()}: {dev} failed its probe")
    world = dist.get_world_size()
    m = usable_model_size(world, ensemble_size)
    d = world // m   # the ranks left over by the members: a data axis
    ranks = list(range(d * m))
    mesh = make_mesh(d, m, dev, ranks=ranks)
    ck = checkpointer.for_ranks(ranks)
    if mesh is None:
        dist.barrier()
        return None, ElasticReport(failures=restarts, idle=True)
    rules = ShardingRules(mesh)
    tr = rpn_factory(rules)
    loader = loader_factory(rules)
    epoch, report = _resume(ck, (d, m), restarts, tr, rules)
    if verbose and rules.lead:
        print(f"elastic-rpn: mesh {(d, m)} of a world of {world}, restart "
              f"{restarts}, resuming at epoch {epoch}", flush=True)
    try:
        while epoch < epochs:
            train_loss = _rpn_epoch(tr, loader, epoch, fault_injector)
            epoch += 1
            ck.save(epoch, tr)
            report.epochs_completed = epoch
            report.epoch_losses.append(train_loss)
            if rules.lead:
                _write_report(ck.directory, report)
    except BaseException:
        _end_after_failure(ck, dist.get_rank())
        raise
    ck.wait()
    dist.barrier()
    return tr, report
