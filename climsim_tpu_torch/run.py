"""Experiment runner: config -> data -> trainer -> fit (the counterpart of
``climsim_tpu.run``).

CLI:  python -m climsim_tpu_torch.run --preset mlp_v1 [k.ey=value ...]
      python -m climsim_tpu_torch.run --config exp.json
      python -m climsim_tpu_torch.run --device cpu --preset cnn_v1 ...

Every preset of ``config.PRESETS`` trains on the card unless ``--device``
says otherwise: the single-model ``fit`` path (HSR's loss staged at a
third of the epochs, a warm restart from ``train.restart_path``), the RPN
ensemble's loop over ``BootstrapLoader`` and the multi-seed loop
(``train.seeds``).

Data-parallel training over N cards, one process a card (the
counterpart of ``scripts/launch_multihost.sh``):

  torchrun --nproc-per-node N -m climsim_tpu_torch.run --preset mlp_v1 \
      train.num_data_shards=N

``train.num_data_shards`` must equal torchrun's world size (0, the
default, means the world size); the process group is NCCL on the card
and gloo with ``--device cpu``.  ``data.batch_size`` stays the global
batch.  Rank 0 alone writes the manifest, the checkpoints and the log.

``train.elastic=true`` trains through ``train.elastic.elastic_fit``: in
one process a device failure rebuilds the trainer and replays the epoch
from its host snapshot; under torchrun's elastic agent a failure ends the
workers, the agent restarts them, and they resume from the
``DistributedCheckpointer`` in ``<train.checkpoint_dir>/elastic``:

  torchrun --nproc-per-node N --max-restarts 3 -m climsim_tpu_torch.run \
      --preset mlp_v1 train.elastic=true train.checkpoint_dir=runs/e

The data axis is then sized by ``elastic_fit`` (the largest that divides
the batch), not by ``train.num_data_shards``.  HSR's staged loss stays on
the ``fit`` path.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import PRESETS, ExperimentConfig
from .data.pipeline import BatchLoader, BootstrapLoader, DeviceResidentLoader
from .data.synthetic import synthetic_split
from .grid import load_default_grid
from .norms import (RUN_NORMS, compute_norms_from_data, identity_norms,
                    load_asset_norms)
from .parallel.mesh import ShardingRules, distributed_init_if_needed, make_mesh
from .train import recipes
from .train.checkpoints import (TimedCheckpointer, TopKCheckpointer,
                                load_state)
from .train.loop import EarlyStopping, History, PlateauController, fit
from .train.multiseed import multiseed
from .train.rpn_recipe import rpn_trainer
from .varspec import get_varspec

# splits up to this many bytes stay on the card for the whole run
# (DeviceResidentLoader), about the JAX runner's share of one chip
DEVICE_SPLIT_BYTES = 9e9


def load_data(cfg: ExperimentConfig, grid):
    spec = get_varspec(cfg.data.varspec)
    if cfg.data.source == "synthetic":
        x, y = synthetic_split(spec, cfg.data.num_synthetic, grid,
                               cfg.data.seed)
        if "icol" in spec.inputs:
            x[:, spec.input_slices["icol"]] = (
                np.arange(x.shape[0]) % grid.ncol + 1)[:, None]
    else:
        x = np.load(cfg.data.input_path, mmap_mode="r")
        y = np.load(cfg.data.target_path, mmap_mode="r")
    if cfg.data.norms == "asset":
        stats = load_asset_norms(cfg.data.varspec)
    elif cfg.data.norms == "compute":
        stats = compute_norms_from_data(spec, np.asarray(x), np.asarray(y),
                                        qn_transform=cfg.transform.qn_transform)
    else:
        stats = identity_norms(spec)
    return spec, x, y, stats


def build_trainer(cfg: ExperimentConfig, spec, stats, sample, rng, rules,
                  steps_per_epoch, grid, verbose=True, device="cuda"):
    common = dict(rules=rules, steps_per_epoch=steps_per_epoch,
                  cfg=cfg.transform, device=device)
    t = cfg.train
    if verbose and cfg.model in ("mlp", "mlp_v2", "ed", "cnn") \
            and t.lr != 1e-3:
        # these recipes pin the papers' published LR schedules (cyclic
        # triangular for the MLPs, Adam 1e-4 with /5-every-7-epochs for
        # ED, the CNN's cyclic Adam): train.lr does not apply to them
        print(f"note: {cfg.model!r} uses its published reference LR "
              f"schedule; train.lr={t.lr:g} is ignored")
    if cfg.model == "mlp":
        return recipes.mlp_trainer(spec, stats, sample, rng,
                                   **cfg.model_kw, **common)
    if cfg.model == "mlp_v2":
        return recipes.mlp_v2_trainer(spec, stats, sample, rng,
                                      **cfg.model_kw, **common)
    if cfg.model == "ed":
        return recipes.ed_trainer(spec, stats, sample, rng, **common)
    if cfg.model == "cnn":
        return recipes.cnn_trainer(spec, stats, sample, rng,
                                   loss_kind=t.loss, **cfg.model_kw,
                                   **common)
    if cfg.model == "hsr":
        return recipes.hsr_trainer(spec, stats, sample, rng, lr=t.lr,
                                   **cfg.model_kw, **common)
    if cfg.model == "cvae":
        return recipes.cvae_trainer(spec, stats, sample, rng, lr=t.lr,
                                    **cfg.model_kw, **common)
    if cfg.model == "mlp_online":
        return recipes.online_mlp_trainer(
            spec, stats, sample, rng, loss_kind=t.loss,
            block_weights=t.block_weights or None,
            energy_weight=t.energy_weight, grid=grid, lr=t.lr,
            **cfg.model_kw, **common)
    if cfg.model == "unet":
        return recipes.unet_trainer(
            spec, stats, sample, rng, model_kw=cfg.model_kw,
            loss_kind=t.loss, block_weights=t.block_weights or None,
            energy_weight=t.energy_weight, grid=grid, lr=t.lr,
            schedule_name=t.schedule, total_epochs=t.epochs, **common)
    if cfg.model == "unet_classifier":
        return recipes.unet_classifier_trainer(
            spec, stats, sample, rng, model_kw=cfg.model_kw, lr=t.lr,
            **common)
    raise ValueError(f"unknown model {cfg.model!r} "
                     "(rpn uses climsim_tpu_torch.train.rpn_recipe directly)")


def write_manifest(cfg: ExperimentConfig, directory: str,
                   device="cuda", stats=None) -> None:
    """Reproducibility manifest next to the checkpoints: the full config,
    library versions, the device, the git SHA where there is one.  With
    ``stats``, the norms the run trains with are saved beside it
    (``norms.RUN_NORMS``), for ``package_e3sm`` to bundle."""
    device = torch.device(device)
    os.makedirs(directory, exist_ok=True)
    if stats is not None:
        stats.save_npz(os.path.join(directory, RUN_NORMS))
    info = {
        "config": json.loads(cfg.to_json()),
        "norms": {"mode": cfg.data.norms,
                  "file": RUN_NORMS if stats is not None else None},
        "time": time.strftime("%Y-%m-%d %H:%M:%S %Z"),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "numpy": np.__version__,
        "python": sys.version.split()[0],
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    try:
        info["git_sha"] = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            timeout=5).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        info["git_sha"] = None
    with open(os.path.join(directory, "run_manifest.json"), "w") as f:
        json.dump(info, f, indent=2)


def _host(values) -> np.ndarray:
    """Device tensors -> one float64 host array (one wait for the card)."""
    return torch.stack(values).double().cpu().numpy()


def data_parallel_rules(cfg: ExperimentConfig, device="cuda"):
    """The run's ShardingRules, or None for one process.

    Under torchrun this joins the process group (NCCL on the card, gloo
    for ``device="cpu"``; no fallback from one to the other) unless one
    exists.  ``train.num_data_shards`` (0: the world size) must equal the
    world size: a run never trains on fewer ranks than it asked for."""
    distributed_init_if_needed(
        "gloo" if torch.device(device).type == "cpu" else None)
    world = (torch.distributed.get_world_size()
             if torch.distributed.is_initialized() else 1)
    n = cfg.train.num_data_shards or world
    if n != world:
        raise ValueError(
            f"train.num_data_shards={n} needs {n} processes, one a device "
            f"(torchrun --nproc-per-node {n} -m climsim_tpu_torch.run ...); "
            f"this run has {world}")
    return (ShardingRules(make_mesh(num_data=n, device=device)) if n > 1
            else None)


def _rpn(cfg, spec, stats, x_tr, y_tr, x_val, y_val, steps, grid, verbose,
         device, rules):
    """The RPN ensemble: a per-epoch ensemble-mean validation loss,
    History, top-K checkpoints (params and prior) and early stopping, the
    control flow every other model gets from fit().  Under ``rules``
    each rank trains on its slice of each member's batch; the
    validation runs whole on every rank."""
    tr = rpn_trainer(spec, stats, x_tr, cfg.seed, cfg=cfg.transform,
                     rules=rules, device=device, **cfg.model_kw)
    loader = BootstrapLoader(
        np.asarray(x_tr), np.asarray(y_tr), cfg.data.batch_size,
        cfg.model_kw.get("ensemble_size", 32), rules=rules,
        steps_per_epoch=steps, seed=cfg.data.seed, device=device)
    ckpt = (TopKCheckpointer(cfg.train.checkpoint_dir, cfg.train.top_k)
            if cfg.train.checkpoint_dir and _lead(rules) else None)
    early = (EarlyStopping(cfg.train.early_stop_patience)
             if cfg.train.early_stop_patience else None)
    history = History()
    bs = cfg.data.batch_size
    for epoch in range(cfg.train.epochs):
        losses, n_seen = [], 0
        t0 = time.perf_counter()
        for xb, yb in loader:
            losses.append(tr.train_step(xb, yb).mean())
            # data rows a step (xb is (E, B, D); E * B would inflate the
            # rate E times against every other path's accounting), global
            n_seen += xb.shape[1] * (rules.world_size if rules else 1)
        train_loss = float(np.mean(_host(losses)))
        sps = n_seen / max(time.perf_counter() - t0, 1e-9)
        val_loss = np.nan
        if x_val.shape[0]:
            vls = [tr.eval_losses(*(torch.as_tensor(np.asarray(a[s:s + bs]))
                                    for a in (x_val, y_val))).mean()
                   for s in range(0, x_val.shape[0], bs)]
            val_loss = float(np.mean(_host(vls)))
        history.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                    samples_per_sec=sps)
        if ckpt is not None and np.isfinite(val_loss):
            tree = {"params": tr.ensemble.net, "prior": tr.ensemble.prior}
            ckpt.maybe_save(val_loss, epoch, tree)
            ckpt.save_last(epoch, tree)
        if rules is not None:
            rules.barrier()
        if verbose:
            print(f"epoch {epoch}: train {train_loss:.5f} "
                  f"val {val_loss:.5f} ({sps:,.0f} samples/s)", flush=True)
        if early is not None and np.isfinite(val_loss) and \
                early.should_stop(val_loss):
            break
    return dict(trainer=tr, params=tr.ensemble.net, stats=stats, spec=spec,
                history=history, grid=grid)


def _multiseed(cfg, spec, stats, x_tr, y_tr, x_val, y_val, steps, grid,
               verbose, device, rules):
    """K replicas, one a seed of ``train.seeds``, advanced by one step
    call: fit()'s control flow with per-seed validation losses, HSR's
    staged loss, the plateau on the mean validation loss (composed with
    the per-seed ``lr_scales``), early stopping and the replicas'
    checkpoints.  One seed in the list still takes this path.  Under
    ``rules`` every rank holds every replica and its rows of each
    batch."""
    sample = (np.asarray(x_tr[:4]), np.asarray(y_tr[:4]))
    base_scales = np.asarray(
        list(cfg.train.lr_scales) or [1.0] * len(cfg.train.seeds),
        np.float32)
    ms = multiseed(
        lambda sp, st, sa, r, rules=None: build_trainer(
            cfg, sp, st, sa, r, rules, steps, grid, verbose, device),
        spec, stats, sample, list(cfg.train.seeds), rules=rules,
        lr_scales=base_scales.tolist())
    loader = BatchLoader(x_tr, y_tr, cfg.data.batch_size, rules,
                         seed=cfg.data.seed, device=device)
    ckpt = (TopKCheckpointer(cfg.train.checkpoint_dir, cfg.train.top_k)
            if cfg.train.checkpoint_dir and _lead(rules) else None)
    plateau = (PlateauController(cfg.train.plateau_patience)
               if cfg.train.plateau_patience else None)
    early = (EarlyStopping(cfg.train.early_stop_patience)
             if cfg.train.early_stop_patience else None)
    stage1 = (cfg.train.epochs // 3
              if cfg.model == "hsr" and cfg.train.epochs >= 3 else None)
    history = History()
    state = ms.state
    bs = cfg.data.batch_size
    for epoch in range(cfg.train.epochs):
        step_fn = (ms.stage2_step if stage1 is not None and epoch >= stage1
                   else ms.train_step)
        tls = []
        for xb, yb in loader:
            state, m = step_fn(state, xb, yb)
            tls.append(m["loss"])
        if not tls:
            raise ValueError(
                f"no training batches: fewer train rows ({x_tr.shape[0]}) "
                f"than batch_size ({bs})")
        train_losses = _host(tls).mean(axis=0)
        val_losses = np.full(ms.num_seeds, np.nan)
        if x_val.shape[0]:
            vls = [ms.eval_step(state.params,
                                *_val_rows(rules, x_val[s:s + bs],
                                           y_val[s:s + bs]))["loss"]
                   for s in range(0, x_val.shape[0] - bs + 1, bs)]
            if vls:
                val_losses = _host(vls).mean(axis=0)
        mean_val = float(np.nanmean(val_losses))
        if plateau is not None and np.isfinite(mean_val):
            state.set_lr_scale(base_scales * plateau.update(mean_val))
        history.log(epoch=epoch, train_loss=float(train_losses.mean()),
                    val_loss=mean_val)
        if ckpt is not None and np.all(np.isfinite(val_losses)):
            ckpt.maybe_save(float(val_losses.mean()), epoch, state.params)
            ckpt.save_last(epoch, state.params)
        if rules is not None:
            rules.barrier()
        if verbose:
            per = ", ".join(f"{s}:{v:.5f}" for s, v in
                            zip(cfg.train.seeds, val_losses))
            print(f"epoch {epoch}: train {train_losses.mean():.5f} "
                  f"val per-seed [{per}]", flush=True)
        if early is not None and np.isfinite(mean_val) and \
                early.should_stop(mean_val):
            break
    return dict(trainer=ms, state=state, history=history, stats=stats,
                spec=spec, grid=grid)


def _elastic(cfg, spec, stats, x_tr, y_tr, x_val, y_val, steps, grid,
             verbose, device, rules):
    """``train.elastic``: ``elastic_fit`` over ``build_trainer`` and
    ``BatchLoader`` factories, the model axis 1, every epoch saved by a
    ``DistributedCheckpointer`` in ``<train.checkpoint_dir>/elastic``
    where the directory is set (needed under torchrun).  The history's
    epochs are numbered from the report, which spans the restarts (JAX
    ``run.py:353-360``)."""
    from .train.checkpoints import DistributedCheckpointer
    from .train.elastic import elastic_fit

    del rules
    sample = (np.asarray(x_tr[:4]), np.asarray(y_tr[:4]))
    bs = cfg.data.batch_size

    def trainer_factory(r):
        return build_trainer(cfg, spec, stats, sample, cfg.seed, r, steps,
                             grid, False, r.device if r else device)

    def loader_factory(r):
        tl = BatchLoader(x_tr, y_tr, bs, r, seed=cfg.data.seed,
                         device=device)
        vl = (BatchLoader(x_val, y_val, bs, r, shuffle=False, device=device)
              if x_val.shape[0] else None)
        return tl, vl

    checkpointer = (DistributedCheckpointer(
        os.path.join(cfg.train.checkpoint_dir, "elastic"))
        if cfg.train.checkpoint_dir else None)
    state, report = elastic_fit(
        trainer_factory, loader_factory, cfg.train.epochs, device=device,
        num_model=1, global_batch=bs, checkpointer=checkpointer,
        verbose=verbose)
    history = History()
    start = report.epochs_completed - len(report.epoch_losses)
    for i, (tl, vl) in enumerate(zip(report.epoch_losses,
                                     report.val_losses)):
        history.log(epoch=start + i, train_loss=tl, val_loss=vl)
    return dict(trainer=None, state=state, history=history, stats=stats,
                spec=spec, grid=grid, report=report)


def _lead(rules) -> bool:
    """Whether this process writes: the only one, or rank 0."""
    return rules is None or rules.lead


def _val_rows(rules, xv, yv):
    """A validation batch as tensors: this rank's rows under ``rules``."""
    xv, yv = np.asarray(xv), np.asarray(yv)
    if rules is not None:
        return rules.shard_batch(xv, yv)
    return torch.as_tensor(xv), torch.as_tensor(yv)


def _restart(tr, path: str, verbose: bool) -> None:
    """A weights-only warm restart (the reference's restart_path,
    train_unet_h5loader.py:177-189), the optimizer state fresh: the
    loaded weights are copied into the live parameters, on their device."""
    if os.path.isdir(path):
        last = os.path.join(path, "last.pt")
        if os.path.exists(last):
            load_state(last, tr.model)
        elif TopKCheckpointer(path).load_best(tr.model) is None:
            raise ValueError(f"no checkpoints in {path}")
    else:
        load_state(path, tr.model)
    if verbose:
        print(f"warm restart: loaded weights from {path}")


def run_experiment(cfg: ExperimentConfig, verbose: bool = True,
                   device="cuda"):
    # a copy first: this function clamps the batch size, and callers
    # commonly pass shared PRESETS entries
    cfg = cfg.override()
    if cfg.train.restart_path and (cfg.model == "rpn" or cfg.train.seeds
                                   or cfg.train.elastic):
        raise ValueError(
            "train.restart_path is only supported on the single-model "
            "fit() path; the rpn, multi-seed and elastic branches would "
            "silently train from scratch")
    elastic = (cfg.train.elastic and cfg.model != "rpn"
               and not cfg.train.seeds)
    if elastic and cfg.model == "hsr":
        raise ValueError("train.elastic does not support HSR's staged "
                         "loss; use the fit() path")
    rules, n_dev, lead = None, 1, True
    if elastic:   # elastic_fit sizes its own mesh
        distributed_init_if_needed(
            "gloo" if torch.device(device).type == "cpu" else None)
        if torch.distributed.is_initialized():
            n_dev = torch.distributed.get_world_size()
            lead = torch.distributed.get_rank() == 0
    else:
        rules = data_parallel_rules(cfg, device)
        lead = _lead(rules)
        if rules is not None:
            n_dev, device = rules.world_size, rules.device
    verbose = verbose and lead
    grid = load_default_grid()
    spec, x, y, stats = load_data(cfg, grid)
    if cfg.train.checkpoint_dir and lead:
        write_manifest(cfg, cfg.train.checkpoint_dir, device, stats)

    n = x.shape[0]
    if cfg.data.val_fraction > 0:
        # hold out at least one full eval batch when the data allows it,
        # but never more than half the rows
        n_val = min(max(int(n * cfg.data.val_fraction), 1,
                        cfg.data.batch_size), n // 2)
    else:
        n_val = 0
    if cfg.data.batch_size > n - n_val:
        # a global batch the ranks divide (climsim_tpu/run.py:164)
        clamped = max((n - n_val) // n_dev * n_dev, n_dev)
        if verbose:
            print(f"batch_size {cfg.data.batch_size} exceeds the "
                  f"{n - n_val}-row train split; clamping to {clamped}")
        cfg.data.batch_size = clamped
    x_tr, y_tr = x[: n - n_val], y[: n - n_val]
    x_val, y_val = x[n - n_val:], y[n - n_val:]
    steps = max(x_tr.shape[0] // cfg.data.batch_size, 1)
    args = (cfg, spec, stats, x_tr, y_tr, x_val, y_val, steps, grid,
            verbose, device, rules)
    if cfg.model == "rpn":
        return _rpn(*args)
    if cfg.train.seeds:
        return _multiseed(*args)
    if elastic:
        return _elastic(*args)

    tr = build_trainer(cfg, spec, stats, (np.asarray(x_tr[:4]),
                                          np.asarray(y_tr[:4])), cfg.seed,
                       rules, steps, grid, verbose, device)
    if cfg.train.restart_path:
        _restart(tr, cfg.train.restart_path, verbose)

    # the split stays on the card when it fits; else the host streams it
    use_device = cfg.data.loader == "device" or (
        cfg.data.loader == "auto" and torch.device(device).type == "cuda"
        and (x_tr.nbytes + y_tr.nbytes) < DEVICE_SPLIT_BYTES)
    if use_device:
        train_loader = DeviceResidentLoader(
            np.asarray(x_tr), np.asarray(y_tr), cfg.data.batch_size, rules,
            seed=cfg.data.seed, block_shuffle=cfg.data.block_shuffle or None,
            device=device)
        val_loader = (DeviceResidentLoader(
            np.asarray(x_val), np.asarray(y_val), cfg.data.batch_size, rules,
            shuffle=False, device=device) if n_val else None)
    else:
        train_loader = BatchLoader(x_tr, y_tr, cfg.data.batch_size, rules,
                                   seed=cfg.data.seed, device=device)
        val_loader = (BatchLoader(x_val, y_val, cfg.data.batch_size, rules,
                                  shuffle=False, device=device)
                      if n_val else None)
    lead = _lead(rules)
    ckpt = (TopKCheckpointer(cfg.train.checkpoint_dir, cfg.train.top_k)
            if cfg.train.checkpoint_dir and lead else None)
    timed = None
    if cfg.train.timed_interval > 0:
        if not cfg.train.checkpoint_dir:
            raise ValueError(
                "train.timed_interval needs train.checkpoint_dir -- "
                "periodic saves have nowhere to go")
        timed = (TimedCheckpointer(
            os.path.join(cfg.train.checkpoint_dir, "timed.pt"),
            cfg.train.timed_interval) if lead else None)
    plateau = (PlateauController(cfg.train.plateau_patience)
               if cfg.train.plateau_patience else None)
    early = (EarlyStopping(cfg.train.early_stop_patience)
             if cfg.train.early_stop_patience else None)
    kw = dict(ckpt=ckpt, plateau=plateau, early=early, verbose=verbose,
              timed_ckpt=timed, rules=rules)
    if cfg.model == "hsr" and cfg.train.epochs >= 3:
        # the staged loss: MSE for the first third, NLL after
        # (hsr.py:128-134)
        stage1 = cfg.train.epochs // 3
        state, history = fit(tr.train_step, tr.eval_step, tr.state,
                             train_loader, val_loader, stage1, **kw)
        state, history2 = fit(tr.stage2_step, tr.eval_step, state,
                              train_loader, val_loader,
                              cfg.train.epochs - stage1, **kw)
        history.rows.extend(history2.rows)
    else:
        state, history = fit(tr.train_step, tr.eval_step, tr.state,
                             train_loader, val_loader, cfg.train.epochs,
                             **kw)
    return dict(trainer=tr, state=state, history=history, stats=stats,
                spec=spec, grid=grid)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", choices=sorted(PRESETS))
    ap.add_argument("--config", help="path to ExperimentConfig json")
    ap.add_argument("overrides", nargs="*", help="dotted key=value")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card) or cpu")
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config) as f:
            d = json.load(f)
        # a bare ExperimentConfig json, or the run_manifest.json written
        # beside every checkpointed run
        cfg = ExperimentConfig.from_dict(d.get("config", d))
    elif args.preset:
        cfg = PRESETS[args.preset]
    else:
        ap.error("need --preset or --config")
    if args.overrides:
        cfg = cfg.override(*args.overrides)
    return run_experiment(cfg, verbose=not args.quiet, device=args.device)


if __name__ == "__main__":
    main()
