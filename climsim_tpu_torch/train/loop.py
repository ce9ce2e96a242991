"""Epoch-driven training loop (the counterpart of
``climsim_tpu.train.loop``).

Host-side orchestration around the train step: epochs, validation,
plateau LR control, top-K checkpointing, early stopping and a CSV-style
history.  Replaces train_unet_h5loader.py:355-508 and the Keras callback
stack.  The step leaves its metrics on the device; the loop reads the
losses back once an epoch for training and once a pass for validation.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .checkpoints import TopKCheckpointer
from .step import TrainState


@dataclass
class PlateauController:
    """ReduceLROnPlateau: scale lr_scale by ``factor`` after ``patience``
    epochs without a better validation loss (the torch scheduler family
    the online configs use)."""

    patience: int = 3
    factor: float = 0.5
    min_scale: float = 1e-3
    best: float = np.inf
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, val_loss: float) -> float:
        if val_loss < self.best - 1e-12:
            self.best = val_loss
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self.scale = max(self.scale * self.factor, self.min_scale)
                self.bad_epochs = 0
        return self.scale


@dataclass
class EarlyStopping:
    """Keras-style early stopping (step2_retrain.py:258-261, patience 8)."""

    patience: int = 8
    best: float = np.inf
    bad_epochs: int = 0

    def should_stop(self, val_loss: float) -> bool:
        if val_loss < self.best - 1e-12:
            self.best = val_loss
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs >= self.patience


@dataclass
class History:
    rows: list = field(default_factory=list)

    def log(self, **kw):
        self.rows.append(kw)

    def save_csv(self, path: str):
        if not self.rows:
            return
        keys = list(self.rows[0])
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self.rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")


def _host(losses) -> np.ndarray:
    """Device scalars -> one float64 host vector: one wait for the card."""
    return torch.stack(losses).double().cpu().numpy()


def run_epoch(train_step, state: TrainState, loader):
    """One epoch, a step a batch; returns (state, mean_loss,
    samples_per_sec)."""
    losses = []
    n_samples = 0
    t0 = time.perf_counter()
    for xb, yb in loader:
        state, metrics = train_step(state, xb, yb)
        losses.append(metrics["loss"])
        n_samples += xb.shape[0]
    mean_loss = float(np.mean(_host(losses))) if losses else np.nan
    dt = time.perf_counter() - t0
    return state, mean_loss, n_samples / max(dt, 1e-9)


def evaluate(eval_step, params, loader) -> float:
    """The batch-size-weighted mean of ``eval_step``'s loss over
    ``loader``; a ``ChunkedLoader``'s (K, B, D) superbatch is evaluated as
    one (K*B, D) batch."""
    chunked = hasattr(loader, "steps_per_chunk")
    losses, weights = [], []
    for xb, yb in loader:
        if chunked:
            xb = xb.reshape(-1, xb.shape[-1])
            yb = yb.reshape(-1, yb.shape[-1])
        losses.append(eval_step(params, xb, yb)["loss"])
        weights.append(xb.shape[0])
    return (float(np.average(_host(losses), weights=weights)) if losses
            else np.nan)


def fit(train_step, eval_step, state: TrainState, train_loader, val_loader,
        epochs: int, ckpt: TopKCheckpointer | None = None,
        plateau: PlateauController | None = None,
        early: EarlyStopping | None = None, verbose: bool = True,
        history: History | None = None, fused: bool = True,
        timed_ckpt=None, rules=None):
    """The reference trainers' control flow; returns (state, history).

    Where the train loader has ``make_epoch_runner``
    (``DeviceResidentLoader``) and ``fused`` is set, each epoch runs
    through the runner (the same steps as the per-batch loop, bit for
    bit); the loss comes back once an epoch.  A ``ChunkedLoader``'s
    (K, B, D) superbatches always go through its chunk runner (K steps a
    superbatch), fused or not; the epoch's loss is the mean of the
    superbatches' means.  The plateau writes
    ``state.lr_scale``; the top-K and last checkpoints take the model's
    weights after each validated epoch.

    With ``rules`` (data-parallel, one process a rank) the steps' and
    evaluation's losses are already means over the ranks, so every rank
    takes the same plateau, early-stop and top-K decisions.  Only rank 0
    writes checkpoints and prints; the other ranks wait at a barrier
    until its writes of the epoch are done.  (JAX's ``fit`` never needed
    this: one controller saw the global arrays.)
    """
    lead = rules is None or rules.lead
    world = 1 if rules is None else rules.world_size   # rates: global rows
    history = history if history is not None else History()
    runner = (train_loader.make_epoch_runner(train_step)
              if fused and hasattr(train_loader, "make_epoch_runner")
              else None)
    chunk_run = (train_loader.make_chunk_runner(train_step)
                 if hasattr(train_loader, "make_chunk_runner") else None)
    for epoch in range(epochs):
        if chunk_run is not None:
            t0 = time.perf_counter()
            losses, n = [], 0
            for xc, yc in train_loader:
                state, m = chunk_run(state, xc, yc)
                losses.append(m["loss"])
                n += xc.shape[0] * xc.shape[1] * world
            train_loss = float(np.mean(_host(losses))) if losses else np.nan
            sps = n / max(time.perf_counter() - t0, 1e-9)
        elif runner is not None:
            t0 = time.perf_counter()
            state, m = runner(state, 1)
            train_loss = float(m["loss"][0])
            n = train_loader.steps_per_epoch * train_loader.batch_size
            sps = n / max(time.perf_counter() - t0, 1e-9)
        else:
            state, train_loss, sps = run_epoch(train_step, state,
                                               train_loader)
            sps *= world
        val_loss = (evaluate(eval_step, state.params, val_loader)
                    if val_loader is not None else np.nan)
        if plateau is not None and np.isfinite(val_loss):
            state.lr_scale = plateau.update(val_loss)
        if lead and ckpt is not None and np.isfinite(val_loss):
            ckpt.maybe_save(val_loss, state.step, state.params)
            ckpt.save_last(state.step, state.params)
        if lead and timed_ckpt is not None:
            # wall-clock periodic save (the reference: every 1200 s,
            # hsr.py:120-121); an epoch's end is where it is checked
            timed_ckpt.maybe_save(state.params)
        if rules is not None:   # every rank, whichever holds checkpointers
            rules.barrier()
        history.log(epoch=epoch, train_loss=train_loss, val_loss=val_loss,
                    samples_per_sec=sps)
        if verbose and lead:
            print(f"epoch {epoch}: train {train_loss:.5f} "
                  f"val {val_loss:.5f} ({sps:,.0f} samples/s)", flush=True)
        if early is not None and np.isfinite(val_loss) and \
                early.should_stop(val_loss):
            break
    return state, history
