"""Multi-seed training: K independent replicas of one recipe advanced by
one ``train_step`` call (the counterpart of
``climsim_tpu.train.multiseed``).

JAX stacks the K states and vmaps the recipe's step over them.  Here the
K trainers stay separate and the step loops over them, each on the same
batch: a replica is its single-seed run, step for step.  Per-replica
``lr_scales`` make the same machinery a learning-rate sweep.  With
``rules`` the seed axis is replicated over the data axis (a model axis
of size 1, ``climsim_tpu/train/multiseed.py:90-114``): each replica's
recipe gets ``rules`` and trains through its own DDP wrapper on this
rank's rows, so every rank holds every replica.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch



@dataclass
class SeedStates:
    """The K replicas' train states: what JAX's stacked TrainState is."""

    states: list

    @property
    def params(self) -> list:
        return [s.params for s in self.states]

    @property
    def lr_scale(self) -> np.ndarray:
        return np.asarray([s.lr_scale for s in self.states], np.float32)

    def set_lr_scale(self, scales: Sequence[float]) -> None:
        if len(scales) != len(self.states):
            raise ValueError(f"{len(scales)} scales for "
                             f"{len(self.states)} replicas")
        for s, v in zip(self.states, scales):
            s.lr_scale = float(v)


def _stacked(metrics: list[dict]) -> dict:
    return {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}


class MultiSeedTrainer:
    """K seed replicas of one recipe trainer.

    ``train_step(state, xb, yb)`` and ``eval_step(params, xb, yb)`` take
    the replicas' states or models and one shared batch; their metrics are
    stacked to (K,).  ``predict(params, x_raw)`` gives (K, N, D_out);
    ``sample(params, x_raw, seed, n)`` (K, N, D_out, n), replica k from
    seed + k; ``stage2_step`` is there when the recipe has one (HSR).
    """

    def __init__(self, trainers: list, state: SeedStates):
        self.trainers = trainers
        self.state = state
        t0 = trainers[0]
        self.sample = self._sample if t0.sample is not None else None
        self.stage2_step = (self._steps("stage2_step")
                            if t0.stage2_step is not None else None)
        self.train_step = self._steps("train_step")

    @property
    def num_seeds(self) -> int:
        return len(self.trainers)

    def unstack_params(self, params=None) -> list:
        """The replicas' models."""
        return list(self.state.params if params is None else params)

    def _steps(self, name: str) -> Callable:
        def step(state: SeedStates, xb, yb):
            metrics = []
            for k, (t, st) in enumerate(zip(self.trainers, state.states)):
                state.states[k], m = getattr(t, name)(st, xb, yb)
                metrics.append(m)
            return state, _stacked(metrics)

        return step

    def eval_step(self, params, xb, yb) -> dict:
        return _stacked([t.eval_step(p, xb, yb)
                         for t, p in zip(self.trainers, params)])

    def predict(self, params, x_raw) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x_raw))
        with torch.no_grad():
            return torch.stack([t.apply(p, x)
                                for t, p in zip(self.trainers, params)])

    def _sample(self, params, x_raw, seed: int, num_samples: int):
        x = torch.as_tensor(np.asarray(x_raw))
        with torch.no_grad():
            return torch.stack([t.sample(p, x, seed + k, num_samples)
                                for k, (t, p) in enumerate(
                                    zip(self.trainers, params))])


def multiseed(recipe_fn: Callable, spec, stats, sample_batch,
              seeds: Sequence[int], rules=None,
              lr_scales: Sequence[float] | None = None,
              **recipe_kw) -> MultiSeedTrainer:
    """K replicas of ``recipe_fn(spec, stats, sample_batch, seed,
    **recipe_kw)``, one a seed, with optional per-replica learning-rate
    multipliers (``TrainState.lr_scale``); ``rules``, where given, goes to
    every replica's recipe."""
    if rules is not None:
        recipe_kw["rules"] = rules
    if lr_scales is not None and len(lr_scales) != len(seeds):
        raise ValueError(f"{len(lr_scales)} lr_scales for {len(seeds)} "
                         "seeds")
    trainers = [recipe_fn(spec, stats, sample_batch, s, **recipe_kw)
                for s in seeds]
    state = SeedStates([t.state for t in trainers])
    if lr_scales is not None:
        state.set_lr_scale(lr_scales)
    return MultiSeedTrainer(trainers, state)


def seed_spread(preds_k: np.ndarray):
    """Per-output seed spread diagnostics: (K, N, D) -> dict of (D,)
    arrays.  ``std`` is the across-seed std of predictions averaged over
    samples -- the seed-robustness measure the reference reports by
    training separate jobs."""
    preds_k = np.asarray(preds_k)
    mean = preds_k.mean(axis=0)
    std = preds_k.std(axis=0)
    return {
        "mean_spread": std.mean(axis=0),
        "max_spread": std.max(axis=0),
        "ensemble_mean": mean,
    }
