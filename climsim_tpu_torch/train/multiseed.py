"""Multi-seed training: K independent replicas of one recipe advanced by
one ``train_step`` call (the counterpart of
``climsim_tpu.train.multiseed``).

JAX stacks the K states and vmaps the recipe's step over them.  Here the
K trainers stay separate and the step loops over them, each on the same
batch: a replica is its single-seed run, step for step.  Per-replica
``lr_scales`` make the same machinery a learning-rate sweep.

With ``rules`` over a (data, model) mesh the seed axis splits over the
model axis (``climsim_tpu/train/multiseed.py:90-114``): rank m builds only
its contiguous K / model_size replicas, each recipe gets ``rules`` and
trains through its own DDP wrapper on the data group, on this rank's rows
of the shared batch.  The per-seed metrics, ``predict`` and ``sample``
gather the replicas over the model group into their K-long results, so
they equal the 1-process ones on every rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch



@dataclass
class SeedStates:
    """The replicas' train states: what JAX's stacked TrainState is.  Under
    a model axis ``states`` are this rank's replicas, ``first`` the
    global index of the first, and ``num_seeds`` counts them all."""

    states: list
    first: int = 0
    num_seeds: int | None = None

    def __post_init__(self):
        if self.num_seeds is None:
            self.num_seeds = len(self.states)

    @property
    def params(self) -> list:
        return [s.params for s in self.states]

    @property
    def lr_scale(self) -> np.ndarray:
        """This rank's replicas' scales."""
        return np.asarray([s.lr_scale for s in self.states], np.float32)

    def set_lr_scale(self, scales: Sequence[float]) -> None:
        """One scale a seed, all ``num_seeds`` of them; each replica here
        takes its own."""
        if len(scales) != self.num_seeds:
            raise ValueError(f"{len(scales)} scales for "
                             f"{self.num_seeds} replicas")
        for s, v in zip(self.states, scales[self.first:]):
            s.lr_scale = float(v)


class MultiSeedTrainer:
    """K seed replicas of one recipe trainer.

    ``train_step(state, xb, yb)`` and ``eval_step(params, xb, yb)`` take
    the replicas' states or models and one shared batch; their metrics are
    stacked to (K,).  ``predict(params, x_raw)`` gives (K, N, D_out);
    ``sample(params, x_raw, seed, n)`` (K, N, D_out, n), replica k from
    seed + k; ``stage2_step`` is there when the recipe has one (HSR).
    Under ``rules`` ``trainers`` are this rank's replicas, and the (K,)
    and (K, ...) results gather them all.
    """

    def __init__(self, trainers: list, state: SeedStates, rules=None):
        self.trainers = trainers
        self.state = state
        self.rules = rules
        t0 = trainers[0]
        self.sample = self._sample if t0.sample is not None else None
        self.stage2_step = (self._steps("stage2_step")
                            if t0.stage2_step is not None else None)
        self.train_step = self._steps("train_step")

    @property
    def num_seeds(self) -> int:
        return self.state.num_seeds

    def _stacked(self, values: list) -> torch.Tensor:
        """This rank's replicas' values -> all K, stacked on axis 0."""
        out = torch.stack(values)
        return out if self.rules is None else self.rules.gather_model(out)

    def _metrics(self, metrics: list[dict]) -> dict:
        return {k: self._stacked([m[k] for m in metrics]) for k in metrics[0]}

    def unstack_params(self, params=None) -> list:
        """The replicas' models."""
        return list(self.state.params if params is None else params)

    def _steps(self, name: str) -> Callable:
        def step(state: SeedStates, xb, yb):
            metrics = []
            for k, (t, st) in enumerate(zip(self.trainers, state.states)):
                state.states[k], m = getattr(t, name)(st, xb, yb)
                metrics.append(m)
            return state, self._metrics(metrics)

        return step

    def eval_step(self, params, xb, yb) -> dict:
        return self._metrics([t.eval_step(p, xb, yb)
                              for t, p in zip(self.trainers, params)])

    def predict(self, params, x_raw) -> torch.Tensor:
        x = torch.as_tensor(np.asarray(x_raw))
        with torch.no_grad():
            return self._stacked([t.apply(p, x)
                                  for t, p in zip(self.trainers, params)])

    def _sample(self, params, x_raw, seed: int, num_samples: int):
        x = torch.as_tensor(np.asarray(x_raw))
        k0 = self.state.first
        with torch.no_grad():
            return self._stacked([t.sample(p, x, seed + k0 + k, num_samples)
                                  for k, (t, p) in enumerate(
                                      zip(self.trainers, params))])


def multiseed(recipe_fn: Callable, spec, stats, sample_batch,
              seeds: Sequence[int], rules=None,
              lr_scales: Sequence[float] | None = None,
              **recipe_kw) -> MultiSeedTrainer:
    """K replicas of ``recipe_fn(spec, stats, sample_batch, seed,
    **recipe_kw)``, one a seed, with optional per-replica learning-rate
    multipliers (``TrainState.lr_scale``); ``rules``, where given, goes to
    every replica's recipe, and this rank builds only its replicas of the
    seeds split over the model axis."""
    if lr_scales is not None and len(lr_scales) != len(seeds):
        raise ValueError(f"{len(lr_scales)} lr_scales for {len(seeds)} "
                         "seeds")
    lo, hi = 0, len(seeds)
    if rules is not None:
        recipe_kw["rules"] = rules
        lo, hi = rules.split(len(seeds))
    trainers = [recipe_fn(spec, stats, sample_batch, s, **recipe_kw)
                for s in list(seeds)[lo:hi]]
    state = SeedStates([t.state for t in trainers], lo, len(seeds))
    if lr_scales is not None:
        state.set_lr_scale(lr_scales)
    return MultiSeedTrainer(trainers, state, rules)


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
