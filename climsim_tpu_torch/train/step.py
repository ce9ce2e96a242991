"""Train, eval and predict steps (the counterpart of
``climsim_tpu.train.step``).

JAX jits one step and donates the state's buffers; here the step runs
eagerly and updates the parameters and the optimizer's moments in place.
optax's ``adam(schedule)`` becomes ``torch.optim.Adam``: before each
update the group's learning rate is set to ``schedule(count) *
lr_scale``, where ``count`` is the number of updates made before this one,
as optax counts.  Both put eps (1e-8) outside the square root.

The state's ``rng`` is a host ``torch.Generator``: each step draws the
step's dropout seed from it (JAX splits its key, ``step.py:55``), so the
generator advances once a step and the card never waits for it.

With ``rules`` (``parallel.mesh.ShardingRules``) each rank runs the step
on its rows of the global batch.  The train step runs the model through
DDP (``rules.ddp``): its bucketed all-reduce of the gradients overlaps
the backward, the counterpart of the psum XLA places in the JAX step
(``climsim_tpu/train/step.py:46-79``).  ``state.params`` stays the bare
module, so checkpoints and wrappers never meet DDP's ``module.`` keys.
The metrics, train and eval, are means over the ranks, so every rank
holds the global value.  ``train.step_shardmap`` spells the same
reduction out as one explicit all-reduce.

Dropout under ``rules``: every rank draws the same step seed from its
generator (all ranks' generators are equal), and a rank other than 0
folds its rank into it (``_step_seed``), as the JAX shard_map step does
(``climsim_tpu/train/step_shardmap.py:40``).  So a rank's masks are not
the global batch's mask at its rows, which the JAX auto-partitioned step
draws; the two agree only without dropout.  Rank 0 keeps the seed, so a
1-rank run is the run without rules, bit for bit.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..parallel.mesh import pad_to_multiple
from ..utils.profiling import span


@dataclass(frozen=True)
class Optimizer:
    """What optax's GradientTransformation is to the JAX step: ``init``
    builds the torch optimizer (the optimizer state) over the parameters,
    ``schedule(count)`` gives the learning rate of update ``count``, and
    ``clip``, when set, scales the gradients to that global norm first
    (optax.clip_by_global_norm)."""

    make: Callable[[list], torch.optim.Optimizer]
    schedule: Callable[[int], Any]
    clip: float | None = None

    def init(self, params) -> torch.optim.Optimizer:
        return self.make(list(params))


@dataclass
class TrainState:
    params: torch.nn.Module
    opt_state: torch.optim.Optimizer
    step: int                  # updates made so far (optax's count)
    rng: torch.Generator       # host generator of the steps' dropout seeds
    lr_scale: float = 1.0      # host-controlled multiplier (plateau)


def create_train_state(params: torch.nn.Module, optimizer: Optimizer,
                       rng: torch.Generator, rules=None) -> TrainState:
    """The state of ``params``; with ``rules``, rank 0's parameters are
    broadcast first, so every rank starts equal."""
    if rules is not None:
        rules.params(params)
    return TrainState(params=params,
                      opt_state=optimizer.init(params.parameters()),
                      step=0, rng=rng, lr_scale=1.0)


def _clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax.clip_by_global_norm in place: g * max_norm / |g| where the
    global norm exceeds max_norm.  Returns the norm before the clip (a
    device scalar)."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, torch.ones_like(norm),
                        max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def _step_seed(state: TrainState, rules) -> int:
    """The step's dropout seed: one draw of the state's generator, with
    the rank folded in on a rank other than 0."""
    seed = int(torch.randint(2**62, (), generator=state.rng))
    if rules is not None and rules.rank:
        seed = int(np.random.SeedSequence([seed, rules.rank]).generate_state(
            1, np.uint64)[0] >> np.uint64(2))
    return seed


def _fill_missing_grads(model: torch.nn.Module) -> None:
    """optax updates every parameter, with a zero gradient where the loss
    does not reach it (HSR's log-precision net in its MSE stage): its
    moments decay and its count advances.  torch's optimizers skip a
    parameter whose grad is None, so give it zeros.  Under DDP a
    parameter no rank reached has no grad on any rank, so every rank
    fills the same zeros (F6)."""
    for p in model.parameters():
        if p.grad is None and p.requires_grad:
            p.grad = torch.zeros_like(p)


def _apply_update(optimizer: Optimizer, state: TrainState) -> None:
    """Clip, set the learning rate and step the optimizer on the
    gradients in place; advances ``state.step``."""
    model, opt = state.params, state.opt_state
    if optimizer.clip is not None:
        _clip_by_global_norm(
            [p.grad for p in model.parameters() if p.grad is not None],
            optimizer.clip)
    # lr_scale multiplies the learning rate, which is the same as scaling
    # Adam's update, as the JAX step does (step.py:62); scaling the
    # gradients instead would do nothing under Adam
    lr = float(np.float32(optimizer.schedule(state.step))) * state.lr_scale
    for group in opt.param_groups:
        group["lr"] = lr
    opt.step()
    state.step += 1


def make_train_step(loss_fn: Callable, optimizer: Optimizer, rules=None,
                    unused_parameters: bool = False):
    """loss_fn(model, seed, xb, yb) -> (scalar loss, aux dict), where
    ``seed`` is the step's dropout seed (an int; None in evaluation).

    Returns step(state, xb, yb) -> (state, metrics); the state is updated
    in place (where JAX donated it) and returned.  Metrics stay on the
    device: the step never waits for the card.  With ``rules``, xb and yb
    are this rank's rows, ``loss_fn`` gets the DDP wrapper of the model,
    and the metrics are the ranks' means.  ``unused_parameters`` says that
    the loss leaves some parameters without a gradient
    (``ShardingRules.ddp``); it matters only under ``rules``.

    Spans (``utils.profiling``), each with ``step`` = the updates made
    before it: ``train.forward`` (``loss_fn``), ``train.backward``
    (``loss.backward()``; its kernels are launched by the autograd
    engine's thread) and ``train.optimizer`` (clip, learning rate,
    ``opt.step()``).
    """

    def step(state: TrainState, xb, yb):
        model = state.params
        n = state.step
        state.opt_state.zero_grad(set_to_none=True)
        seed = _step_seed(state, rules)
        net = model if rules is None else rules.ddp(model,
                                                    unused_parameters)
        with span("train.forward", step=n):
            loss, aux = loss_fn(net, seed, xb, yb)
        with span("train.backward", step=n):
            loss.backward()
            _fill_missing_grads(model)
        metrics = {k: v.detach() for k, v in (("loss", loss), *aux.items())}
        if rules is not None:
            metrics = rules.mean_metrics(metrics)
        with span("train.optimizer", step=n):
            _apply_update(optimizer, state)
        return state, metrics

    return step


def make_eval_step(loss_fn: Callable, rules=None):
    """evaluate(model, xb, yb) -> metrics; with ``rules``, the ranks' means
    of the metrics of their rows."""

    def evaluate(model, xb, yb):
        with torch.no_grad():
            loss, aux = loss_fn(model, None, xb, yb)
        metrics = {"loss": loss, **aux}
        return metrics if rules is None else rules.mean_metrics(metrics)

    return evaluate


def make_predict_fn(apply_fn: Callable, rules=None,
                    batch_size: int | None = None):
    """Batched full-split inference returning host numpy.  With ``rules``
    each rank predicts a contiguous 1/world_size of every batch (the batch
    padded with its last row to a multiple of the data axis,
    ``pad_to_multiple``) and the parts are gathered over the data group,
    so every rank returns the prediction of the whole split."""

    def predict(model, inputs, bs: int | None = batch_size):
        bs = bs or inputs.shape[0]
        outs = []
        with torch.no_grad():
            for s in range(0, inputs.shape[0], bs):
                xb = np.asarray(inputs[s:s + bs])
                outs.append(
                    apply_fn(model, torch.as_tensor(xb)).float().cpu().numpy()
                    if rules is None else
                    _predict_split(apply_fn, model, xb, rules))
        return np.concatenate(outs, axis=0)

    return predict


def _predict_split(apply_fn, model, xb: np.ndarray, rules) -> np.ndarray:
    padded, n = pad_to_multiple(xb, rules.world_size)
    y = apply_fn(model, torch.as_tensor(rules.local(padded, rules.batch)))
    y = y.float().contiguous()
    parts = [torch.empty_like(y) for _ in range(rules.world_size)]
    torch.distributed.all_gather(parts, y, group=rules.mesh.data_group)
    return torch.cat(parts)[:n].cpu().numpy()


@dataclass
class StepInfo:
    """FLOPs and peak memory of one train step (the counterpart of
    ``CompiledStepInfo``, ``climsim_tpu/train/step.py:121-136``, the
    reference's fvcore FlopCountAnalysis, HSR/training/hpo.py:30-35):
    products counted by ``utils.profiling.cost_analysis``, kernel 5's
    through its registered formula.  XLA's bytes accessed has no
    counterpart."""

    flops_per_step: float
    peak_memory_bytes: float | None

    @classmethod
    def from_step(cls, train_step, state: TrainState, xb, yb) -> "StepInfo":
        """Runs ``train_step`` once on a deep copy of ``state``: the
        caller's state, optimizer and generator do not advance."""
        from ..utils.profiling import cost_analysis

        probe = copy.deepcopy(state)
        c = cost_analysis(lambda: train_step(probe, xb, yb))
        return cls(flops_per_step=c["flops"],
                   peak_memory_bytes=c.get("peak_memory_bytes"))
