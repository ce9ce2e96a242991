"""The train step with its collective spelled out (the counterpart of
``climsim_tpu.train.step_shardmap``).

The default step (``train.step``) hands the gradient reduction to DDP,
which buckets the gradients and overlaps their all-reduce with the
backward.  Here each rank runs the backward on its rows, then the
gradients, the loss and the aux metrics go through ONE explicit
all-reduce of a flat vector over the data group, divided by its size:
the counterpart of ``jax.lax.psum(g, "data") / n_shards``
(``climsim_tpu/train/step_shardmap.py:44-49``).  Useful where what
communicates must be under the caller's control (to compress or quantize
gradients before the reduce).  The update (clip, ``lr_scale``, optimizer)
and the dropout seeds are the default step's, so the two agree to the
order of the sums.
"""

from __future__ import annotations

from typing import Callable

import torch

from .step import (Optimizer, TrainState, _apply_update, _fill_missing_grads,
                   _step_seed)


def make_shardmap_train_step(loss_fn: Callable, optimizer: Optimizer,
                             rules):
    """loss_fn(model, seed, xb, yb) -> (scalar, aux); xb and yb are this
    rank's rows.  Returns step(state, xb, yb) -> (state, metrics), the
    metrics the ranks' means."""

    def step(state: TrainState, xb, yb):
        model = state.params
        state.opt_state.zero_grad(set_to_none=True)
        loss, aux = loss_fn(model, _step_seed(state, rules), xb, yb)
        loss.backward()
        _fill_missing_grads(model)
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        metrics = [loss.detach(), *(v.detach() for v in aux.values())]
        flat = torch.cat([t.reshape(-1).float() for t in grads + metrics])
        torch.distributed.all_reduce(flat, group=rules.mesh.data_group)
        flat /= rules.world_size
        at = 0
        for g in grads:
            g.copy_(flat[at:at + g.numel()].view_as(g))
            at += g.numel()
        mean = []
        for m in metrics:
            mean.append(flat[at:at + m.numel()].reshape(m.shape).to(m.dtype))
            at += m.numel()
        _apply_update(optimizer, state)
        return state, dict(zip(("loss", *aux), mean))

    return step
