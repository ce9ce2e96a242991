"""Training cells: the port's trainer stepped by its loader's epoch runner.

Set-up draws the pool of raw columns and targets (the frozen generator)
and the weights (on the card, from the seed), builds the configuration's
recipe (``climsim_tpu_torch.train.recipes``) and loads the weights into
it, puts the pool on the card in a ``DeviceResidentLoader`` with block
shuffling, and runs ``warm_epochs`` epochs through the epoch runner over
the trainer's ``train_step``.  That runner, the same object, then drives
the window, an epoch a call, until ``--seconds`` have passed; the card is
synchronized at both ends, so ``train_samples_per_s`` is every sample of
every step the window dispatched over the whole window.

The runner's step is the trainer's, with a recorder that keeps, of the
first ``follow`` steps of set-up, the raw batches, the losses, the first
gradient as Adam got it (its first moment after one step over 1 - beta1),
the parameters after the last, and the rows that the model's forward
received in each (a forward pre-hook on the trainer's model, removed
before the window).  After the window (the program freed) the reference
follows those steps from the same weights, and the run is correct where
each gap is within the cell's limit.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from .. import harness
from ..reference.common import CASTS, load_norms
from ..traffic.synthetic import synthetic_split
from ..traffic.varspec import Layout


class Recorder:
    """``step`` with a record of its first ``n`` calls, and of the rows
    the model's forward received in each, counted by a forward pre-hook
    until ``close``."""

    def __init__(self, step, model, n: int):
        self.step, self.model, self.n = step, model, n
        self.batches, self.losses, self.rows_seen = [], [], []
        self.first_grad = self.after = None
        self._rows = 0
        self._hook = model.register_forward_pre_hook(self._count)

    def _count(self, module, args):
        self._rows += int(args[0].shape[0])

    def close(self) -> None:
        """Remove the hook: the window runs the model as it is."""
        if self._hook is not None:
            self._hook.remove()
            self._hook = None

    def __call__(self, state, xb, yb):
        self._rows = 0
        state, m = self.step(state, xb, yb)
        if len(self.batches) < self.n:
            self.rows_seen.append(self._rows)
            self._record(state, xb, yb, m)
        return state, m

    def _record(self, state, xb, yb, m) -> None:
        import torch

        self.batches.append((harness.host_copy(xb), harness.host_copy(yb)))
        self.losses.append(float(m["loss"]))
        named = dict(self.model.named_parameters())
        if self.first_grad is None:
            opt = state.opt_state
            b1 = opt.param_groups[0]["betas"][0]
            # Adam's first moment after one update is (1 - b1) g; a
            # parameter it never updated has no moment: no gradient
            self.first_grad = {
                k: (opt.state[p]["exp_avg"].cpu() / (1 - b1)
                    if "exp_avg" in opt.state.get(p, {})
                    else torch.zeros(p.shape))
                for k, p in named.items()}
        if len(self.batches) == self.n:
            self.after = {k: harness.host_copy(p) for k, p in named.items()}


def build(ctx, x, y):
    """(trainer, loader, weights): the cell's trainer on ``ctx.device``
    with the weights drawn from the seed loaded, its loader over the pool
    (x, y), and a host copy of those weights."""
    import torch

    from climsim_tpu_torch.data.pipeline import DeviceResidentLoader
    from climsim_tpu_torch.norms import NormStats
    from climsim_tpu_torch.train import recipes
    from climsim_tpu_torch.varspec import get_varspec

    cfg, mix = ctx.config, ctx.mix
    tr_cfg = cfg["train"]
    b = mix["batch"]
    stats = NormStats.from_npz(ctx.cell.path(cfg["norms"]))
    model_kw = ({tr_cfg["model_as"]: dict(cfg["model"])}
                if tr_cfg["model_as"] else dict(cfg["model"]))
    tr = getattr(recipes, tr_cfg["recipe"])(
        get_varspec(cfg["varspec"]), stats, (x[:b], y[:b]), ctx.seed,
        steps_per_epoch=tr_cfg["steps_per_epoch"],
        compute_dtype=getattr(torch, cfg["precision"]["compute"]),
        device=ctx.device, **model_kw)
    harness.say(ctx.t_process, f"{tr_cfg['recipe']} built on the card")
    weights = ctx.reference.make_weights(cfg, ctx.seed, ctx.device)
    tr.model.load_state_dict(weights, strict=True)
    host = {k: harness.host_copy(v) for k, v in weights.items()}
    loader = DeviceResidentLoader(x, y, b, seed=ctx.seed,
                                  block_shuffle=mix["block_shuffle"],
                                  device=ctx.device)
    return tr, loader, host


def pool(ctx):
    """The raw (x, y) pool of the cell, from the seed."""
    mix = ctx.mix
    lay = Layout(ctx.config["varspec"])
    n = mix["batch"] * mix["pool_batches"]
    x, y = synthetic_split(lay, n, seed=ctx.seed)
    if mix.get("icol_cycle"):
        x[:, lay.input_slices["icol"]] = (np.arange(n) % mix["icol_cycle"]
                                          + 1)[:, None]
    return x, y


def foreign_rows(batches, x: np.ndarray) -> int:
    """Rows of the recorded batches that are not rows of the pool, or that
    repeat a row of an earlier batch: each step must see rows of its own."""
    pool_rows = {r.tobytes() for r in x}
    seen, bad = set(), 0
    for xb, _ in batches:
        for r in xb.numpy():
            key = r.tobytes()
            bad += key not in pool_rows or key in seen
            seen.add(key)
    return bad


def rows_unseen(batches, rows_seen) -> int:
    """Rows of the recorded batches that the model's forward did not
    receive in their step, or received besides them: the reference's step
    takes every row of its batch once."""
    return sum(abs(len(xb) - seen) for (xb, _), seen in zip(batches,
                                                            rows_seen))


def _sync(device) -> None:
    import torch

    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


def run(ctx) -> dict:
    import torch

    mix = ctx.mix
    x, y = pool(ctx)
    harness.say(ctx.t_process, f"pool of {x.shape[0]} rows drawn")
    tr, loader, weights = build(ctx, x, y)
    harness.say(ctx.t_process, "trainer built, weights loaded, pool on the "
                "card")
    cuda = str(ctx.device).startswith("cuda")
    rec = Recorder(tr.train_step, tr.model, mix["follow"])
    runner = loader.make_epoch_runner(rec)
    state, _ = runner(tr.state, mix["warm_epochs"])
    rec.close()
    _sync(ctx.device)
    harness.say(ctx.t_process, f"{mix['warm_epochs']} warm-up epochs run")
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    epochs, losses = 0, []
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t_process
    tracer = ctx.tracer
    marks = {}       # epochs done when the stretch started and stopped
    while True:
        if tracer is not None:
            event = tracer.poll(time.perf_counter() - t0)
            if event:
                marks[event] = epochs
        with torch.profiler.record_function("portbench.epoch"):
            state, m = runner(state, 1)
        epochs += 1
        losses.append(m["loss"])
        if time.perf_counter() - t0 >= ctx.seconds:
            break
    if tracer is not None and tracer.on:
        tracer.stop()
        marks["stop"] = epochs
    _sync(ctx.device)
    t_end = time.perf_counter()
    window_s = t_end - t0
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    spe, b = loader.steps_per_epoch, loader.batch_size
    steps = epochs * spe
    finite = torch.isfinite(torch.cat([v.reshape(-1) for v in losses]))
    failed = int((~finite).sum()) * spe
    samples = steps * b
    # the readers' rate leaves out the traced stretch (its syncs and the
    # profiler's cost): the epochs before it over the time before it,
    # and those after it over the time after it
    rate_epochs, rate_s = epochs, window_s
    if "start" in marks:
        rate_epochs = marks["start"] + epochs - marks["stop"]
        rate_s = (tracer.t_start - t0) + (t_end - tracer.t_stop)
    data = {"kind": "train", "config": ctx.config, "reference": ctx.reference,
            "samples": rate_epochs * spe * b, "window_s": rate_s,
            "batch": mix["batch"],
            "steps_traced": (marks["stop"] - marks["start"]) * spe
            if "start" in marks else 0,
            "window_peak_bytes": window_peak, "trace": tracer}

    batches, prog_loss = rec.batches, rec.losses
    prog_grad, prog_after = rec.first_grad, rec.after
    unseen = rows_unseen(batches, rec.rows_seen)
    del runner, rec, tr, loader, state, m, losses
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = compare(ctx, x, weights, batches, prog_loss, prog_grad,
                     prog_after, unseen)
    harness.say(ctx.t_process, "reference followed")
    return {"correct": all(c["value"] <= c["limit"] for c in checks.values())
            and failed == 0,
            "attempted": steps, "failed": failed,
            "end_to_end": {
                "train_samples_per_s": {"value": samples / window_s,
                                        "unit": "samples/s"},
                "setup_s": {"value": setup_s, "unit": "s"}},
            "checks": checks,
            "memory_peak_bytes": max(setup_peak, window_peak),
            "data": data}


def follow(ctx, weights, batches, cast="exact") -> dict:
    """The reference's first steps over the recorded raw batches, from the
    weights on the host; ``cast`` "fp8" gives the control."""
    import torch

    dev = ctx.device
    norms = load_norms(ctx.cell.path(ctx.config["norms"]))
    out = ctx.reference.train(
        ctx.config, {k: v.to(dev) for k, v in weights.items()}, norms,
        [(xb.to(dev), yb.to(dev)) for xb, yb in batches], CASTS[cast])
    out = {"loss": out["loss"],
           "grad": {k: v.cpu() for k, v in out["grad"].items()},
           "change": {k: v.cpu() for k, v in out["change"].items()}}
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    return out


def rows_unmoved(prog_grad: dict, ref_grad: dict) -> int:
    """Rows (slices along the first axis) of the leaves that the
    reference's first gradient moves and the program's leaves at exactly
    zero: an embedding's rows are moved only by the batch rows that look
    them up, so a step that leaves rows of its batch out leaves some at
    zero."""
    n = 0
    for k, r in ref_grad.items():
        p = prog_grad[k]
        moved_r = (r.reshape(r.shape[0], -1) != 0).any(1)
        moved_p = (p.reshape(p.shape[0], -1) != 0).any(1)
        n += int((moved_r & ~moved_p).sum())
    return n


def gaps(prog: dict, ref: dict) -> dict:
    """The gaps of a run's first steps (``prog``: "loss", "grad", "change")
    to the reference's: the loss of each step (relative, the widest), the
    first gradient and the change of the parameters over the steps (each
    by ``harness.gap_by_leaf``; the change over the leaves
    ``harness.counted_leaves`` keeps), the first gradient's difference
    (``harness.diff_by_leaf``), and ``rows_unmoved``."""
    keep = harness.counted_leaves(ref["grad"])
    return {"loss_gap": max(abs(p - r) / abs(r)
                            for p, r in zip(prog["loss"], ref["loss"])),
            "grad_gap": harness.gap_by_leaf(prog["grad"], ref["grad"]),
            "grad_diff": harness.diff_by_leaf(prog["grad"], ref["grad"]),
            "change_gap": harness.gap_by_leaf(prog["change"], ref["change"],
                                              keep),
            "rows_unmoved": rows_unmoved(prog["grad"], ref["grad"])}


def compare(ctx, x, weights, batches, prog_loss, prog_grad, prog_after,
            unseen: int) -> dict:
    prog = {"loss": prog_loss, "grad": prog_grad,
            "change": {k: prog_after[k] - weights[k] for k in weights}}
    got = gaps(prog, follow(ctx, weights, batches))
    got["batch_rows_foreign"] = foreign_rows(batches, x)
    got["batch_rows_unseen"] = unseen
    for k, v in got.items():
        if k not in ctx.limits:
            harness.say(ctx.t_process, f"{k} {v!r} (read, not compared)")
    return {k: {"value": got[k], "limit": lim}
            for k, lim in ctx.limits.items()}
