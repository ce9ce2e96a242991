"""Checkpointing: top-K retention keyed by a validation metric, and resume.

The counterpart of ``climsim_tpu.train.checkpoints``: it replaces the
reference's Modulus .mdlus top-K dance (train_unet_h5loader.py:296-307,
473-500) and the Keras best/last ModelCheckpoint pair
(step2_retrain.py:253-263) with one small manager.  A checkpoint is a
``torch.save`` of state_dicts (a module is saved as its state_dict),
read back with ``weights_only=True``: no pickled code runs on load.

``DistributedCheckpointer`` is the counterpart of the JAX package's
``OrbaxCheckpointer``: the whole train state, saved asynchronously by
every rank through ``torch.distributed.checkpoint`` and restored onto
another world size.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist


def _tensors(tree):
    """A module as its state_dict; a dict, list or tuple of them walked."""
    if isinstance(tree, torch.nn.Module):
        return tree.state_dict()
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return tree


def save_state(path: str, tree) -> None:
    """Atomic save: write to ``path + ".tmp"``, then rename, so a crash in
    the middle of a write never destroys the previous good checkpoint
    (the timed crash-recovery file must survive the very event it exists
    for)."""
    tmp = path + ".tmp"
    torch.save(_tensors(tree), tmp)
    os.replace(tmp, path)


def load_state(path: str, template=None):
    """The saved tree; with a module ``template``, loaded into it (strict)
    and the module returned.  Tensors are read onto the CPU."""
    tree = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(template, torch.nn.Module):
        template.load_state_dict(tree)
        return template
    return tree


@dataclass
class TopKCheckpointer:
    directory: str
    k: int = 5
    mode: str = "min"  # min for losses, max for R2
    _entries: list = field(default_factory=list)  # [(metric, step, name)]

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        meta = os.path.join(self.directory, "topk.json")
        if os.path.exists(meta):
            with open(meta) as f:
                self._entries = [tuple(e) for e in json.load(f)]

    def _better(self, a, b):
        return a < b if self.mode == "min" else a > b

    def _resolve(self, path: str) -> str:
        # topk.json may have been written on another machine or the
        # directory copied or moved (the deployment workflow): a recorded
        # path is trusted for its basename only
        return os.path.join(self.directory, os.path.basename(path))

    def maybe_save(self, metric: float, step: int, tree) -> bool:
        """Insert if within the top K; deletes the evicted worst (the
        reference's behavior, train_unet_h5loader.py:473-500)."""
        metric = float(metric)
        if len(self._entries) >= self.k:
            worst = (max if self.mode == "min" else min)(
                self._entries, key=lambda e: e[0])
            if not self._better(metric, worst[0]):
                return False
            self._entries.remove(worst)
            wp = self._resolve(worst[2])
            if os.path.exists(wp):
                os.remove(wp)
        name = f"ckpt_step{step}.pt"
        save_state(os.path.join(self.directory, name), tree)
        # the basename only: the directory stays relocatable
        self._entries.append((metric, step, name))
        self._flush()
        return True

    def save_last(self, step: int, tree) -> str:
        """The always-updated resume checkpoint (the warm-restart path,
        train_unet_h5loader.py:177-189)."""
        path = os.path.join(self.directory, "last.pt")
        save_state(path, tree)
        with open(os.path.join(self.directory, "last.json"), "w") as f:
            json.dump({"step": step}, f)
        return path

    def best(self):
        if not self._entries:
            return None
        return (min if self.mode == "min" else max)(self._entries,
                                                    key=lambda e: e[0])

    def load_best(self, template=None):
        b = self.best()
        return None if b is None else load_state(self._resolve(b[2]),
                                                 template)

    def _flush(self):
        with open(os.path.join(self.directory, "topk.json"), "w") as f:
            json.dump(self._entries, f)


@dataclass
class TimedCheckpointer:
    """Wall-clock periodic checkpointing (the reference saves every 1200 s
    during torch training: hsr.py:120-121, tools.py:26-49).  Call
    ``maybe_save`` from the training loop; it writes at most once an
    interval."""

    path: str
    interval_seconds: float = 1200.0
    _last: float | None = None

    def maybe_save(self, tree) -> bool:
        now = time.monotonic()
        if self._last is not None and \
                now - self._last < self.interval_seconds:
            return False
        save_state(self.path, tree)
        self._last = now
        return True


def _train_state_dict(state) -> dict:
    from torch.distributed.checkpoint.state_dict import get_state_dict

    model, optim = get_state_dict(state.params, state.opt_state)
    return {"model": model, "optim": optim, "step": state.step,
            "lr_scale": state.lr_scale, "rng": state.rng.get_state()}


def _load_train_state(state, sd: dict) -> None:
    from torch.distributed.checkpoint.state_dict import set_state_dict

    set_state_dict(state.params, state.opt_state,
                   model_state_dict=sd["model"], optim_state_dict=sd["optim"])
    state.step = int(sd["step"])
    state.lr_scale = float(sd["lr_scale"])
    state.rng.set_state(sd["rng"])


def _rpn_state_dict(tr) -> dict:
    """An RPN trainer's members under their global indices: each one's
    rows of the trained net, the prior and Adam's moments, so that a
    state saved from M model ranks restores onto any other M."""
    opt = tr.opt_state
    members = {}
    named = dict(tr.ensemble.named_parameters())
    net = {n: p for n, p in named.items() if n.startswith("net.")}
    for j in range(tr.ensemble.ensemble_size):
        # copies: a saved view would carry its whole stack's storage
        m = {n: p.detach()[j].clone() for n, p in named.items()}
        for n, p in net.items():
            st = opt.state.get(p)
            for k in ("exp_avg", "exp_avg_sq"):
                m[f"{k}.{n}"] = (st[k][j].clone() if st
                                 else torch.zeros_like(p[j]))
        members[str(tr.first + j)] = m
    adam_step = {n: (opt.state[p]["step"] if opt.state.get(p)
                     else torch.zeros((), dtype=torch.float32))
                 for n, p in net.items()}
    return {"members": members, "adam_step": adam_step, "step": tr.step}


def _load_rpn_state(tr, sd: dict) -> None:
    opt = tr.opt_state
    named = dict(tr.ensemble.named_parameters())
    members = [sd["members"][str(tr.first + j)]
               for j in range(tr.ensemble.ensemble_size)]
    with torch.no_grad():
        for n, p in named.items():
            p.copy_(torch.stack([m[n] for m in members]))
    for n, p in named.items():
        if not n.startswith("net."):
            continue
        opt.state[p] = {
            "step": sd["adam_step"][n].detach().clone().cpu(),
            **{k: torch.stack([m[f"{k}.{n}"] for m in members]).to(
                p.device, p.dtype) for k in ("exp_avg", "exp_avg_sq")}}
    tr.step = int(sd["step"])
    if tr.step == 0:   # a state saved before any update: Adam's is empty
        opt.state.clear()


def _state_dict_of(state) -> dict:
    """What a checkpoint holds of ``state``: a ``TrainState`` (model,
    optimizer, ``step``, ``lr_scale``, the generator's state), a
    ``SeedStates`` (each replica's under its seed's global index) or an
    ``RPNTrainer`` (each member under its global index)."""
    if hasattr(state, "states"):
        return {"seeds": {str(state.first + j): _train_state_dict(s)
                          for j, s in enumerate(state.states)}}
    if hasattr(state, "ensemble"):
        return {"rpn": _rpn_state_dict(state)}
    return _train_state_dict(state)


def _load_state_dict_into(state, sd: dict) -> None:
    """``sd`` (``_state_dict_of``'s layout, loaded) into ``state``."""
    if hasattr(state, "states"):
        for j, s in enumerate(state.states):
            _load_train_state(s, sd["seeds"][str(state.first + j)])
    elif hasattr(state, "ensemble"):
        _load_rpn_state(state, sd["rpn"])
    else:
        _load_train_state(state, sd)


class DistributedCheckpointer:
    """Asynchronous checkpoints of a whole train state on
    ``torch.distributed.checkpoint`` (the counterpart of
    ``OrbaxCheckpointer``, ``climsim_tpu/train/checkpoints.py:128-197``).

    ``save`` stages the state (``_state_dict_of``: model, optimizer,
    ``step``, ``lr_scale``, the generator's state) and writes it on a
    background thread (``dcp.async_save``): training continues during the
    write.  Every rank of its group calls it.  Replicated tensors are
    written once; a state split over a model axis (an RPN trainer's
    members, a ``SeedStates``'s replicas) is saved member by member and
    replica by replica under their global indices, so it restores onto
    another model axis, 1 included: each rank reads the members it holds.
    Its collectives run on a gloo group of its own (all the default
    group's ranks, or ``ranks``), so a write in flight never interleaves
    with the training step's on NCCL.  Without a process group the save
    is a single process's; with one, never.  A run saved by N ranks
    restores into any world size, one process included.

    Reference analog: the .mdlus save/from_checkpoint pair
    (train_unet_h5loader.py:296-307,513), synchronous and single-device.
    """

    def __init__(self, directory: str, ranks=None):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        # a collective where a group exists: every rank makes it together
        self.ranks = None if ranks is None else tuple(ranks)
        self._group = (dist.new_group(ranks=None if ranks is None
                                      else list(ranks), backend="gloo")
                       if dist.is_initialized() else None)
        self._pending = None

    def for_ranks(self, ranks) -> "DistributedCheckpointer":
        """The checkpointer of this directory over ``ranks`` of the default
        group (a collective: every rank calls it, those outside ``ranks``
        too); itself where ``ranks`` are already its own, or where there is
        no process group."""
        ranks = tuple(ranks)
        whole = (tuple(range(dist.get_world_size()))
                 if dist.is_initialized() else ranks)
        if (self.ranks or whole) == ranks:
            return self
        self.wait()
        return DistributedCheckpointer(self.directory, ranks)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state) -> None:
        """Start writing ``state`` as ``step``; a save still in flight is
        waited for first."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        self._pending = dcp.async_save(_state_dict_of(state),
                                       checkpoint_id=self._path(step),
                                       process_group=self._group)

    def wait(self, timeout: float | None = None) -> None:
        """Block until the save in flight, if any, is committed (or
        ``timeout`` seconds pass: TimeoutError)."""
        if self._pending is not None:
            self._pending.result(timeout)
            self._pending = None

    def steps(self) -> list[int]:
        """Committed steps.  A directory without DCP's ``.metadata`` (an
        in-flight or crashed write) or without an integer suffix is
        skipped, as ``climsim_tpu/train/checkpoints.py:163-175`` skips
        orbax's temporary directories."""
        out = []
        for d in os.listdir(self.directory):
            suffix = d[len("step_"):]
            if (d.startswith("step_") and suffix.isdigit()
                    and os.path.exists(os.path.join(self.directory, d,
                                                    ".metadata"))):
                out.append(int(suffix))
        return sorted(out)

    def restore(self, template, step: int | None = None):
        """Load ``step`` (default: the latest) into ``template``, a state
        of the same model and optimizer on the current world size (a
        ``TrainState``, ``SeedStates`` or ``RPNTrainer``), in place;
        returns it, or None when nothing is committed."""
        import torch.distributed.checkpoint as dcp

        self.wait()
        if step is None:
            ss = self.steps()
            if not ss:
                return None
            step = ss[-1]
        sd = _state_dict_of(template)
        dcp.load(sd, checkpoint_id=self._path(step),
                 process_group=self._group)
        _load_state_dict_into(template, sd)
        return template

