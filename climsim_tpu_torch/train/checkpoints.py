"""Checkpointing: top-K retention keyed by a validation metric, and resume.

The counterpart of ``climsim_tpu.train.checkpoints``: it replaces the
reference's Modulus .mdlus top-K dance (train_unet_h5loader.py:296-307,
473-500) and the Keras best/last ModelCheckpoint pair
(step2_retrain.py:253-263) with one small manager.  A checkpoint is a
``torch.save`` of state_dicts (a module is saved as its state_dict),
read back with ``weights_only=True``: no pickled code runs on load.

The JAX package's ``OrbaxCheckpointer`` (sharded, asynchronous, restored
onto another mesh) belongs with distribution and is not ported here.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import torch


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
