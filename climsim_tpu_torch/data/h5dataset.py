"""Multi-file h5 shard dataset with cumulative-index addressing.

Mirrors climsim_dataset_h5 (Unet_v5/training/climsim_datapip_h5.py:13-214):
training data lives in many ``<dir>/train_input.h5`` / ``train_target.h5``
shard pairs (one per chunk/month); a cumulative row index maps a global
sample id to (shard, local row).  Transforms stay in-jit (data.transforms);
this class only does IO.
"""

from __future__ import annotations

import glob
import os

import numpy as np


class H5ShardDataset:
    def __init__(self, parent_dir: str, input_name: str = "train_input.h5",
                 target_name: str = "train_target.h5",
                 dataset_key: str = "data"):
        import h5py

        self._h5py = h5py
        in_paths = sorted(glob.glob(
            os.path.join(parent_dir, "**", input_name), recursive=True))
        if not in_paths:
            raise FileNotFoundError(
                f"no {input_name} under {parent_dir}")
        self.inputs = [h5py.File(p, "r")[dataset_key] for p in in_paths]
        self.targets = [
            h5py.File(p.replace(input_name, target_name), "r")[dataset_key]
            for p in in_paths]
        lens = [d.shape[0] for d in self.inputs]
        for di, dt in zip(self.inputs, self.targets):
            assert di.shape[0] == dt.shape[0], "shard row mismatch"
        # cumulative addressing (climsim_datapip_h5.py:101-104)
        self.cum = np.concatenate([[0], np.cumsum(lens)])
        self.num_samples = int(self.cum[-1])
        self.dx = self.inputs[0].shape[1]
        self.dy = self.targets[0].shape[1]

    def __len__(self):
        return self.num_samples

    def locate(self, idx: int) -> tuple[int, int]:
        shard = int(np.searchsorted(self.cum, idx, side="right") - 1)
        return shard, int(idx - self.cum[shard])

    def __getitem__(self, idx: int):
        s, r = self.locate(int(idx))
        return (np.asarray(self.inputs[s][r], np.float32),
                np.asarray(self.targets[s][r], np.float32))

    def gather(self, indices) -> tuple[np.ndarray, np.ndarray]:
        """Batched gather, grouped by shard and sorted within shard for
        sequential h5 access."""
        indices = np.asarray(indices, np.int64)
        x = np.empty((len(indices), self.dx), np.float32)
        y = np.empty((len(indices), self.dy), np.float32)
        shard_of = np.searchsorted(self.cum, indices, side="right") - 1
        for s in np.unique(shard_of):
            pos = np.nonzero(shard_of == s)[0]
            local = indices[pos] - self.cum[s]
            order = np.argsort(local)
            rows = local[order]
            x[pos[order]] = self.inputs[s][rows]
            y[pos[order]] = self.targets[s][rows]
        return x, y

    def batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                rules=None):
        rng = np.random.default_rng(seed)
        order = (rng.permutation(self.num_samples) if shuffle
                 else np.arange(self.num_samples))
        for s in range(self.num_samples // batch_size):
            xb, yb = self.gather(order[s * batch_size:(s + 1) * batch_size])
            if rules is not None:
                xb, yb = rules.shard_batch(xb, yb)
            yield xb, yb
