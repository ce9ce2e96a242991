"""Device-resident data loading (the counterpart of
``climsim_tpu.data.pipeline.DeviceResidentLoader``).

The whole split is uploaded once and stays on the device; each epoch
draws its permutation on the device and every batch is a slice of the
permuted split, so steady-state training moves nothing between host and
card.  ``BatchLoader`` and ``ChunkedLoader`` (data beyond device memory)
are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch


def _epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of ``epoch``: a hash of (seed, epoch), so any
    epoch's permutation is drawn without drawing the ones before it."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1,
                                                                    np.uint64)[0])


class DeviceResidentLoader:
    """Whole-split-on-device loader: upload once, shuffle and gather on the
    device.

    block_shuffle=B trades exact row shuffling for BLOCK shuffling: rows
    are fully permuted ONCE on the host at upload (numpy's
    ``default_rng(seed)``, as the JAX loader, so the uploaded order is the
    same array), then each epoch permutes fixed B-row blocks on the device.
    Epoch row sets remain exact permutations of the split.

    The per-epoch permutations come from a ``torch.Generator`` on the
    device, seeded from (``seed``, epoch).  They are not JAX's threefry
    draws: the two packages shuffle alike, not identically.
    """

    def __init__(self, inputs, targets, batch_size: int, rules=None,
                 shuffle: bool = True, seed: int = 0,
                 block_shuffle: int | None = None, device="cuda"):
        if rules is not None:
            raise NotImplementedError("sharding rules are not ported yet")
        self.block = block_shuffle if shuffle else None
        if self.block:
            n0 = inputs.shape[0]
            if n0 % self.block:
                raise ValueError(
                    f"split size {n0} not divisible by block_shuffle "
                    f"{self.block}")
            # one-time host row shuffle: blocks become RANDOM row subsets,
            # so fixed block composition carries no data-order structure
            host_perm = np.random.default_rng(seed).permutation(n0)
            inputs = np.asarray(inputs)[host_perm]
            targets = np.asarray(targets)[host_perm]
        self.device = torch.device(device)
        self.x = torch.as_tensor(np.ascontiguousarray(inputs)).to(self.device)
        self.y = torch.as_tensor(np.ascontiguousarray(targets)).to(
            self.device)
        self.n = self.x.shape[0]
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self._epoch = 0
        self._gen = torch.Generator(device=self.device)

    @property
    def steps_per_epoch(self) -> int:
        return self.n // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        """The next pass draws ``epoch``'s permutation."""
        self._epoch = epoch

    def _permuted(self):
        """The split in this epoch's order (x, y); advances the epoch."""
        self._gen.manual_seed(_epoch_seed(self._seed, self._epoch))
        self._epoch += 1
        if self.block:
            nb = self.n // self.block
            p = torch.randperm(nb, generator=self._gen, device=self.device)
            return tuple(a.view(nb, self.block, a.shape[-1])[p].view(
                self.n, a.shape[-1]) for a in (self.x, self.y))
        if self.shuffle:
            idx = torch.randperm(self.n, generator=self._gen,
                                 device=self.device)
            # one gather of the whole split, then contiguous slices (the
            # JAX epoch runner's layout)
            return self.x[idx], self.y[idx]
        return self.x, self.y

    def __iter__(self):
        xp, yp = self._permuted()
        b = self.batch_size
        for s in range(self.steps_per_epoch):
            yield xp[s * b:(s + 1) * b], yp[s * b:(s + 1) * b]

    def make_epoch_runner(self, train_step):
        """``run(state, num_epochs) -> (state, metrics)``: whole epochs of
        ``train_step`` over this loader, drawing the permutations in the
        order ``__iter__`` does, so ``run(state, E)`` is E passes of the
        Python ``for xb, yb in loader`` loop, bit for bit.

        ``metrics`` holds each epoch's mean over steps, stacked to shape
        (num_epochs,), on the device.  JAX runs the epochs inside one
        ``lax.scan`` dispatch; here it is a Python loop over steps that
        never waits for the card (capturing it in a CUDA graph is later
        work).
        """

        def run(state, num_epochs: int):
            epochs: dict[str, list] = {}
            for _ in range(num_epochs):
                steps: dict[str, list] = {}
                for xb, yb in self:
                    state, m = train_step(state, xb, yb)
                    for k, v in m.items():
                        steps.setdefault(k, []).append(v)
                for k, v in steps.items():
                    epochs.setdefault(k, []).append(torch.stack(v).mean())
            return state, {k: torch.stack(v) for k, v in epochs.items()}

        return run
