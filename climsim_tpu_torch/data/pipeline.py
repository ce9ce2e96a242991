"""Host -> device input pipeline (the counterpart of
``climsim_tpu.data.pipeline``).

Two ways to feed a train step:

* ``DeviceResidentLoader``: the whole split is uploaded once and stays on
  the device; each epoch draws its permutation on the device and every
  batch is a slice of the permuted split, so steady-state training moves
  nothing between host and card.
* The streaming loaders, for a split that does not fit the card (the
  high-res dataset is 41.2 TB): ``BatchLoader`` (a batch a step),
  ``ChunkedLoader`` (a (K, B, D) superbatch of K steps, run by its chunk
  runner) and ``BootstrapLoader`` (an (E, B, D) stack of per-member
  bootstrap batches).  The split stays on the host, memory-mapped ``.npy``
  or in RAM.  The batch indices are numpy's ``default_rng(seed)`` draws,
  the JAX loaders' own, so the index stream equals JAX's for the same
  seed.

A streaming loader gathers each batch's rows on a producer thread,
``prefetch`` batches ahead, straight into a ring of pinned host buffers
(``_PinnedRing``), and copies them to the device with ``non_blocking``
copies on a stream of its own.  A pinned buffer is refilled only after
the event of the copy that last read it has completed.  The consumer's
stream waits on the copy's event before it uses a batch, and the batch
is recorded on that stream (``record_stream``), so the caching allocator
does not hand its memory to a later copy while the step still reads it.
On the CPU the rows are gathered into fresh arrays and yielded as they
are.  A fault on the producer thread is raised in the consumer.

Data-parallel loading (``rules``, as
``climsim_tpu/data/pipeline.py:49-107``): ``batch_size`` stays the global
batch; every rank draws the same permutation (the same seed) and stages
only its contiguous 1/world_size of each global batch
(``local_indices``), through its own pinned ring and copy stream, onto
its device.  The global batch must divide over the ranks, and a
remainder batch is never drawn (``drop_remainder``).  The rows split
over the data axis only (``rules.rank`` and ``rules.world_size``): under
a model axis the ranks that share a data index get the same rows.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..parallel.mesh import BATCH, CHUNK, ENSEMBLE_BATCH
from ..utils.profiling import span


def _epoch_seed(seed: int, epoch: int) -> int:
    """The generator seed of ``epoch``: a hash of (seed, epoch), so any
    epoch's permutation is drawn without drawing the ones before it."""
    return int(np.random.SeedSequence([seed, epoch]).generate_state(1,
                                                                    np.uint64)[0])


def _process_split(rules, batch_size: int,
                   drop_remainder: bool = True) -> tuple[int, int]:
    """(this process's rank, the world size) from ``rules``, else (0, 1):
    one process drives one device, so the JAX loaders' process_index and
    process_count are the rank and the world size.  More than one
    process needs a global batch that divides over them and
    drop_remainder: a remainder batch would not divide, and local_indices
    would drop its rows."""
    pidx, pcount = (rules.rank, rules.world_size) if rules is not None \
        else (0, 1)
    if pcount > 1:
        if batch_size % pcount:
            raise ValueError(f"global batch {batch_size} does not divide "
                             f"over {pcount} processes")
        if not drop_remainder:
            raise ValueError("multi-process loading needs "
                             "drop_remainder=True")
    if not 0 <= pidx < pcount:
        raise ValueError(f"rank {pidx} of {pcount}")
    return pidx, pcount


@dataclass
class EpochPlan:
    num_samples: int
    batch_size: int
    drop_remainder: bool = True

    @property
    def steps(self) -> int:
        if self.drop_remainder:
            return self.num_samples // self.batch_size
        return -(-self.num_samples // self.batch_size)


def take_rows(a: np.ndarray, idx: np.ndarray, out: np.ndarray) -> None:
    """``out[...] = a[idx]`` without numpy's intermediate copy.  ``idx``
    holds the loader's own draws, each in range, so mode="wrap" (which
    skips the bounds check's buffering) changes nothing."""
    np.take(a, idx, axis=0, out=out, mode="wrap")


class _PinnedRing:
    """Staging of host batches for the device: ``slots`` sets of pinned
    host buffers, each with the event of the copy that last read it, and
    the stream the copies run on.  On the CPU there is no staging: each
    batch is gathered into fresh arrays."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None
        self._bufs: list = [None] * slots
        self._events: list = [None] * slots
        self._next = 0

    def stage(self, shapes, dtypes, fill):
        """``fill(*host_arrays)`` writes one batch into host arrays of
        ``shapes``; returns (tensors on the device, the event that ends
        their copies, None on the CPU)."""
        if not self.cuda:
            arrs = [np.empty(s, d) for s, d in zip(shapes, dtypes)]
            fill(*arrs)
            return [torch.from_numpy(a) for a in arrs], None
        k = self._next % len(self._bufs)
        self._next += 1
        if self._events[k] is not None:
            self._events[k].synchronize()   # its last copy has read it
        bufs = self._bufs[k]
        if bufs is None or not all(
                b.shape[1:] == tuple(s[1:]) and b.shape[0] >= s[0]
                for b, s in zip(bufs, shapes)):
            bufs = [torch.empty(tuple(s), dtype=_torch_dtype(d),
                                pin_memory=True)
                    for s, d in zip(shapes, dtypes)]
            self._bufs[k] = bufs
        # a shorter batch (the last, without drop_remainder) fills the
        # leading rows of its slot, so no slot is allocated twice
        bufs = [b[:s[0]] for b, s in zip(bufs, shapes)]
        fill(*[b.numpy() for b in bufs])
        with torch.cuda.stream(self.stream):
            out = [b.to(self.device, non_blocking=True) for b in bufs]
            ev = torch.cuda.Event()
            ev.record(self.stream)
        self._events[k] = ev
        return out, ev

    @staticmethod
    def arrive(out, ev):
        """Make the consumer's current stream wait for the copies of a
        staged batch, and keep their memory until that stream has used
        them."""
        if ev is not None:
            stream = torch.cuda.current_stream(out[0].device)
            stream.wait_event(ev)
            for t in out:
                t.record_stream(stream)
        return tuple(out)


def _torch_dtype(dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, dtype)).dtype


class _Streaming:
    """The producer thread and its queue: ``_jobs()`` yields (shapes,
    dtypes, fill) a batch, which the thread stages ``prefetch`` batches
    ahead of the consumer.  Leaving the loop early stops the thread."""

    def _init_streaming(self, device, prefetch: int) -> None:
        """The staging ring lives as long as the loader, so its pinned
        buffers are allocated once; without a card a CUDA ``device``
        raises here."""
        self.device = torch.device(device)
        self.prefetch = prefetch
        self._ring = _PinnedRing(self.device, prefetch + 2)

    def _jobs(self):
        raise NotImplementedError

    def _produce(self, q: queue.Queue, stop: threading.Event,
                 ring: _PinnedRing) -> None:
        try:
            for shapes, dtypes, fill in self._jobs():
                if stop.is_set():
                    return
                q.put(ring.stage(shapes, dtypes, fill))
        except BaseException as e:  # handed to the consumer, who raises it
            q.put(e)
            return
        q.put(None)

    def __iter__(self):
        ring = self._ring
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        t = threading.Thread(target=self._produce, args=(q, stop, ring),
                             daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield ring.arrive(*item)
        finally:
            stop.set()
            while t.is_alive():   # unblock a producer waiting on the queue
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join()


class BatchLoader(_Streaming):
    """Shuffled mini-batches of a split on the host (in RAM or a
    memory-mapped ``.npy``), streamed to ``device``.

    The epoch's order is ``default_rng(seed).permutation(n)``, as the JAX
    loader draws it; each batch's rows are gathered on the producer thread
    into a pinned buffer and copied on the loader's copy stream.
    ``batch_size`` is the global batch; with ``rules`` of more than one
    rank this process gathers and stages only its ``local_indices`` of
    each, onto ``rules.device``.
    """

    placement = BATCH       # how a draw's indices lie over the ranks

    def __init__(self, inputs: np.ndarray, targets: np.ndarray,
                 batch_size: int, rules=None, shuffle: bool = True,
                 seed: int = 0, prefetch: int = 2,
                 drop_remainder: bool = True, device="cuda"):
        self.pidx, self.pcount = _process_split(rules, batch_size,
                                                drop_remainder)
        if rules is not None:
            device = rules.device
        if inputs.shape[0] != targets.shape[0]:
            raise ValueError(f"{inputs.shape[0]} input rows, "
                             f"{targets.shape[0]} target rows")
        self.inputs = inputs
        self.targets = targets
        self.batch_size = batch_size
        self.shuffle = shuffle
        self._seed = seed
        self.rng = np.random.default_rng(seed)
        self.plan = EpochPlan(inputs.shape[0], batch_size, drop_remainder)
        self._init_streaming(device, prefetch)

    def set_epoch(self, epoch: int) -> None:
        """Reset the shuffle to the start of ``epoch``: each pass draws
        one permutation, so this replays ``epoch`` draws (JAX's
        set_epoch, for a resumed run's batch order)."""
        self.rng = np.random.default_rng(self._seed)
        for _ in range(epoch):
            self.rng.permutation(self.inputs.shape[0])

    @property
    def steps_per_epoch(self) -> int:
        return self.plan.steps

    def local_indices(self, global_batch_idx: np.ndarray) -> np.ndarray:
        """The rows of a global batch this process contributes: its
        contiguous slice (``climsim_tpu/data/pipeline.py:103-107``)."""
        return self.placement.local(global_batch_idx, self.pidx,
                                    self.pcount)

    def _index_stream(self):
        n = self.inputs.shape[0]
        order = self.rng.permutation(n) if self.shuffle else np.arange(n)
        for s in range(self.plan.steps):
            yield order[s * self.batch_size:(s + 1) * self.batch_size]

    def _rows_job(self, idx, lead):
        """(shapes, dtypes, fill) gathering rows ``idx`` into arrays of
        leading shape ``lead``."""
        x, y = self.inputs, self.targets
        shapes = [(*lead, x.shape[-1]), (*lead, y.shape[-1])]

        def fill(ox, oy):
            take_rows(x, idx, ox.reshape(-1, x.shape[-1]))
            take_rows(y, idx, oy.reshape(-1, y.shape[-1]))

        return shapes, (x.dtype, y.dtype), fill

    def _jobs(self):
        for idx in self._index_stream():
            idx = self.local_indices(idx)
            yield self._rows_job(idx.reshape(-1), idx.shape)


class ChunkedLoader(BatchLoader):
    """Superbatches of ``steps_per_chunk`` batches, shaped (K, B, D), for
    a split that does not fit the device: the host streams while the
    device runs K steps a superbatch (``make_chunk_runner``), with the
    next superbatch gathered and copied meanwhile.  Each permutation step
    draws K*B rows, so the batch order equals ``BatchLoader(batch_size=
    K*B)``'s with the same seed, consumed K steps at a time; a partial
    superbatch is dropped.  Over several processes each gets its columns
    of every step's batch, (K, B / world_size, D) (the JAX loader's
    chunk sharding, ``climsim_tpu/data/pipeline.py:176-180``)."""

    placement = CHUNK

    def __init__(self, inputs, targets, batch_size: int,
                 steps_per_chunk: int = 8, rules=None, shuffle=True,
                 seed: int = 0, prefetch: int = 2, device="cuda"):
        _process_split(rules, batch_size)
        super().__init__(inputs, targets, batch_size * steps_per_chunk,
                         rules, shuffle, seed, prefetch, device=device)
        self.micro_batch = batch_size
        self.steps_per_chunk = steps_per_chunk

    @property
    def steps_per_epoch(self) -> int:
        return self.plan.steps * self.steps_per_chunk

    def _jobs(self):
        for idx in self._index_stream():
            idx = self.local_indices(
                idx.reshape(self.steps_per_chunk, self.micro_batch))
            yield self._rows_job(idx.reshape(-1), idx.shape)

    def make_chunk_runner(self, train_step):
        """``run(state, xc, yc) -> (state, metrics)``: the K steps of one
        superbatch; ``metrics`` holds the per-chunk means, on the device.
        JAX runs them in one ``lax.scan`` dispatch; here it is a Python
        loop over the steps that never waits for the card."""

        def run(state, xc, yc):
            steps: dict[str, list] = {}
            for xb, yb in zip(xc, yc):
                state, m = train_step(state, xb, yb)
                for k, v in m.items():
                    steps.setdefault(k, []).append(v)
            return state, {k: torch.stack(v).mean()
                           for k, v in steps.items()}

        return run


class BootstrapLoader(BatchLoader):
    """Per-member bootstrap batches for ensemble training (the RPN
    pattern, rpn_model_v1_data.py:134-144): each draw yields (E, B, D)
    stacks, every member sampling its own bootstrap subset.  The subsets
    and the draws are the JAX loader's, from the same ``default_rng``
    stream.  Over a (data, model) mesh every rank draws the whole (E, B)
    index stream and stages its members' rows of their batches' slices,
    (E / model_size, B / world_size, D): members over the model axis,
    each member's batch over the data axis
    (``climsim_tpu/data/pipeline.py:258-262``)."""

    placement = ENSEMBLE_BATCH

    def __init__(self, inputs, targets, batch_size, ensemble_size,
                 subset_fraction: float = 0.8, rules=None, seed: int = 0,
                 steps_per_epoch: int = 100, prefetch: int = 2,
                 device="cuda"):
        super().__init__(inputs, targets, batch_size, rules, True, seed,
                         prefetch, device=device)
        self.midx, self.mcount = ((rules.model_rank, rules.model_size)
                                  if rules is not None else (0, 1))
        if ensemble_size % self.mcount:
            raise ValueError(f"{ensemble_size} members do not split over a "
                             f"model axis of {self.mcount}")
        n = inputs.shape[0]
        m = int(subset_fraction * n)
        self.member_subsets = np.stack([
            self.rng.choice(n, m, replace=False)
            for _ in range(ensemble_size)])
        self._steps = steps_per_epoch
        self.ensemble_size = ensemble_size

    @property
    def steps_per_epoch(self) -> int:
        return self._steps

    def set_epoch(self, epoch: int) -> None:
        """Reset to the start of ``epoch``, replaying the member-subset
        draws that ``__init__`` consumed, so the stream is the same."""
        self.rng = np.random.default_rng(self._seed)
        n = self.inputs.shape[0]
        m = self.member_subsets.shape[1]
        for _ in range(self.ensemble_size):
            self.rng.choice(n, m, replace=False)
        for _ in range(epoch * self._steps):
            self.rng.choice(m, self.batch_size, replace=False)

    def local_indices(self, global_batch_idx: np.ndarray) -> np.ndarray:
        """This rank's members' rows of their batches' slices."""
        return self.placement.local(global_batch_idx, self.pidx,
                                    self.pcount, self.midx, self.mcount)

    def _index_stream(self):
        m = self.member_subsets.shape[1]
        for _ in range(self._steps):
            cols = self.rng.choice(m, self.batch_size, replace=False)
            yield self.member_subsets[:, cols]  # (E, B)


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

    Over several processes every rank keeps the WHOLE split resident (the
    v1 split is 2.11 GB, 3% of an H100) and draws the same permutation;
    each batch is its contiguous 1/world_size of the global batch, so
    the ranks' batches are the 1-process loader's, split by rank.  (A rank
    holding only its rows could not take its part of a batch drawn from
    the whole split without exchanging rows.)
    """

    def __init__(self, inputs, targets, batch_size: int, rules=None,
                 shuffle: bool = True, seed: int = 0,
                 block_shuffle: int | None = None, device="cuda"):
        self.pidx, self.pcount = _process_split(rules, batch_size)
        if rules is not None:
            device = rules.device
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
        """The epoch's batches, each drawn in a span ``train.batch`` whose
        ``step`` counts the batches drawn before it (the epoch's
        permutation in one more, with its first batch's ``step``)."""
        spe, b = self.steps_per_epoch, self.batch_size
        first = self._epoch * spe
        with span("train.batch", step=first):
            xp, yp = self._permuted()
        for s in range(spe):
            with span("train.batch", step=first + s):
                batch = tuple(BATCH.local(a[s * b:(s + 1) * b], self.pidx,
                                          self.pcount) for a in (xp, yp))
            yield batch

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
