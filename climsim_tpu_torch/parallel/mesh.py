"""The process group, the mesh and the sharding rules (the counterpart of
``climsim_tpu.parallel.mesh``).

The reference's distribution layer is torch DDP over NCCL
(train_unet_h5loader.py:34-35,194-206); the JAX package replaced it by a
``jax.sharding.Mesh``.  The port goes back to DDP: one process drives one
device, and the mesh's axes are sets of ranks of the default process
group.

Axis conventions, as in the JAX package:
  * ``data``  -- batch (columns) sharding: the ranks that share a model
    index hold the same members or replicas and split each batch; their
    gradients are reduced over the data group;
  * ``model`` -- the RPN members and seed replicas split over ranks: the
    ranks that share a data index hold different members and gather them
    over the model group.

Rank ``d * num_model + m`` of the mesh is at (d, m), the model axis
innermost, as JAX's ``devices.reshape(num_data, num_model)``.
``make_multislice_mesh`` (TPU slices over DCN) has no counterpart.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def distributed_init_if_needed(backend: str | None = None) -> bool:
    """Join the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns whether this call created it.

    ``backend`` defaults to ``nccl`` where there is a card and ``gloo``
    where there is none; an NCCL rank first makes ``cuda:LOCAL_RANK`` its
    current device.  Under torchrun's elastic agent the group's keys are
    those of this attempt (``TORCHELASTIC_RESTART_COUNT``).  Does nothing
    without that environment or when a group exists already.  A backend
    that fails to start raises: nothing falls back to another backend."""
    if dist.is_initialized() or not _torchrun_env():
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    attempt = os.environ.get("TORCHELASTIC_RESTART_COUNT")
    if attempt is None or os.environ.get(
            "TORCHELASTIC_USE_AGENT_STORE", "").lower() != "true":
        dist.init_process_group(backend, init_method="env://")
        return True
    # the elastic agent's store outlives the workers it restarts: keys a
    # dead attempt wrote (gloo's peer addresses, NCCL's unique id) would
    # be read by the next one, so every attempt keeps its own
    world = int(os.environ["WORLD_SIZE"])
    store = dist.TCPStore(os.environ["MASTER_ADDR"],
                          int(os.environ["MASTER_PORT"]), world,
                          is_master=False)
    dist.init_process_group(
        backend, store=dist.PrefixStore(f"attempt_{attempt}/", store),
        rank=int(os.environ["RANK"]), world_size=world)
    return True


@dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) mesh: ``world_size``
    ranks in all, ``num_model`` of them on the model axis; this one is
    ``rank`` of the mesh, driving ``device``.  ``group`` holds every rank
    of the mesh, ``data_group`` the ranks that share this one's model
    index, ``model_group`` those that share its data index (None for a
    model axis of size 1).  ``ranks`` are the mesh's ranks in the default
    group, in mesh order (None: 0 .. world_size - 1)."""

    world_size: int
    rank: int
    device: torch.device
    group: object
    num_model: int = 1
    data_group: object = None
    model_group: object = None
    ranks: tuple | None = None

    def __post_init__(self):
        if self.num_model < 1 or self.world_size % self.num_model:
            raise ValueError(f"a model axis of {self.num_model} does not "
                             f"divide {self.world_size} ranks")

    @property
    def num_data(self) -> int:
        return self.world_size // self.num_model

    @property
    def data_index(self) -> int:
        return self.rank // self.num_model

    @property
    def model_index(self) -> int:
        return self.rank % self.num_model

    def global_rank(self, d: int, m: int) -> int:
        """The rank in the default group of the mesh's (d, m)."""
        r = d * self.num_model + m
        return r if self.ranks is None else self.ranks[r]


def make_mesh(num_data: int | None = None, num_model: int = 1,
              device="cuda", ranks=None) -> Mesh | None:
    """The (num_data, num_model) mesh over ``ranks`` of the default
    process group (all of them by default), which must exist
    (``distributed_init_if_needed`` or ``init_process_group``).

    ``num_data`` defaults to len(ranks) // num_model, and num_data *
    num_model must equal len(ranks): one device a process.  A CUDA
    ``device`` without an index becomes ``cuda:LOCAL_RANK`` (0 without
    torchrun).

    Making a group is a collective of the whole world: every rank calls
    this, with the same arguments, ranks outside ``ranks`` too (they get
    None).  The data groups are made first, m = 0 .. num_model - 1, then
    the model groups, d = 0 .. num_data - 1."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "torchrun, or call init_process_group first")
    world = dist.get_world_size()
    ranks = tuple(range(world)) if ranks is None else tuple(ranks)
    if not ranks or len(set(ranks)) != len(ranks) or not all(
            0 <= r < world for r in ranks):
        raise ValueError(f"ranks {ranks} of a world of {world}")
    if num_model < 1 or len(ranks) % num_model:
        raise ValueError(f"a model axis of {num_model} over {len(ranks)} "
                         "ranks")
    num_data = len(ranks) // num_model if num_data is None else num_data
    if num_data * num_model != len(ranks):
        raise ValueError(f"mesh of {num_data} x {num_model} over "
                         f"{len(ranks)} processes (one device a process)")
    whole = ranks == tuple(range(world))
    group = dist.group.WORLD if whole else dist.new_group(list(ranks))
    me = dist.get_rank()
    pos = ranks.index(me) if me in ranks else None
    data_group = group if pos is not None else None
    model_group = None
    if num_model > 1:
        for m in range(num_model):
            g = dist.new_group([ranks[d * num_model + m]
                                for d in range(num_data)])
            if pos is not None and pos % num_model == m:
                data_group = g
        for d in range(num_data):
            g = dist.new_group(list(ranks[d * num_model:(d + 1) * num_model]))
            if pos is not None and pos // num_model == d:
                model_group = g
    if pos is None:
        return None
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(len(ranks), pos, device, group, num_model, data_group,
                model_group, None if whole else ranks)


@dataclass(frozen=True)
class Placement:
    """How an array's leading dimensions lie over the mesh: dimension i
    is split into contiguous parts over the mesh axis ``axes[i]`` (None:
    whole on every rank)."""

    axes: tuple

    def local(self, a, index: int, count: int, model_index: int = 0,
              model_count: int = 1):
        """This rank's part of ``a``: a contiguous 1/count of each
        dimension split over the data axis (part ``index``) and a
        1/model_count of each split over the model axis (part
        ``model_index``), which must divide them."""
        for dim, axis in enumerate(self.axes):
            if axis == DATA_AXIS:
                i, c = index, count
            elif axis == MODEL_AXIS:
                i, c = model_index, model_count
            else:
                continue
            n = a.shape[dim]
            if n % c:
                raise ValueError(f"dimension {dim} of {n} does not split "
                                 f"over {c} ranks of the {axis} axis")
            per = n // c
            a = a[(slice(None),) * dim + (slice(i * per, (i + 1) * per),)]
        return a


BATCH = Placement((DATA_AXIS,))
REPLICATED = Placement(())
# a leading member or seed axis over the model axis (the RPN's stacked
# parameters, multi-seed replicas)
ENSEMBLE = Placement((MODEL_AXIS,))
# (E, B, ...) member batches: members over the model axis, each member's
# batch over the data axis
ENSEMBLE_BATCH = Placement((MODEL_AXIS, DATA_AXIS))
# a (K, B, ...) superbatch: its steps whole, each step's batch split
CHUNK = Placement((None, DATA_AXIS))


class _DDP(torch.nn.parallel.DistributedDataParallel):
    """DDP whose attributes fall back to the wrapped module's, so a loss
    function reads its model's fields (``dropout``, ...) through it."""

    def __getattr__(self, name):
        try:
            return super().__getattr__(name)
        except AttributeError:
            if name == "module":   # not set yet: DDP is being built
                raise
            return getattr(self.module, name)


class ShardingRules:
    """Where the training step's tensors live: the batch over the data
    axis; parameters and optimizer state whole on every rank of a data
    group, or, for an ensemble, its members split over the model axis.
    Holds the DDP wrapper of each module it has wrapped, so that two steps
    of one model (HSR's stages) share one reducer.

    ``rank`` and ``world_size`` are the data axis's: this rank's data
    index and the number of ranks a batch splits over (the loaders, the
    steps' means and DDP read them); ``model_rank`` and ``model_size``
    are the model axis's."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._wrapped: dict = {}

    batch = BATCH
    replicated = REPLICATED
    ensemble = ENSEMBLE
    ensemble_batch = ENSEMBLE_BATCH
    chunk = CHUNK

    @property
    def world_size(self) -> int:
        return self.mesh.num_data

    @property
    def rank(self) -> int:
        return self.mesh.data_index

    @property
    def model_size(self) -> int:
        return self.mesh.num_model

    @property
    def model_rank(self) -> int:
        return self.mesh.model_index

    @property
    def lead(self) -> bool:
        """Whether this is the mesh's rank 0 (the one that writes)."""
        return self.mesh.rank == 0

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def local(self, a, placement: Placement):
        """This rank's part of ``a`` under ``placement``."""
        return placement.local(a, self.rank, self.world_size,
                               self.model_rank, self.model_size)

    def split(self, n: int) -> tuple[int, int]:
        """[lo, hi) of this rank's part of ``n`` members or replicas split
        over the model axis, which must divide them."""
        if n % self.model_size:
            raise ValueError(f"{n} members do not split over a model axis "
                             f"of {self.model_size}")
        per = n // self.model_size
        return self.model_rank * per, (self.model_rank + 1) * per

    def params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Every rank's parameters and buffers made those of the first rank
        of its data group, in place (the JAX package's replicated put
        starts every device equal)."""
        src = self.mesh.global_rank(0, self.model_rank)
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t.data, src=src, group=self.mesh.data_group)
        return model

    def shard_batch(self, *arrays):
        """Global batches -> this rank's rows on its device."""
        out = tuple(self.shard_batch_local(self.local(a, self.batch))
                    for a in arrays)
        return out[0] if len(out) == 1 else out

    def shard_batch_local(self, *arrays):
        """This rank's rows (host arrays or tensors) -> its device."""
        out = tuple(torch.as_tensor(np.asarray(a) if not isinstance(
            a, torch.Tensor) else a).to(self.device) for a in arrays)
        return out[0] if len(out) == 1 else out

    def ddp(self, model: torch.nn.Module,
            unused_parameters: bool = False) -> _DDP:
        """The DDP wrapper of ``model`` over the data group, made at the
        first call (a collective: every rank of the group makes it at the
        same step).

        ``unused_parameters``: the loss may leave some parameters without
        a gradient (HSR's log-precision net in its MSE stage).  The
        reducer then walks the autograd graph after every forward to find
        them, which costs every step, so only a trainer whose loss leaves
        parameters unused asks for it; the first call's choice holds for
        the model.  Without it such a parameter makes DDP raise at the
        next step."""
        key = id(model)
        got = self._wrapped.get(key)
        if got is None or got.module is not model:
            dev = self.device
            got = _DDP(model, device_ids=[dev] if dev.type == "cuda" else None,
                       process_group=self.mesh.data_group,
                       find_unused_parameters=unused_parameters)
            self._wrapped[key] = got
        return got

    def mean(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor's mean over the data group, in one all-reduce (a
        sum divided by the data axis's size: gloo has no average)."""
        flat = torch.cat([v.detach().reshape(-1).float() for v in values])
        dist.all_reduce(flat, group=self.mesh.data_group)
        flat /= self.world_size
        out, at = [], 0
        for v in values:
            out.append(flat[at:at + v.numel()].reshape(v.shape).to(v.dtype))
            at += v.numel()
        return out

    def mean_metrics(self, metrics: dict) -> dict:
        return dict(zip(metrics, self.mean(list(metrics.values()))))

    def gather_model(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """This rank's part of a tensor split over the model axis along
        ``dim`` -> the whole tensor, on every rank of the model group, the
        parts in model order.  One all-reduce of the whole, zeros outside
        this rank's part (x + 0 is x: the parts arrive bit for bit, on
        gloo and NCCL alike).  A model axis of 1 returns ``t``."""
        if self.model_size == 1:
            return t
        n = t.shape[dim]
        shape = list(t.shape)
        shape[dim] = n * self.model_size
        whole = torch.zeros(shape, dtype=t.dtype, device=t.device)
        whole.narrow(dim, self.model_rank * n, n).copy_(t)
        dist.all_reduce(whole, group=self.mesh.model_group)
        return whole

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.group)


def pad_to_multiple(x: np.ndarray, multiple: int):
    """Pad the batch dim up to a multiple (for even sharding) with copies
    of the last row; returns (padded, real_count)."""
    n = x.shape[0]
    rem = (-n) % multiple
    if rem == 0:
        return x, n
    pad = np.repeat(x[-1:], rem, axis=0)
    return np.concatenate([x, pad], axis=0), n
