"""The process group, the mesh and the sharding rules (the counterpart of
``climsim_tpu.parallel.mesh``).

The reference's distribution layer is torch DDP over NCCL
(train_unet_h5loader.py:34-35,194-206); the JAX package replaced it by a
``jax.sharding.Mesh``.  The port goes back to DDP: one process drives one
device, and the ``data`` axis is the ranks of the default process group.

Axis conventions, as in the JAX package:
  * ``data``  -- batch (columns) sharding over the ranks;
  * ``model`` -- reserved for the RPN members and seed replicas split
    over ranks.  Only a model axis of size 1 is ported: the members and
    replicas are whole on every rank (ROADMAP.md, Queue 1 item 7).

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

_NEXT_SLICE = ("the model axis (RPN members or seeds split over ranks) "
               "waits for the next distribution slice (ROADMAP.md, Queue 1 "
               "item 7)")


def _torchrun_env() -> bool:
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                         "MASTER_ADDR", "MASTER_PORT"))


def distributed_init_if_needed(backend: str | None = None) -> bool:
    """Join the default process group from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``); returns whether this call created it.

    ``backend`` defaults to ``nccl`` where there is a card and ``gloo``
    where there is none; an NCCL rank first makes ``cuda:LOCAL_RANK`` its
    current device.  Does nothing without that environment or when a
    group exists already.  A backend that fails to start raises: nothing
    falls back to another backend."""
    if dist.is_initialized() or not _torchrun_env():
        return False
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, init_method="env://")
    return True


@dataclass(frozen=True)
class Mesh:
    """This process's place in the (data, model) mesh: ``world_size`` ranks
    on the data axis, this one ``rank``, driving ``device``, over
    ``group``."""

    world_size: int
    rank: int
    device: torch.device
    group: object


def make_mesh(num_data: int | None = None, num_model: int = 1,
              device="cuda") -> Mesh:
    """The data-parallel mesh over the default process group, which must
    exist (``distributed_init_if_needed`` or ``init_process_group``).

    ``num_data`` defaults to the world size and must equal it;
    ``num_model > 1`` raises.  A CUDA ``device`` without an index becomes
    ``cuda:LOCAL_RANK`` (0 without torchrun)."""
    if num_model != 1:
        raise NotImplementedError(f"num_model={num_model}: {_NEXT_SLICE}")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: launch with "
                           "torchrun, or call init_process_group first")
    world = dist.get_world_size()
    num_data = world if num_data is None else num_data
    if num_data != world:
        raise ValueError(f"mesh of {num_data} x {num_model} over a world of "
                         f"{world} processes (one device a process)")
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return Mesh(world, dist.get_rank(), device, dist.group.WORLD)


@dataclass(frozen=True)
class Placement:
    """How an array's leading dimensions lie over the mesh: dimension i
    is split into contiguous parts over the mesh axis ``axes[i]`` (None:
    whole on every rank).  A model axis of size 1 splits nothing."""

    axes: tuple

    def local(self, a, index: int, count: int):
        """Part ``index`` of ``count`` of ``a``: a contiguous 1/count of
        each dimension split over the data axis, which must divide it
        (rank r's rows, in the data axis's rank order)."""
        for dim, axis in enumerate(self.axes):
            if axis != DATA_AXIS:
                continue
            n = a.shape[dim]
            if n % count:
                raise ValueError(f"dimension {dim} of {n} does not split "
                                 f"over {count} ranks")
            per = n // count
            a = a[(slice(None),) * dim + (slice(index * per,
                                                (index + 1) * per),)]
        return a


BATCH = Placement((DATA_AXIS,))
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
    axis, parameters and optimizer state whole on every rank.  Holds the
    DDP wrapper of each module it has wrapped, so that two steps of one
    model (HSR's stages) share one reducer."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._wrapped: dict = {}

    batch = BATCH
    ensemble_batch = ENSEMBLE_BATCH
    chunk = CHUNK

    @property
    def world_size(self) -> int:
        return self.mesh.world_size

    @property
    def rank(self) -> int:
        return self.mesh.rank

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def local(self, a, placement: Placement):
        """This rank's part of ``a`` under ``placement``."""
        return placement.local(a, self.rank, self.world_size)

    def params(self, model: torch.nn.Module) -> torch.nn.Module:
        """Every rank's parameters and buffers made rank 0's, in place (the
        JAX package's replicated put starts every device equal)."""
        with torch.no_grad():
            for t in (*model.parameters(), *model.buffers()):
                dist.broadcast(t.data, src=0, group=self.mesh.group)
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
        """The DDP wrapper of ``model``, made at the first call (a
        collective: every rank makes it at the same step).

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
                       process_group=self.mesh.group,
                       find_unused_parameters=unused_parameters)
            self._wrapped[key] = got
        return got

    def mean(self, values: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each tensor's mean over the ranks, in one all-reduce (a sum
        divided by the world size: gloo has no average)."""
        flat = torch.cat([v.detach().reshape(-1).float() for v in values])
        dist.all_reduce(flat, group=self.mesh.group)
        flat /= self.world_size
        out, at = [], 0
        for v in values:
            out.append(flat[at:at + v.numel()].reshape(v.shape).to(v.dtype))
            at += v.numel()
        return out

    def mean_metrics(self, metrics: dict) -> dict:
        return dict(zip(metrics, self.mean(list(metrics.values()))))

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.group)

