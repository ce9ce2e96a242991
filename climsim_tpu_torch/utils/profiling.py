"""Profiling and observability (the counterpart of
``climsim_tpu.utils.profiling``):

  * ``trace`` -- a ``torch.profiler`` context writing a Chrome trace that
    TensorBoard and Perfetto load;
  * ``time_fn`` -- the median wall time of a call, synchronized with the
    card;
  * ``cost_analysis`` -- the products' FLOPs of a call
    (``torch.utils.flop_counter``) and its peak device memory;
  * ``MetricsLogger`` -- JSONL + CSV run logging.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block (host and, where there is a card, device
    activity) and write ``trace_<pid>.json`` into ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir,
                                          f"trace_{os.getpid()}.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn, *args, iters: int = 50, warmup: int = 2) -> float:
    """Median wall time per call (seconds), each call ended by a
    synchronize of the card; the ``warmup`` calls (kernel builds, first
    allocations) are not timed."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _gn_silu_conv3_flops(x_shape, gamma_shape, beta_shape, w_shape, b_shape,
                         out_shape=None, **kw) -> int:
    """Kernel 5's products: a k = 3 convolution, 2 * B * L * C_in * C_out *
    3.  Its GroupNorm and silu are elementwise; FlopCounterMode counts
    products only, so they count 0, as the plain chain's do."""
    b, l, c = x_shape
    return 2 * b * l * c * w_shape[2] * 3


def kernel_formulas() -> dict:
    """FlopCounterMode formulas of the port's torch.library operators.
    Kernel 5 holds the U-Net's k = 3 convolutions (82 chains a forward);
    without its formula a U-Net count silently loses most of its
    products.  Kernels 1 and 4 are elementwise and count 0."""
    from ..ops import unet_fused

    op = getattr(torch.ops, unet_fused.OPS_NAMESPACE).fused_gn_silu_conv3
    return {op: _gn_silu_conv3_flops}


def cost_analysis(fn, *args) -> dict:
    """``{"flops", "flops_by_op", "peak_memory_bytes"}`` of one call of
    ``fn(*args)`` (the counterpart of XLA's cost analysis, itself the
    analog of fvcore's FlopCountAnalysis, HSR/training/hpo.py:30).

    ``flops`` are the products' (matmuls, convolutions, attention) as
    ``torch.utils.flop_counter`` counts them, with ``kernel_formulas``
    for the port's operators; while the counter runs, kernel 5 is called
    through its operator so that the count sees it.  ``flops_by_op``
    splits the count by operator.  ``peak_memory_bytes`` is the card's
    peak allocation during the call (``max_memory_allocated`` after
    ``reset_peak_memory_stats``), left out without a card.  XLA's
    ``bytes accessed`` has no PyTorch counterpart and is left out."""
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False,
                         custom_mapping=kernel_formulas()) as counter:
        fn(*args)
    out = {"flops": float(counter.get_total_flops()),
           "flops_by_op": {str(k): float(v) for k, v in
                           counter.get_flop_counts()["Global"].items()}}
    if cuda:
        torch.cuda.synchronize()
        out["peak_memory_bytes"] = float(torch.cuda.max_memory_allocated())
    return out


@dataclass
class MetricsLogger:
    """Append-only JSONL metrics stream + end-of-run CSV table."""

    directory: str
    name: str = "run"
    _rows: list = field(default_factory=list)

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._path = os.path.join(self.directory, f"{self.name}.jsonl")

    def log(self, step: int, **metrics):
        row = {"step": step, "time": time.time(), **metrics}
        self._rows.append(row)
        with open(self._path, "a") as f:
            f.write(json.dumps(row) + "\n")

    def to_csv(self, path: str | None = None):
        path = path or os.path.join(self.directory, f"{self.name}.csv")
        if not self._rows:
            return path
        keys = sorted({k for r in self._rows for k in r})
        with open(path, "w") as f:
            f.write(",".join(keys) + "\n")
            for r in self._rows:
                f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")
        return path
