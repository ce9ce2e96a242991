"""Benchmark: the streaming path for a split beyond the card's memory
(``ChunkedLoader`` and its chunk runner) on one GPU.

The counterpart of ``scripts/bench_chunked.py``.  The high-res dataset
(41.2 TB, 5.7 B samples) cannot live on the card, so training streams
(K, B, D) superbatches from the host while the card runs K steps a
superbatch.  Steady state a superbatch should take the largest of its
legs, not their sum.  Four legs, each in ms a superbatch:

  compute   K steps of the v1 MLP on a superbatch already on the card
  transfer  the pinned host-to-card copies alone, pipelined (all reps
            enqueued, one wait)
  gather    the host gather alone: K*B shuffled rows of the memory-mapped
            split into a pinned buffer, one thread (the loader's producer),
            timed after the overlap leg has mapped the split's pages in
  overlap   the real ChunkedLoader loop through the chunk runner

and efficiency = max(compute, transfer) / overlap (1.0: the wall time is
the larger device leg), beside ``bound_leg``, the largest of the three
legs.  Each timed epoch of the overlap leg is timed twice: whole, from
the loader's start (``overlap``), and from the arrival of its first
superbatch (``steady``), without the pipeline fill (that superbatch's
gather and copy) that every pass of the loader pays and that an epoch of
the high-res set would pay once in some 21,700 superbatches.  The split
is a synthetic v1 split of SUPERBATCHES superbatches, written as an .npy
pair to a temporary directory and memory-mapped.  The v1 ClimSimMLP (124 -> 768, 640, 512, 640, 640 ->
128) is trained by ``mlp_trainer`` at ``--batch`` (32,768) and ``--k``
(8), bench_train's configuration.

Prints ONE JSON line; without a CUDA device it exits non-zero.

  python -m climsim_tpu_torch.bench_chunked [--batch 32768] [--k 8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

HIDDEN = (768, 640, 512, 640, 640)
BATCH = 32768
K = 8
SUPERBATCHES = 16
REPS = 3
SEED = 0
BASE_ROWS = 262144   # rows drawn by synthetic_split; the rest are jittered


def write_split(directory: str, rows: int, seed: int = 0,
                base: int = BASE_ROWS) -> tuple[str, str]:
    """A synthetic v1 split of ``rows`` rows written as an .npy pair under
    ``directory``; returns (input path, target path).  ``base`` rows come
    from ``synthetic_split``; each further block of ``base`` rows is that
    block times (1 + 1e-3 N(0, 1)), so every row is distinct and the
    columns keep their physical ranges, at a fraction of the cost."""
    from numpy.lib.format import open_memmap

    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .varspec import get_varspec

    spec = get_varspec("v1")
    base = min(base, rows)
    bx, by = synthetic_split(spec, base, grid=load_default_grid(), seed=seed)
    paths = (os.path.join(directory, "train_input.npy"),
             os.path.join(directory, "train_target.npy"))
    rng = np.random.default_rng(seed + 1)
    for path, b in zip(paths, (bx, by)):
        out = open_memmap(path, mode="w+", dtype=np.float32,
                          shape=(rows, b.shape[1]))
        for s in range(0, rows, base):
            n = min(base, rows - s)
            if s == 0:
                out[:n] = b[:n]
            else:
                jit = rng.standard_normal((n, b.shape[1]), np.float32)
                out[s:s + n] = b[:n] * (1.0 + 1e-3 * jit)
        out.flush()
        del out
    return paths


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def legs(tr, loader, reps: int = REPS) -> dict:
    """The four legs of ``loader`` (a ChunkedLoader) training ``tr`` (a
    trainer whose step takes its micro-batches), in ms a superbatch, and
    the efficiency.  The overlap leg runs one warm epoch, then ``reps``
    timed epochs; ``tr.state`` is advanced by every step taken."""
    import torch

    from .data.pipeline import take_rows

    dev, k, b = loader.device, loader.steps_per_chunk, loader.micro_batch
    x, y = loader.inputs, loader.targets
    run = loader.make_chunk_runner(tr.train_step)
    state = tr.state

    # compute: K steps on a resident superbatch
    xc = torch.from_numpy(np.array(x[:k * b])).to(dev).view(k, b, -1)
    yc = torch.from_numpy(np.array(y[:k * b])).to(dev).view(k, b, -1)
    state, m = run(state, xc, yc)
    m["loss"].item()
    t0 = time.perf_counter()
    for _ in range(reps):
        state, m = run(state, xc, yc)
    m["loss"].item()
    compute = (time.perf_counter() - t0) / reps

    # transfer: pinned copies alone, all enqueued, one wait
    pin = dev.type == "cuda"
    hx = torch.empty(tuple(xc.shape), pin_memory=pin)
    hy = torch.empty(tuple(yc.shape), pin_memory=pin)
    hx.copy_(xc)
    hy.copy_(yc)
    _sync(dev)
    t0 = time.perf_counter()
    held = [(hx.to(dev, non_blocking=True), hy.to(dev, non_blocking=True))
            for _ in range(reps)]
    _sync(dev)
    transfer = (time.perf_counter() - t0) / reps
    del held, xc, yc

    # overlap: the real loop, one warm epoch first; each timed epoch ends
    # on the card, and steady starts at its first superbatch's arrival
    for xs, ys in loader:
        state, m = run(state, xs, ys)
    m["loss"].item()
    n = loader.plan.steps
    overlap = steady = 0.0
    for _ in range(reps):
        t0 = t1 = time.perf_counter()
        for s, (xs, ys) in enumerate(loader):
            if s == 0:
                t1 = time.perf_counter()
            state, m = run(state, xs, ys)
        m["loss"].item()
        t2 = time.perf_counter()
        overlap += (t2 - t0) / (reps * n)
        steady += (t2 - t1) / (reps * n)
    tr.state = state

    # gather: the host gather alone, as the producer thread does it, after
    # the overlap leg's epochs have mapped the split's pages in; the
    # permutation is drawn once an epoch there, so outside the clock here
    order = np.random.default_rng(0).permutation(x.shape[0])
    hxf, hyf = hx.numpy().reshape(k * b, -1), hy.numpy().reshape(k * b, -1)
    t0 = time.perf_counter()
    for r in range(reps):
        idx = order[(r * k * b) % (x.shape[0] - k * b + 1):][:k * b]
        take_rows(x, idx, hxf)
        take_rows(y, idx, hyf)
    gather = (time.perf_counter() - t0) / reps

    sb_bytes = k * b * (x.shape[1] + y.shape[1]) * x.dtype.itemsize
    ms = {"compute": compute, "transfer": transfer, "gather": gather}
    return {"compute_ms": compute * 1e3, "transfer_ms": transfer * 1e3,
            "gather_ms": gather * 1e3, "overlap_ms": overlap * 1e3,
            "steady_ms": steady * 1e3,
            "efficiency": max(compute, transfer) / overlap,
            "steady_efficiency": max(compute, transfer) / steady,
            "bound_leg": max(ms, key=ms.get),
            "superbatch_mb": sb_bytes / 1e6,
            "transfer_gb_s": sb_bytes / transfer / 1e9,
            "gather_gb_s": sb_bytes / gather / 1e9,
            "overlap_samples_per_s": k * b / overlap,
            "steady_samples_per_s": k * b / steady,
            "compute_samples_per_s": k * b / compute}


def build(device, paths, batch: int = BATCH, k: int = K, seed: int = 0,
          prefetch: int = 2):
    """(trainer, ChunkedLoader) over the memory-mapped split at ``paths``
    on ``device``."""
    from .data.pipeline import ChunkedLoader
    from .norms import load_asset_norms
    from .train import recipes
    from .varspec import get_varspec

    x = np.load(paths[0], mmap_mode="r")
    y = np.load(paths[1], mmap_mode="r")
    tr = recipes.mlp_trainer(get_varspec("v1"), load_asset_norms("v1"),
                             None, seed, hidden=HIDDEN, steps_per_epoch=1000,
                             device=device)
    loader = ChunkedLoader(x, y, batch, steps_per_chunk=k, seed=seed,
                           prefetch=prefetch, device=device)
    return tr, loader


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--k", type=int, default=K)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_chunked: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        paths = write_split(tmp, args.batch * args.k * SUPERBATCHES, SEED)
        split_s = time.perf_counter() - t0
        tr, loader = build("cuda", paths, args.batch, args.k, SEED)
        res = legs(tr, loader)
        del loader
    print(f"[bench_chunked] {torch.cuda.get_device_name(0)}: split written "
          f"in {split_s:.1f} s; " + ", ".join(
              f"{k} {v:.2f}" for k, v in res.items()
              if isinstance(v, float)), file=sys.stderr)
    print(json.dumps({"metric": "chunked_samples_per_sec_per_chip",
                      "value": res["overlap_samples_per_s"],
                      "unit": "samples/s/chip",
                      "device": torch.cuda.get_device_name(0),
                      "batch": args.batch, "k": args.k, **res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
