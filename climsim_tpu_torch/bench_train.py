"""Benchmark: v1 MLP training throughput on one GPU (samples/s/chip).

The counterpart of ``bench.py`` (which times the JAX package): the same
workload, through the port.  The v1 ``ClimSimMLP`` at hidden (768, 640,
512, 640, 640) is trained by ``train.recipes.mlp_trainer`` (cyclic LR,
MSE, Adam) on a synthetic v1 split of 6 batches of 32,768 rows, held on
the card by ``data.pipeline.DeviceResidentLoader`` with
``block_shuffle=128`` and driven by its epoch runner, 40 epochs a call.
One warm-up call, then the best of 6 timed calls; each call ends with the
last epoch's loss copied to the host, so the clock stops when the card
has finished.

Prints ONE JSON line:
  {"metric": "mlp_train_samples_per_sec_per_chip", "value": N,
   "unit": "samples/s/chip"}
There is no ``vs_baseline``: bench.py's ratio is to a target derived for
a TPU v5e-16.  Without a CUDA device it exits non-zero.

  python -m climsim_tpu_torch.bench_train [--epochs 40] [--reps 6]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

HIDDEN = (768, 640, 512, 640, 640)
BATCH = 32768
POOL = 6          # batches in the split
BLOCK = 128       # block_shuffle rows
EPOCHS = 40       # a call
REPS = 6


def build(device, seed: int = 0, batch: int = BATCH, pool: int = POOL,
          state_dict=None):
    """(trainer, loader, (x, y)) for the benchmark's workload on
    ``device``; ``state_dict`` (a ClimSimMLP's) replaces the weights drawn
    from ``seed``."""
    from .data.pipeline import DeviceResidentLoader
    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import load_asset_norms
    from .train import recipes
    from .varspec import get_varspec

    spec = get_varspec("v1")
    stats = load_asset_norms("v1")
    x, y = synthetic_split(spec, n=batch * pool, grid=load_default_grid(),
                           seed=seed)
    tr = recipes.mlp_trainer(spec, stats, (x, y), seed, hidden=HIDDEN,
                             steps_per_epoch=1000, device=device)
    if state_dict is not None:
        tr.model.load_state_dict(state_dict)
    loader = DeviceResidentLoader(x, y, batch, seed=seed,
                                  block_shuffle=BLOCK, device=device)
    return tr, loader, (x, y)


def throughput(tr, loader, epochs: int = EPOCHS, reps: int = REPS) -> dict:
    """One warm-up call of ``epochs`` epochs, then ``reps`` timed calls.

    Returns {"samples_per_s": of the best call, "best_s", "call_s": every
    timed call, "epoch_loss": every epoch's mean loss, warm-up first}."""
    import torch

    run = loader.make_epoch_runner(tr.train_step)
    state, losses, times = tr.state, [], []
    for rep in range(reps + 1):
        if loader.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = run(state, epochs)
        last = m["loss"].cpu()   # waits for the card
        if rep:
            times.append(time.perf_counter() - t0)
        losses += last.tolist()
    tr.state = state
    best = min(times)
    return {"samples_per_s": epochs * loader.steps_per_epoch
            * loader.batch_size / best,
            "best_s": best, "call_s": times, "epoch_loss": losses}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_train: no CUDA device; this benchmark runs on the GPU",
              file=sys.stderr)
        return 1
    tr, loader, _ = build("cuda", args.seed)
    res = throughput(tr, loader, args.epochs, args.reps)
    print(f"[bench_train] {torch.cuda.get_device_name(0)}: calls "
          + " ".join(f"{t:.3f}" for t in res["call_s"]) + " s",
          file=sys.stderr)
    print(json.dumps({"metric": "mlp_train_samples_per_sec_per_chip",
                      "value": round(res["samples_per_s"], 1),
                      "unit": "samples/s/chip"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
