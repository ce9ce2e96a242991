"""Measured full-epoch wall-clocks for every baseline and the flagship.

The port's entry for ``scripts/bench_all.py``: one 10,091,520-sample epoch
(the low-res dataset's volume: 384 columns x 26,280 timesteps) a model,
through the port's training path on the card, timed as one run.

Method
------
* The split is device-resident (``DeviceResidentLoader``, block shuffle
  of 128 rows); a resident pool of R rows is trained over ceil(EPOCH /
  (steps_per_epoch * batch)) epochs of the loader's epoch runner, so that
  at least EPOCH samples flow through the train step (an on-device
  reshuffle, a gather and the step).  The pool is a resident pool
  because a 10 GB unique upload would time the upload, not the step:
  every step gathers fresh rows from device memory all the same.
* One untimed warm-up epoch first (kernel builds, cuBLAS and cuDNN
  plans, the caching allocator); the timed run ends with a host read of
  the last loss.
* RPN: every member sees >= EPOCH bootstrap rows, the bootstrap indices
  drawn on the card (``torch.randint`` from a card generator) in a loop
  of steps.
* FLOPs: ``utils.profiling.cost_analysis`` of one train step, run on a
  copy of the state (the step updates its state in place).  The same
  step's products are split by their operands' dtype, and MFU divides by
  the H100's peak for that arithmetic (dense: bf16 989 TFLOP/s, float32
  with TF32 off 67 TFLOP/s; ``peak_tflops`` names the mix a row used).
  The epoch's reshuffle adds bytes, not products.

    python -m climsim_tpu_torch.bench_all [--models MLP,ED,...]
        [--out docs/BENCH_EPOCHS.torch.md] [--jsonl PATH] [--prior PATH]
        [--pool-rows N]

writes ``docs/BENCH_EPOCHS.torch.md`` (never the JAX script's
``docs/BENCH_EPOCHS.md``) and prints one JSON line a model; a failing
model fails the run.  ``BENCH_EPOCH_ROWS`` in the environment sets the
epoch's rows (read by ``main``); a run cut to fewer rows than a pool
takes one epoch of the pool all the same, so a cut run of a slow model
also cuts its pool (``--pool-rows``).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# 384 cols x 26,280 steps (the full low-res training volume)
EPOCH_ROWS = 10_091_520
# the H100 SXM's dense peaks (PERF.md section 6), by the products'
# operand dtype; float32 with TF32 off
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
WARMUP_EPOCHS = 1
RPN_WARMUP_STEPS = 10
ORDER = ["MLP", "ED", "HSR", "cVAE", "RPN x32", "CNN", "U-Net v5 (128ch)"]
SIX = ["MLP", "ED", "HSR", "cVAE", "RPN x32", "CNN"]

UNET_KW = dict(model_channels=128, channel_mult=(1, 2, 2, 2), num_blocks=4,
               attn_resolutions=(8,), output_prune=True, strato_lev_out=15)


def _mlp(s, st, sb, r, device):
    from .train import recipes

    return recipes.mlp_trainer(s, st, sb, r, hidden=(768, 640, 512, 640, 640),
                               steps_per_epoch=1000, device=device)


def _ed(s, st, sb, r, device):
    from .train import recipes

    return recipes.ed_trainer(s, st, sb, r, steps_per_epoch=1000,
                              device=device)


def _hsr(s, st, sb, r, device):
    from .train import recipes

    return recipes.hsr_trainer(s, st, sb, r, device=device)


def _cvae(s, st, sb, r, device):
    from .train import recipes

    return recipes.cvae_trainer(s, st, sb, r, device=device)


def _cnn(s, st, sb, r, device):
    from .train import recipes

    return recipes.cnn_trainer(s, st, sb, r, steps_per_epoch=1000,
                               device=device)


def _unet(s, st, sb, r, device):
    from .train import recipes

    return recipes.unet_trainer(s, st, sb, r, steps_per_epoch=1000,
                                model_kw=dict(UNET_KW), device=device)


# name -> (trainer factory, varspec, batch, resident pool rows, row name):
# the JAX script's models, batches and pools (scripts/bench_all.py:296-319);
# the U-Net runs fused_gn_conv off, as there
CONFIGS = {
    "MLP": (_mlp, "v1", 32768, 524288, "MLP"),
    "ED": (_ed, "v1", 32768, 524288, "ED"),
    "HSR": (_hsr, "v1", 16384, 524288, "HSR"),
    "cVAE": (_cvae, "v1", 16384, 524288, "cVAE"),
    "CNN": (_cnn, "v1", 4096, 262144, "CNN"),
    "UNet": (_unet, "v5", 4096, 32768, "U-Net v5 (128ch)"),
}
# RPN: (members, bootstrap batch a member, pool rows)
RPN_CONFIG = (32, 3072, 262144)


class ProductDtypes(TorchDispatchMode):
    """A dispatch mode that counts the products' FLOPs (the formulas of
    ``torch.utils.flop_counter``) by the dtype of their first operand, in
    ``flops``."""

    def __init__(self):
        super().__init__()
        self.flops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            dt = next(str(a.dtype).split(".")[-1] for a in args
                      if isinstance(a, torch.Tensor))
            self.flops[dt] = self.flops.get(dt, 0) + fn(*args, **kwargs,
                                                        out_val=out)
        return out


def step_cost(step_fn) -> dict:
    """FLOPs of one call of ``step_fn`` (``cost_analysis``), their split
    by operand dtype, the peak they run at (``peak_tflops``: the total
    over the time each dtype's share takes at its own peak) and the
    call's peak device memory."""
    from .utils.profiling import cost_analysis

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        raise RuntimeError("the float32 peak assumes TF32 off")
    by_dtype = ProductDtypes()

    def run():
        with by_dtype:
            step_fn()

    c = cost_analysis(run)
    if sum(by_dtype.flops.values()) != c["flops"]:
        raise RuntimeError(f"products by dtype {by_dtype.flops} do not sum "
                           f"to the step's {c['flops']} FLOPs")
    unknown = set(by_dtype.flops) - set(PEAK_FLOPS)
    if unknown:
        raise RuntimeError(f"no peak for products in {sorted(unknown)}")
    at_peak = sum(f / PEAK_FLOPS[d] for d, f in by_dtype.flops.items())
    return {"flops": c["flops"], "flops_by_dtype": dict(by_dtype.flops),
            "peak_flops": c["flops"] / at_peak if at_peak else None,
            "peak_memory_bytes": c.get("peak_memory_bytes")}


def _host(t) -> float:
    """A device scalar read on the host: the wait for the card."""
    return float(t.detach().double().cpu())


def _peak_gb(device):
    if torch.device(device).type != "cuda":
        return None
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 1e9


def _reset_peak(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def bench_generic(name, make_trainer, spec_name, batch, pool_rows, results,
                  epoch_rows=EPOCH_ROWS, device="cuda", jsonl=None):
    """One model's epoch through the resident loader's epoch runner."""
    from .data.pipeline import DeviceResidentLoader
    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import load_asset_norms
    from .varspec import get_varspec

    spec = get_varspec(spec_name)
    grid = load_default_grid()
    stats = load_asset_norms(spec_name)
    x, y = synthetic_split(spec, pool_rows, grid=grid, seed=0)
    tr = make_trainer(spec, stats, (x[:batch], y[:batch]), 0, device)
    loader = DeviceResidentLoader(x, y, batch, seed=0, block_shuffle=128,
                                  device=device)
    del x, y
    spe = loader.steps_per_epoch
    k = -(-epoch_rows // (spe * batch))     # epochs to cover >= epoch_rows
    run = loader.make_epoch_runner(tr.train_step)

    probe = copy.deepcopy(tr.state)
    xb, yb = loader.x[:batch], loader.y[:batch]
    cost = step_cost(lambda: tr.train_step(probe, xb, yb))
    del probe

    _reset_peak(device)
    state, m = run(tr.state, WARMUP_EPOCHS)
    _host(m["loss"][-1])
    t0 = time.perf_counter()
    state, m = run(state, k)
    loss = _host(m["loss"][-1])
    wall = time.perf_counter() - t0
    rows = k * spe * batch
    row = report(name, wall, rows, cost["flops"] * k * spe, loss,
                 f"batch {batch}, pool {pool_rows} rows, {k} epochs of the "
                 f"resident loader after {WARMUP_EPOCHS} warm-up",
                 epoch_rows, cost, _peak_gb(device),
                 steps=k * spe, warmup_steps=WARMUP_EPOCHS * spe, jsonl=jsonl)
    results.append(row)
    return row


def bench_rpn(results, ensemble=32, batch=3072, pool_rows=262144,
              epoch_rows=EPOCH_ROWS, device="cuda", jsonl=None):
    """RPN: one epoch = every member sees >= epoch_rows bootstrap rows
    (the reference trains each of the 32 members on a full bootstrap
    resample, rpn_model_v1_data.py); the indices drawn on the device."""
    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import load_asset_norms
    from .train.rpn_recipe import rpn_trainer
    from .varspec import get_varspec

    spec = get_varspec("v1")
    grid = load_default_grid()
    stats = load_asset_norms("v1")
    x, y = synthetic_split(spec, pool_rows, grid=grid, seed=0)
    tr = rpn_trainer(spec, stats, x[:2], 0, ensemble_size=ensemble,
                     device=device)
    xd = torch.as_tensor(x).to(device)
    yd = torch.as_tensor(y).to(device)
    del x, y
    n = pool_rows
    steps = -(-epoch_rows // batch)
    gen = torch.Generator(device=device).manual_seed(7)

    def step(trainer):
        idx = torch.randint(0, n, (ensemble, batch), generator=gen,
                            device=device)
        return trainer.train_step(xd[idx], yd[idx])

    idx0 = torch.zeros((ensemble, batch), dtype=torch.long, device=device)
    probe = copy.deepcopy(tr)
    cost = step_cost(lambda: probe.train_step(xd[idx0], yd[idx0]))
    del probe

    _reset_peak(device)
    for _ in range(RPN_WARMUP_STEPS):
        losses = step(tr)
    _host(losses.mean())
    t0 = time.perf_counter()
    for _ in range(steps):
        losses = step(tr)
    loss = _host(losses.mean())
    wall = time.perf_counter() - t0
    row = report(f"RPN x{ensemble}", wall, steps * batch,
                 cost["flops"] * steps, loss,
                 f"batch {batch}/member, {ensemble} members, pool "
                 f"{pool_rows} rows, on-device bootstrap, {steps} steps "
                 f"after {RPN_WARMUP_STEPS} warm-up",
                 epoch_rows, cost, _peak_gb(device), steps=steps,
                 warmup_steps=RPN_WARMUP_STEPS, jsonl=jsonl)
    results.append(row)
    return row


def report(name, wall, rows, flops, loss, note, epoch_rows=EPOCH_ROWS,
           cost=None, peak_gb=None, steps=None, warmup_steps=None,
           jsonl=None):
    """One row, unrounded: s/epoch (the wall normalized to
    ``epoch_rows``; rows >= epoch_rows), samples/s, TFLOP/s, MFU against
    ``cost``'s peak; printed, and appended to the file ``jsonl`` at
    once."""
    peak = (cost or {}).get("peak_flops")
    row = dict(model=name, s_per_epoch=wall * epoch_rows / rows,
               wall_s=wall, rows=int(rows), epoch_rows=int(epoch_rows),
               samples_per_s=rows / wall, tflops=flops / wall / 1e12,
               mfu=flops / wall / peak if peak else None,
               peak_tflops=peak / 1e12 if peak else None,
               flops_by_dtype=(cost or {}).get("flops_by_dtype"),
               step_flops=(cost or {}).get("flops"),
               peak_memory_gb=peak_gb, steps=steps,
               warmup_steps=warmup_steps, loss=loss, note=note)
    print(json.dumps(row), flush=True)
    if jsonl:
        with open(jsonl, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def markdown(results, card) -> list:
    lines = [
        "# Measured full-epoch wall-clocks (one card, PyTorch port)",
        "",
        f"On {card}: one {EPOCH_ROWS:,}-sample epoch a model (the low-res "
        "dataset's volume, or the `epoch_rows` a row names) through the "
        "resident loader's epoch runner, after one warm-up epoch; the RPN "
        "with its bootstrap drawn on the card.  MFU: the train step's "
        "products (`utils.profiling.cost_analysis`) against the card's "
        "peak for their operands' dtype (bf16 989, float32 67 TFLOP/s).  "
        "Produced by `python -m climsim_tpu_torch.bench_all`.",
        "",
        "| model | s / epoch | samples/s | TFLOP/s | MFU (peak TFLOP/s) | "
        "peak GB | rows | note |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in results:
        # a prior row of the JAX script has no peak_tflops: its MFU was
        # against another chip's peak and is not shown
        mfu = ("--" if r.get("peak_tflops") is None else
               f"{100 * r['mfu']:.2f}% ({r['peak_tflops']:.1f})")
        gb = "--" if r.get("peak_memory_gb") is None else \
            f"{r['peak_memory_gb']:.2f}"
        lines.append(
            f"| {r['model']} | {r['s_per_epoch']:.2f} | "
            f"{r['samples_per_s']:,.0f} | {r['tflops']:.2f} | {mfu} | {gb} | "
            f"{r['rows']:,} of {r.get('epoch_rows', EPOCH_ROWS):,} | "
            f"{r['note']} |")
    have = {r["model"]: r["s_per_epoch"] for r in results}
    if all(m in have for m in SIX):
        lines += ["", f"**Six-baseline total on {card}: "
                  f"{sum(have[m] for m in SIX):.0f} s.**"]
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--models", default="MLP,ED,HSR,cVAE,RPN,CNN,UNet",
                    help="comma list; order = run order")
    ap.add_argument("--out", default=os.path.join("docs",
                                                  "BENCH_EPOCHS.torch.md"))
    ap.add_argument("--jsonl", default=os.path.join(
        tempfile.gettempdir(), "bench_epochs.torch.jsonl"),
        help="append each measured row here as it lands")
    ap.add_argument("--prior", default=None,
                    help="seed results from a prior run's --jsonl file "
                         "(dedup by model name, new rows win)")
    ap.add_argument("--rpn-batch", type=int, default=RPN_CONFIG[1],
                    help="bootstrap batch per member (the reference's "
                         "own size, rpn_model_v1_data.py:23)")
    ap.add_argument("--pool-rows", type=int, default=None,
                    help="every model's resident pool (default: each "
                         "model's own); a cut run's smaller pool")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    epoch_rows = int(os.environ.get("BENCH_EPOCH_ROWS", EPOCH_ROWS))

    from .run_all_baselines import card_line

    card = card_line(args.device)
    print(f"device: {card}", flush=True)
    t_all = time.time()
    results = []
    want = [m.strip() for m in args.models.split(",") if m.strip()]
    for name in want:
        t0 = time.time()
        if name == "RPN":
            bench_rpn(results, RPN_CONFIG[0], args.rpn_batch,
                      args.pool_rows or RPN_CONFIG[2], epoch_rows,
                      args.device, args.jsonl)
        else:
            fac, spec_name, batch, pool, label = CONFIGS[name]
            bench_generic(label, fac, spec_name, batch,
                          args.pool_rows or pool, results, epoch_rows,
                          args.device, args.jsonl)
        print(f"  [{name}: {time.time() - t0:.0f}s incl. data and warm-up, "
              f"{time.time() - t_all:.0f}s total]", flush=True)

    if args.prior:
        fresh = {r["model"] for r in results}
        # the prior file may hold several rows a model (report() appends
        # across resumed runs): keep the newest of each
        prior = {}
        with open(args.prior) as f:
            for ln in f:
                if ln.strip():
                    r = json.loads(ln)
                    prior[r["model"]] = r
        results = [r for m, r in prior.items() if m not in fresh] + results
        order = {m: i for i, m in enumerate(ORDER)}
        results.sort(key=lambda r: order.get(r["model"], 99))

    with open(args.out, "w") as f:
        f.write("\n".join(markdown(results, card)) + "\n")
    print(f"wrote {args.out} [{time.time() - t_all:.0f}s]")
    return results


if __name__ == "__main__":
    main()
