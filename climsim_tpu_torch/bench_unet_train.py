"""Benchmark: U-Net v5 training throughput on one GPU, arm by arm.

The port's counterpart of ``scripts/bench_unet_fused_train.py`` (which
times the JAX package): the full-width ``unet_v5`` U-Net (21,231,125
parameters) trained by ``train.recipes.unet_trainer`` (Huber, cosine
schedule, Adam) on a synthetic v5 pool whose ``icol`` runs 1..384, held
on the card by ``data.pipeline.DeviceResidentLoader`` with
``block_shuffle=128`` and driven by its epoch runner.  Each arm is one
set of model flags:

  plain            the plain GroupNorm -> silu -> conv chains (the JAX
                   script's ``xla``)
  fused            ``fused_gn_conv=True``: the eligible chains through
                   kernel 5 under its custom VJP
  remat            ``remat_blocks=True``
  bf16norm         ``norm_dtype=bfloat16``
  remat+bf16norm   both

The batch is the preset's 1024 (the JAX script's 4096 behind --batch; at
4096 the saved activations take about four times the memory).  One
warm-up call of --epochs epochs, then --reps timed calls; each call ends
with the last epoch's loss copied to the host.

Prints one JSON line an arm: samples/s of the best call, every call's
wall, the last loss, ``torch.cuda.max_memory_allocated`` and kernel 5's
launches a step; then the arms' speedups over ``plain``.
Without a CUDA device it exits non-zero.  ``--flops`` prints the model's
forward operations a sample (counted from its shapes on the meta device)
and exits; it needs no card.

``--convs`` times instead the fused arm's plain ``Conv1d`` calls (the
convolutions kernel 5 does not take: 8 k = 3 and 33 1x1 a forward) shape
by shape at --batch: the device ms of the forward, dgrad and wgrad
(torch.profiler) of ``conv_tensor_core``, the card's path, and of
``conv_widened`` at bf16 compute (float32 products of the rounded
operands), beside the bf16 bound; one JSON line a shape, then the step's
totals.

  python -m climsim_tpu_torch.bench_unet_train [--arms plain,fused]
      [--batch 1024] [--pool 16] [--epochs 2] [--reps 3] [--convs]
"""

from __future__ import annotations

import argparse
import json
import sys

BATCH = 1024      # the unet_v5 preset's (climsim_tpu/config.py:163)
POOL = 16         # batches in the pool
BLOCK = 128       # block_shuffle rows
EPOCHS = 2        # a call
REPS = 3
CONV_ITERS = 20   # calls a timed pass of --convs
ARMS = {
    "plain": {},
    "fused": dict(fused_gn_conv=True),
    "remat": dict(remat_blocks=True),
    "bf16norm": dict(norm_dtype="bfloat16"),
    "remat+bf16norm": dict(remat_blocks=True, norm_dtype="bfloat16"),
}


def model_kw(arm: str) -> dict:
    """The unet_v5 widths with ``arm``'s flags."""
    import torch

    from .config import PRESETS

    kw = dict(PRESETS["unet_v5"].model_kw, **ARMS[arm])
    if kw.get("norm_dtype") == "bfloat16":
        kw["norm_dtype"] = torch.bfloat16
    return kw


def pool(n: int, seed: int = 0):
    """(x, y): a synthetic v5 pool of ``n`` rows with ``icol`` 1..384, as
    scripts/bench_unet_fused_train.py:49-50."""
    import numpy as np

    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .varspec import get_varspec

    spec = get_varspec("v5")
    x, y = synthetic_split(spec, n, grid=load_default_grid(), seed=seed)
    x[:, spec.input_slices["icol"]] = (np.arange(n) % 384 + 1)[:, None]
    return x, y


def build(device, arm: str, data, seed: int = 0, batch: int = BATCH,
          state_dict=None):
    """(trainer, loader) of ``arm`` on ``device`` over the pool ``data``
    (x, y); ``state_dict`` (a ClimSimUNet's) replaces the weights drawn
    from ``seed``."""
    from .data.pipeline import DeviceResidentLoader
    from .norms import load_asset_norms
    from .train import recipes
    from .varspec import get_varspec

    x, y = data
    tr = recipes.unet_trainer(get_varspec("v5"), load_asset_norms("v5"),
                              (x[:batch], y[:batch]), seed,
                              steps_per_epoch=x.shape[0] // batch,
                              model_kw=model_kw(arm), device=device)
    if state_dict is not None:
        tr.model.load_state_dict(state_dict)
    loader = DeviceResidentLoader(x, y, batch, seed=seed, block_shuffle=BLOCK,
                                  device=device)
    return tr, loader


def forward_flops_per_sample() -> dict:
    """Operations of one forward a sample (convolutions and products,
    two a multiply-add), counted on the meta device from the shapes:
    {"total": n, "by_op": {aten op: n}}."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .models.unet import ClimSimUNet
    from .varspec import get_varspec

    spec = get_varspec("v5")
    with torch.device("meta"):
        m = ClimSimUNet(spec, **model_kw("plain"))
        x = torch.zeros(2, spec.input_len)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        m.eval()(x)
    return {"total": counter.get_total_flops() / 2,
            "by_op": {str(op): n / 2 for op, n
                      in counter.get_flop_counts()["Global"].items()}}


def conv_shapes(model_channels: int | None = None) -> dict:
    """{(L, Cin, Cout, K): calls} of the plain ``Conv1d`` calls in one
    forward of the fused arm (kernel 5's chains are not among them), by a
    pre-hook on each, at 16 rows on the CPU; the same at any batch that is
    a multiple of 16.  ``model_channels`` replaces the preset's width."""
    import torch

    from .models.unet import ClimSimUNet, Conv1d
    from .varspec import get_varspec

    spec = get_varspec("v5")
    kw = model_kw("fused")
    if model_channels is not None:
        kw["model_channels"] = model_channels
    m = ClimSimUNet(spec, **kw)
    shapes: dict = {}

    def count(mod, args):
        cout, cin, k = mod.weight.shape
        key = (args[0].shape[1], cin, cout, k)
        shapes[key] = shapes.get(key, 0) + 1

    for mod in m.modules():
        if isinstance(mod, Conv1d):
            mod.register_forward_pre_hook(count)
    with torch.no_grad():
        m(torch.zeros(16, spec.input_len))
    return shapes


def conv_times(shapes: dict, batch: int) -> list[dict]:
    """One row a shape of ``conv_shapes``: device ms a call of the forward,
    dgrad and wgrad of both paths at ``batch`` rows (every kernel a pass
    launches, casts included, summed from torch.profiler's device events:
    back-to-back calls here wait on the host), the tensor-core pass's
    longest kernel, and the bound of each pass: its products at the bf16
    rate, or its bf16 operands read and its bf16 result written once, the
    larger."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from .bench_gn_conv3 import BF16_OPS_S, HBM_BYTES_S
    from .models import unet

    paths = {"tensor_core": unet.conv_tensor_core,
             "float32": lambda x, w, b: unet.conv_widened(x, w, b,
                                                          torch.bfloat16)}

    def device_ms(fn):
        """(device ms a call, the name of the kernel that took longest)"""
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(CONV_ITERS):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.device_time_total)
        return (sum(by_name.values()) / CONV_ITERS / 1e3,
                max(by_name, key=by_name.get)[:80])

    rows = []
    for (l, cin, cout, k), calls in sorted(shapes.items(),
                                           key=lambda kv: (-kv[0][3], kv[0])):
        x = torch.randn(batch, l, cin, device="cuda")
        w = torch.randn(cout, cin, k, device="cuda") / (cin * k) ** 0.5
        b = 0.1 * torch.randn(cout, device="cuda")
        dy = torch.randn(batch, l, cout, device="cuda")
        row = dict(L=l, Cin=cin, Cout=cout, K=k, calls=calls)
        for name, fn in paths.items():
            with torch.no_grad():
                timed = {"forward": device_ms(lambda: fn(x, w, b))}
            for part, arg in (("dgrad", 0), ("wgrad", 1)):
                ins = [x, w]
                ins[arg] = ins[arg].detach().requires_grad_()
                y = fn(ins[0], ins[1], b)
                timed[part] = device_ms(lambda: torch.autograd.grad(
                    y, ins[arg], dy, retain_graph=True))
                del y
            for part, (t, kernel) in timed.items():
                row[f"{name}_{part}_ms"] = t
                if name == "tensor_core":
                    row[f"{part}_kernel"] = kernel
        ops = 2 * batch * l * cin * cout * k
        nbytes = 2 * (batch * l * (cin + cout) + cout * cin * k)
        row["bound_ms"] = 1e3 * max(ops / BF16_OPS_S, nbytes / HBM_BYTES_S)
        rows.append(row)
    return rows


def run_arm(arm: str, data, batch: int, epochs: int, reps: int,
            seed: int = 0) -> dict:
    """Build ``arm`` on the card, time it, and return its JSON row."""
    import torch

    from .bench_train import throughput
    from .ops import kernels as K

    tr, loader = build("cuda", arm, data, seed, batch)
    torch.cuda.reset_peak_memory_stats()
    K.reset_launches()
    res = throughput(tr, loader, epochs, reps)
    steps = (reps + 1) * epochs * loader.steps_per_epoch
    row = dict(arm=arm, batch=batch, rows_a_call=epochs * loader.n,
               samples_per_s=res["samples_per_s"], wall_best=res["best_s"],
               wall_all=res["call_s"], loss=res["epoch_loss"][-1],
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               k5_launches_a_step=K.LAUNCHES["fused_gn_silu_conv3"] / steps)
    del tr, loader
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arms", default="plain,fused",
                    help="comma-separated, of " + ", ".join(ARMS))
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--pool", type=int, default=POOL,
                    help="batches in the pool")
    ap.add_argument("--epochs", type=int, default=EPOCHS)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--flops", action="store_true",
                    help="print the forward operations a sample and exit")
    ap.add_argument("--convs", action="store_true",
                    help="time the plain convolutions shape by shape")
    args = ap.parse_args(argv)
    arms = [a.strip() for a in args.arms.split(",") if a.strip()]
    unknown = set(arms) - set(ARMS)
    if unknown:
        ap.error(f"unknown arms {sorted(unknown)}")
    if args.flops:
        print(json.dumps({"forward_flop_per_sample":
                          forward_flops_per_sample()}))
        return 0

    import torch

    if not torch.cuda.is_available():
        print("bench_unet_train: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    if args.convs:
        print(f"[bench_unet_train] {torch.cuda.get_device_name(0)}, plain "
              f"Conv1d calls at B={args.batch}", file=sys.stderr)
        rows = conv_times(conv_shapes(), args.batch)
        for row in rows:
            print(json.dumps(row), flush=True)
        parts = ("forward", "dgrad", "wgrad")
        print(json.dumps({"metric": "unet_conv_ms_a_step", "batch": args.batch,
                          **{f"{path}_ms": sum(
                              r["calls"] * r[f"{path}_{p}_ms"]
                              for r in rows for p in parts)
                             for path in ("tensor_core", "float32")},
                          "bound_ms": sum(3 * r["calls"] * r["bound_ms"]
                                          for r in rows)}))
        return 0
    data = pool(args.batch * args.pool, args.seed)
    print(f"[bench_unet_train] {torch.cuda.get_device_name(0)}, "
          f"{data[0].shape[0]} rows", file=sys.stderr)
    rows = {}
    for arm in arms:
        rows[arm] = run_arm(arm, data, args.batch, args.epochs, args.reps,
                            args.seed)
        print(json.dumps(rows[arm]), flush=True)
    if "plain" in rows:
        base = rows["plain"]["wall_best"]
        print(json.dumps({"metric": "unet_train_arm_speedups",
                          "speedups": {a: base / r["wall_best"]
                                       for a, r in rows.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
