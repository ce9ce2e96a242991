"""Benchmark: the ``cnn_v1`` train step on one GPU, arm by arm.

The port's counterpart of ``scripts/bench_cnn.py`` (which times the JAX
package on the TPU).  Each arm is one ``train.recipes.cnn_trainer`` (12
residual blocks, Adam on the cyclic schedule, the channel-adjusted MAE)
on one fixed synthetic v1 batch on the card:

  406              the reference's width, dropout 0.175, bf16 convolutions
                   (float32 sums): the cnn_v1 preset
  384, 512         other widths at the same settings
  dropout off      406 channels without dropout (no masks drawn)
  float32 convs    406 channels, ``compute_dtype=float32``

The JAX script's rows for its dropout generators (threefry against rbg)
have no counterpart: the port draws every mask from the step's seed on
the card, with torch's one generator.

Each arm: --warmup steps, then --steps steps timed by CUDA events (device
time of back-to-back steps, the host never waiting in between) and the
card's peak allocation over them.  Prints a table (ms a step, samples/s,
against the 406 arm) and one JSON line.
Without a CUDA device it exits non-zero and prints no result.

--trace splits instead one step of the 406 arm by torch.profiler: device
ms a step by aten op (self time) and by kernel, and by part (the k = 3
convolutions forward and backward, the 1x1 convolutions' products, the
casts and copies, dropout, Adam, the rest).  Then one k = 3 convolution
of the step's shape, forward and backward, timed by CUDA events as the
model calls it (float32 on a transposed channels-last view, the bf16
policy's rounded operands), on a contiguous (B, C, L) copy, at 384
channels, and with bf16 operands.

  python -m climsim_tpu_torch.bench_cnn [--batch 512] [--steps 10]
      [--depth 12] [--arms 406,384,...] [--trace]
"""

from __future__ import annotations

import argparse
import json
import sys

BATCH = 512       # the cnn_v1 preset's (config.PRESETS)
STEPS = 10
WARMUP = 3
ARMS = {
    "406": dict(channels=406),
    "384": dict(channels=384),
    "512": dict(channels=512),
    "dropout off": dict(channels=406, dropout=0.0),
    "float32 convs": dict(channels=406, compute_dtype="float32"),
}


def build_arm(arm: str, device, batch: int = BATCH, depth: int = 12,
              seed: int = 0):
    """(trainer, xb, yb): ``arm``'s cnn_trainer on ``device`` and one
    synthetic v1 batch there."""
    import torch

    from .data.synthetic import synthetic_split
    from .grid import load_default_grid
    from .norms import load_asset_norms
    from .train import recipes
    from .varspec import get_varspec

    kw = dict(ARMS[arm])
    kw["compute_dtype"] = getattr(torch, kw.pop("compute_dtype",
                                                "bfloat16"))
    spec = get_varspec("v1")
    x, y = synthetic_split(spec, batch, load_default_grid(), seed=seed)
    tr = recipes.cnn_trainer(spec, load_asset_norms("v1"), (x, y), seed,
                             depth=depth, device=device, **kw)
    return tr, torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)


def time_arm(tr, xb, yb, steps: int = STEPS, warmup: int = WARMUP) -> dict:
    """Device ms a step over ``steps`` back-to-back steps (CUDA events)
    after ``warmup``; the last loss; the card's peak allocation over the
    steps (GB, the trainer's weights and the batch in)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = tr.state
    for _ in range(warmup):
        state, m = tr.train_step(state, xb, yb)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(steps):
        state, m = tr.train_step(state, xb, yb)
    end.record()
    torch.cuda.synchronize()
    tr.state = state
    ms = start.elapsed_time(end) / steps
    return {"ms": ms, "samples_per_s": xb.shape[0] / ms * 1e3,
            "loss": float(m["loss"]),
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def bench(arms=tuple(ARMS), batch: int = BATCH, steps: int = STEPS,
          depth: int = 12, seed: int = 0) -> dict:
    """arm -> time_arm's result, on the card."""
    out = {}
    for arm in arms:
        tr, xb, yb = build_arm(arm, "cuda", batch, depth, seed)
        out[arm] = time_arm(tr, xb, yb, steps)
        del tr, xb, yb
    return out


def _part(op: str) -> str:
    """The part of a cnn_v1 step an aten op's device time belongs to."""
    if op in ("aten::cudnn_convolution", "aten::convolution_backward",
              "aten::_convolution", "aten::convolution"):
        return "k = 3 convolutions"
    if op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"):
        return "1x1 convolutions (products)"
    if op in ("aten::copy_", "aten::_to_copy", "aten::to", "aten::clone",
              "aten::contiguous"):
        return "casts and copies"
    if op in ("aten::rand", "aten::uniform_", "aten::lt", "aten::where",
              "aten::div"):
        return "dropout"
    if "adam" in op.lower() or "foreach" in op:
        return "Adam"
    return "the rest"


def trace(batch: int = BATCH, depth: int = 12, seed: int = 0,
          steps: int = 2, reps: int = 5) -> dict:
    """The 406 arm's step split by torch.profiler (``steps`` steps after
    WARMUP), then one k = 3 convolution of its shape timed four ways;
    device ms a step throughout."""
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as profiled

    tr, xb, yb = build_arm("406", "cuda", batch, depth, seed)
    time_arm(tr, xb, yb, steps=1)
    state = tr.state
    with profiled(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            state, m = tr.train_step(state, xb, yb)
        torch.cuda.synchronize()
    ops, parts = {}, {}
    for ev in prof.key_averages():
        t = ev.self_device_time_total / 1e3 / steps
        if t > 0 and ev.key.startswith("aten::"):
            ops[ev.key] = t
            parts[_part(ev.key)] = parts.get(_part(ev.key), 0.0) + t
    kernels = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA and not ev.is_user_annotation:
            kernels[ev.name] = (kernels.get(ev.name, 0.0)
                                + ev.device_time_total / 1e3 / steps)
    del tr, state

    # one k = 3 convolution at the step's shape: (B, L, C) channels-last
    gen = torch.Generator(device="cuda").manual_seed(seed)
    conv = {}
    for name, c, dtype, layout in (
            ("float32, transposed view (the model's)", 406, torch.float32,
             "view"),
            ("float32, contiguous (B, C, L)", 406, torch.float32, "ncl"),
            ("float32, transposed view, 384 channels", 384, torch.float32,
             "view"),
            ("bf16 operands, transposed view", 406, torch.bfloat16,
             "view")):
        x = torch.randn(batch, 60, c, device="cuda", generator=gen,
                        dtype=dtype)
        w = (torch.randn(c, c, 3, device="cuda", generator=gen, dtype=dtype)
             / (3 * c) ** 0.5).requires_grad_()
        x = x.transpose(1, 2) if layout == "view" else \
            x.transpose(1, 2).contiguous()
        x.requires_grad_()

        def run():
            y = F.conv1d(x, w, padding=1)
            y.backward(torch.ones_like(y))

        for _ in range(2):
            run()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        torch.cuda.synchronize()
        start.record()
        for _ in range(reps):
            run()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / reps
        flop = 3 * 2 * batch * 60 * c * c * 3   # forward, dx, dw
        conv[name] = {"ms": ms, "tflop_s": flop / ms / 1e9}
    return {"steps": steps, "by_part": parts, "by_op": ops,
            "by_kernel": kernels, "conv3": conv,
            "step_ms": sum(parts.values()),
            "kernels_ms": sum(kernels.values())}


def trace_report(out: dict, top: int = 12) -> str:
    lines = [f"one cnn_v1 step (406 channels): its kernels' device time "
             f"{out['kernels_ms']:.3f} ms; by aten op's self time "
             f"{out['step_ms']:.3f} ms:"]
    for k, v in sorted(out["by_part"].items(), key=lambda kv: -kv[1]):
        lines.append(f"  {k:32s} {v:10.3f} ms  "
                     f"{100 * v / out['step_ms']:5.1f}%")
    lines.append("aten ops:")
    for k, v in sorted(out["by_op"].items(), key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {k:32s} {v:10.3f} ms")
    lines.append("kernels:")
    for k, v in sorted(out["by_kernel"].items(),
                       key=lambda kv: -kv[1])[:top]:
        lines.append(f"  {v:10.3f} ms  {k[:110]}")
    lines.append("one k = 3 convolution, forward + backward (dx, dw):")
    for k, v in out["conv3"].items():
        lines.append(f"  {k:42s} {v['ms']:9.3f} ms {v['tflop_s']:7.2f} "
                     "TFLOP/s")
    return "\n".join(lines)


def table(results: dict) -> str:
    base = results.get("406", {}).get("ms")
    lines = [f"{'arm':16s} {'ms/step':>10s} {'samples/s':>12s} "
             f"{'vs 406':>7s}"]
    for arm, r in results.items():
        rel = f"{base / r['ms']:.2f}x" if base else "-"
        lines.append(f"{arm:16s} {r['ms']:10.3f} {r['samples_per_s']:12.1f} "
                     f"{rel:>7s}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--arms", default=",".join(ARMS),
                    help="comma list of the arms to time")
    ap.add_argument("--trace", action="store_true",
                    help="split one 406 step by torch.profiler and time one "
                    "k = 3 convolution four ways, instead of the arms")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_cnn: no CUDA device; this benchmark runs on the GPU",
              file=sys.stderr)
        return 1
    if args.trace:
        out = trace(batch=args.batch, depth=args.depth)
        print(trace_report(out))
        print(json.dumps({"device": torch.cuda.get_device_name(0),
                          "batch": args.batch, "depth": args.depth,
                          "trace": out}))
        return 0
    res = bench(tuple(a for a in args.arms.split(",") if a), args.batch,
                args.steps, args.depth)
    print(table(res))
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "batch": args.batch, "depth": args.depth,
                      "arms": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
