"""Benchmark: kernel 6 (the fused MLP-training forward and backward) on one
GPU, against another checkout's.

At the v1 widths (124 -> 768, 640, 512, 640, 640 -> 128) and the
MLP_v2rh widths (557 -> 1024 x 4 -> 368), weights drawn from --seed, at
each batch of --batches: the forward, the backward and forward + backward
through ``make_fused_mlp_train`` (autograd, the pack kept for the
backward) are timed beside their plain versions (the float32 chain and its
plain backward; plain autograd for forward + backward), the bound (the
larger of the bytes over 3.35 TB/s and one bf16 product a multiply-add
over 989 TFLOP/s; ``chip_smoke.py`` reports it) and the three-pass floor
(the forward's float32 activations take three bf16 passes, so the
forward and the backward's recompute count three products a multiply-add).
The forward is held to the plain version within rtol 2e-4 / atol 1e-4 and
the gradients within rel-L2 1.6e-3 (``chip_smoke.py``'s tolerances).

Device time: CUDA events around ``--iters`` calls captured in one CUDA
graph and replayed (``bench_gn_conv3.time_ms``).

``--old DIR`` imports the port of the checkout in DIR (an earlier commit,
unpacked with ``git archive`` into a git-ignored directory) beside this
one as the package ``cst_old``, whose wrappers build and load that
checkout's own kernel library, and times both in turns, old, new, new,
old, on the same inputs.  The split of a backward's device time into its
recompute, dW products, dh products and the db / partial passes comes
from torch.profiler.  ``--sweep`` times the backward at the largest batch
of v1 over the dW and dh products' tile widths and split-K chunk counts
(``replan`` of the planner's plan); each must give the plan's gradients
within the JAX test's tile_b tolerance (rtol 2e-2, atol 1e-4).

Prints a line a case, then one JSON line.  Without a CUDA device it exits
non-zero.

  python -m climsim_tpu_torch.bench_mlp_train [--old _checkout] [--sweep]
      [--batches 1,7,384,32768] [--iters 10]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys

import numpy as np

from .bench_gn_conv3 import BF16_OPS_S, HBM_BYTES_S, time_ms
from .bench_io_kernels import load_old

NETS = {"v1": (124, 768, 640, 512, 640, 640, 128),
        "v2rh": (557, 1024, 1024, 1024, 1024, 368)}
FWD_TOL = (2e-4, 1e-4)
GRAD_TOL = 1.6e-3
TILE_TOL = (2e-2, 1e-4)


def bounds_ms(widths, b: int) -> dict:
    """Kernel 6's forward and backward at batch ``b``: {"fwd" / "bwd":
    {"bound_ms", "bound_by", "three_pass_floor_ms"}}.  The bound is the
    larger of the bytes (x and y or dy in float32, the float32 weights and
    biases read once, their gradients written once) over the memory rate
    and one bf16 product a multiply-add over the bf16 peak; the floor takes
    the forward's and the recompute's products three times (float32
    activations against bf16 weights).  The backward's products: the
    recompute of layers 0..L-2 (the last layer's output is not needed),
    dW of every layer, dh of every layer but the first (dx is not
    computed)."""
    n_w = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_b = sum(widths[1:])
    recompute = n_w - widths[-2] * widths[-1]
    dh = n_w - widths[0] * widths[1]
    fwd_bytes = 4 * b * (widths[0] + widths[-1]) + 4 * (n_w + n_b)
    bwd_bytes = 4 * b * (widths[0] + widths[-1]) + 8 * (n_w + n_b)
    out = {}
    for name, nbytes, ops, floor_ops in (
            ("fwd", fwd_bytes, 2 * b * n_w, 3 * 2 * b * n_w),
            ("bwd", bwd_bytes, 2 * b * (recompute + n_w + dh),
             2 * b * (3 * recompute + n_w + dh))):
        t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_OPS_S
        out[name] = {"bound_ms": max(t_bytes, t_ops) * 1e3,
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "three_pass_floor_ms":
                         max(t_bytes, floor_ops / BF16_OPS_S) * 1e3}
    return out


def replan(base, smem_limit: int, dw_bn: int | None = None,
           dh_bn: int | None = None, chunks: int | None = None):
    """``base`` (a ``plan_mlp_train`` plan) with the dW products at
    ``dw_bn`` columns (one of GEMM_BN), the dh products at ``dh_bn`` (one
    of GEMM_DH_BN), or ``chunks`` split-K chunks a dW product (as the
    planner cuts them: whole multiples of lcm(tile_b, 64) rows), each at
    the most stages that fit, and the partials' scratch resized: the plans
    ``--sweep`` times.  None keeps the plan's."""
    from .ops import fused_mlp_train as FT

    if dw_bn is not None and dw_bn not in FT.GEMM_BN:
        raise ValueError(f"dw_bn {dw_bn}: want one of {FT.GEMM_BN}")
    if dh_bn is not None and dh_bn not in FT.GEMM_DH_BN:
        raise ValueError(f"dh_bn {dh_bn}: want one of {FT.GEMM_DH_BN}")

    def tiled(tile, bn, dw):
        if tile is None or bn is None:
            return tile
        st = FT._gemm_stages(bn, smem_limit, FT._gemm_blocks(dw, bn))
        return dataclasses.replace(tile, bn=bn, stages=st,
                                   smem=FT._gemm_smem(bn, st))

    rows, widths = base.batch, base.widths
    unit = math.lcm(base.tile_b, FT.GEMM_BK)
    units = -(-rows // unit)
    dw = [tiled(t, dw_bn, True) for t in base.dw]
    if chunks is not None:
        kc = -(-units // max(1, min(units, chunks))) * unit
        dw = [dataclasses.replace(t, rows=kc, chunks=-(-rows // kc))
              for t in dw]
    prods = [i * o for i, o in zip(widths[:-1], widths[1:])]
    partial = base.partial + sum((t.chunks - o.chunks) * p
                                 for t, o, p in zip(dw, base.dw, prods))
    return dataclasses.replace(
        base, dw=tuple(dw), dh=tuple(tiled(t, dh_bn, False) for t in base.dh),
        partial=partial)


def rel_l2(got, want) -> float:
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-300))


def split_ms(torch, fn, reps: int = 3) -> dict:
    """A backward's device time by part (ms a call), by torch.profiler:
    the recompute (kernel 2's save instantiation), the dW and dh products,
    the passes that round x and dy and add the partials, the pack."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    parts = {"recompute": 0.0, "dW": 0.0, "dh": 0.0, "db_partials": 0.0,
             "pack": 0.0, "other": 0.0}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / reps
        if t <= 0:
            continue
        name = e.key
        if "mlp_wgmma_kernel" in name:
            parts["recompute"] += t
        elif "gemm_kernel<0" in name:
            parts["dW"] += t
        elif "gemm_kernel<1" in name:
            parts["dh"] += t
        elif "prep_kernel" in name or "reduce_kernel" in name:
            parts["db_partials"] += t
        elif "pack_kernel" in name:
            parts["pack"] += t
        else:
            parts["other"] += t
    return parts


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="a checkout whose port to time beside this one")
    ap.add_argument("--batches", default="1,7,384,32768")
    ap.add_argument("--nets", default="v1,v2rh")
    ap.add_argument("--sweep", action="store_true",
                    help="time the backward over tile widths and chunks")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_mlp_train: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    from .ops import fused_mlp_train as FT

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    old = (load_old(args.old, "ops.fused_mlp_train") if args.old
           else None)
    batches = [int(v) for v in args.batches.split(",")]
    rng = np.random.default_rng(args.seed)
    rows_out, bad = [], []
    for label in args.nets.split(","):
        widths = NETS[label]
        ws = [torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i))
                               .astype(np.float32)).to(dev)
              for i, o in zip(widths[:-1], widths[1:])]
        bs = [torch.from_numpy((0.1 * rng.standard_normal(o))
                               .astype(np.float32)).to(dev)
              for o in widths[1:]]
        wg = [w.clone().requires_grad_() for w in ws]
        bg = [b.clone().requires_grad_() for b in bs]
        for b in batches:
            x = torch.from_numpy(rng.standard_normal((b, widths[0]))
                                 .astype(np.float32)).to(dev)
            dy = torch.from_numpy((rng.standard_normal((b, widths[-1])) / b)
                                  .astype(np.float32)).to(dev)
            y = FT.fused_mlp_train_fwd(x, ws, bs)
            yp = FT.fused_mlp_train_fwd_plain(x, ws, bs)
            fwd_out = float(((y - yp).abs() > FWD_TOL[1]
                             + FWD_TOL[0] * yp.abs()).double().mean())
            got = FT.fused_mlp_train_bwd(x, dy, ws, bs)
            want = FT.fused_mlp_train_bwd_plain(x, dy, ws, bs)
            worst = max(rel_l2(a, w) for a, w in zip(got[0] + got[1],
                                                     want[0] + want[1]))
            if fwd_out > 0 or worst > GRAD_TOL:
                bad.append(f"{label} B={b}: forward {fwd_out:.3%} outside, "
                           f"gradients rel-L2 {worst:.3e}")
            fns = {"new": (lambda: FT.fused_mlp_train_fwd(x, ws, bs),
                           lambda: FT.fused_mlp_train_bwd(x, dy, ws, bs),
                           FT.make_fused_mlp_train(widths))}
            if old:
                fns["old"] = (lambda: old.fused_mlp_train_fwd(x, ws, bs),
                              lambda: old.fused_mlp_train_bwd(x, dy, ws, bs),
                              old.make_fused_mlp_train(widths))

            def step(apply):
                def run():
                    apply(x, wg, bg).backward(dy)
                return run

            times = {}
            for part, idx in (("fwd", 0), ("bwd", 1), ("fwd_bwd", 2)):
                order = ["old", "new", "new", "old"] if old else ["new"]
                acc = {}
                for who in order:
                    fn = fns[who][idx]
                    fn = step(fn) if part == "fwd_bwd" else fn
                    acc.setdefault(who, []).append(
                        time_ms(torch, fn, args.iters))
                for who, ts in acc.items():
                    times[f"{part}_{who}"] = sum(ts) / len(ts)
            plain = {"fwd": lambda: FT.fused_mlp_train_fwd_plain(x, ws, bs),
                     "bwd": lambda: FT.fused_mlp_train_bwd_plain(x, dy, ws,
                                                                  bs),
                     "fwd_bwd_autograd": step(FT.fused_mlp_train_fwd_plain)}
            for k, fn in plain.items():
                times[f"{k}_plain"] = time_ms(torch, fn, args.iters)
            row = {"net": label, "B": b, "ms": times,
                   "bounds": bounds_ms(widths, b),
                   "fwd_outside": fwd_out, "grad_max_rel_l2": worst,
                   "bwd_split_ms": split_ms(
                       torch, lambda: FT.fused_mlp_train_bwd(x, dy, ws, bs))}
            if old:
                row["bwd_split_ms_old"] = split_ms(
                    torch, lambda: old.fused_mlp_train_bwd(x, dy, ws, bs))
            if args.sweep and label == "v1" and b == max(batches):
                row["sweep"] = sweep(torch, FT, x, dy, ws, bs, got,
                                     args.iters)
            rows_out.append(row)
            print(f"{label} B={b:5d}: " + "  ".join(
                f"{k} {v:.4f}" for k, v in times.items())
                + f"  (ms)  bwd split {row['bwd_split_ms']}  grad rel-L2 "
                f"{worst:.3e}", flush=True)
    print(json.dumps({"card": card, "rows": rows_out}))
    if bad:
        print("outside tolerance: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def sweep(torch, FT, x, dy, ws, bs, want, iters) -> dict:
    """The backward at every (dW width, dh width, chunks) ``replan``
    gives, each held to the plan's gradients within TILE_TOL."""
    from .ops.kernels import _device_limits

    limit = _device_limits(x.device.index)[0]
    widths = (x.shape[1],) + tuple(w.shape[1] for w in ws)
    base = FT._train_plan(x.shape[0], widths, 128, x.device)
    pack = FT.pack_train_params(ws, bs)
    out = {}
    for dw_bn in FT.GEMM_BN:
        for dh_bn in FT.GEMM_DH_BN:
            for chunks in (None, 4, 8, 16, 32):
                p = replan(base, limit, dw_bn, dh_bn, chunks)
                got = FT._launch_backward(x, dy, pack, p)
                for a, w in zip(got[0] + got[1], want[0] + want[1]):
                    if ((a - w).abs() > TILE_TOL[1]
                            + TILE_TOL[0] * w.abs()).any():
                        raise RuntimeError(
                            f"sweep dw {dw_bn} dh {dh_bn} chunks {chunks}: "
                            f"outside {TILE_TOL} of the plan's gradients")
                key = f"dw{dw_bn}_dh{dh_bn}_chunks{chunks or 'plan'}"
                out[key] = time_ms(torch, lambda: FT._launch_backward(
                    x, dy, pack, p), iters)
    best = sorted(out.items(), key=lambda kv: kv[1])[:5]
    print("  sweep best: " + ", ".join(f"{k} {v:.4f}" for k, v in best),
          flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
