"""Benchmark: kernels 2 and 3 (the served fused MLP, bf16 and int8 weights)
on one GPU, against another build of them.

The full-width MLP_v2rh (557 -> 1024 x 4 -> 368, weights drawn from
--seed) at each batch of --batches, for bf16 and int8 weights: the
kernel of this checkout is held against its plain version (bf16: every
element within rtol 2e-4 / atol 1e-4; int8, whose bf16 roundings may flip
against the plain version's sums: the share outside is printed) and timed
(CUDA events around a replayed CUDA graph of --iters calls: device time)
beside its bound, the larger of the bytes it must move (x in, y out, the
weights, biases and scales once) over 3.35 TB/s and its products over 989
TFLOP/s bf16 (H100 SXM data sheet, dense).

``--old DIR`` also imports the port of the checkout in DIR (an earlier
commit with the tensor-core kernel, unpacked with ``git archive`` into a
git-ignored directory) beside this one as the package ``cst_old``, whose
wrappers build and load that checkout's own kernel library, packs the
same weights with its ``pack_mlp``, times the two in turns, old, new,
new, old, on the same inputs, and says whether the two give the same
bits and how far the old kernel's own two turns lie apart.
``--sweep`` times every (cluster, rows a tile, stages) that fits at each
batch; each must give the plan's output bit for bit (the K order does not
depend on the tiling): how the plan's rules were settled.

Prints a line a weight type and batch, then one JSON line.  Without a CUDA
device it exits non-zero.

  python -m climsim_tpu_torch.bench_mlp_forward [--old _checkout]
      [--batches 1,50,384,1536,6144] [--sweep] [--iters 20]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys

import numpy as np

from .bench_gn_conv3 import BF16_OPS_S, HBM_BYTES_S, time_ms
from .bench_io_kernels import load_old

WIDTHS = (557, 1024, 1024, 1024, 1024, 368)   # MLP_v2rh
RELU_TAIL = 8
TOL = (2e-4, 1e-4)    # kernel 2 against its plain version (rtol, atol)


def mlp_bound_ms(b: int, widths=WIDTHS, wbytes: int = 2) -> tuple:
    """(least time in ms, "bytes" or "operations") of one forward at batch
    b: x in and y out in float32, every weight (``wbytes`` each) and every
    bias (and, int8, scale) once; 2 b n_w operations at the bf16 peak."""
    n_w = sum(i * o for i, o in zip(widths[:-1], widths[1:]))
    n_b = sum(widths[1:])
    nbytes = (4 * b * (widths[0] + widths[-1]) + wbytes * n_w
              + 4 * n_b * (2 if wbytes == 1 else 1))
    t_bytes, t_ops = nbytes / HBM_BYTES_S, 2 * b * n_w / BF16_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def random_mlp(seed: int, widths=WIDTHS):
    """(weights (d_in, d_out), biases) as float32 numpy arrays: normal
    weights with std 1/sqrt(d_in), biases 0.1 N(0, 1)."""
    rng = np.random.default_rng(seed)
    ws = [(rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32)
          for i, o in zip(widths[:-1], widths[1:])]
    bs = [(0.1 * rng.standard_normal(o)).astype(np.float32)
          for o in widths[1:]]
    return ws, bs


def outside(torch, got, want, rtol=TOL[0], atol=TOL[1]) -> float:
    return float(((got - want).abs() > atol + rtol * want.abs()).double()
                 .mean())


def sweep_plans(K, rows, mlp, props, int8):
    """Every (cluster, nwg, stages) plan of the kernel that fits."""
    for cluster in K.MLP_CLUSTERS:
        base = K.plan_mlp_forward(64, mlp.widths,
                                  props.shared_memory_per_block_optin,
                                  props.multi_processor_count, cluster, int8)
        for nwg in (1, 2):
            for st in range(2, K.MLP_STAGES + 1):
                smem = K._mlp_smem(int8, nwg, base.nb, st)
                if smem <= props.shared_memory_per_block_optin:
                    yield dataclasses.replace(
                        base, nwg=nwg, stages=st, smem=smem,
                        tiles_m=-(-rows // (64 * nwg)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="a checkout whose kernel library to time beside")
    ap.add_argument("--batches", default="1,50,384,1536,6144")
    ap.add_argument("--sweep", action="store_true",
                    help="time every tiling that fits at each batch")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_mlp_forward: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    from .ops import kernels as K

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda")
    props = torch.cuda.get_device_properties(dev)
    old = load_old(args.old) if args.old else None
    ws, bs = random_mlp(args.seed)
    batches = [int(v) for v in args.batches.split(",")]
    x_all = torch.from_numpy(np.random.default_rng(args.seed + 1)
                             .standard_normal((max(batches), WIDTHS[0]))
                             .astype(np.float32)).to(dev)
    rows_out, bad = [], []
    for w, dt in (("bf16", torch.bfloat16), ("int8", "int8")):
        mlp = K.pack_mlp(ws, bs, dt, dev)
        new = K.fused_mlp_forward_int8 if w == "int8" else K.fused_mlp_forward
        if old:
            old_mlp = old.pack_mlp(ws, bs, dt, dev)
            old_fn = (old.fused_mlp_forward_int8 if w == "int8"
                      else old.fused_mlp_forward)
        plain = (K.fused_mlp_forward_int8_plain if w == "int8"
                 else K.fused_mlp_forward_plain)
        for b in batches:
            x = x_all[:b].contiguous()
            plan = K._mlp_plan(b, mlp, dev)
            want = plain(x, mlp, RELU_TAIL)
            got = new(x, mlp, RELU_TAIL)
            share = {"new": outside(torch, got, want)}
            if old:
                old_out = old_fn(x, old_mlp, RELU_TAIL)
                share["old"] = outside(torch, old_out, want)
                same = torch.equal(torch.nan_to_num(old_out),
                                   torch.nan_to_num(got))
            if w == "bf16":
                bad += [f"{k} bf16 kernel at B={b}: {v:.3%} outside {TOL}"
                        for k, v in share.items() if v > 0]

            def new_fn():
                return new(x, mlp, RELU_TAIL)

            if old:
                o1 = time_ms(torch, lambda: old_fn(x, old_mlp, RELU_TAIL),
                             args.iters)
                n1 = time_ms(torch, new_fn, args.iters)
                n2 = time_ms(torch, new_fn, args.iters)
                o2 = time_ms(torch, lambda: old_fn(x, old_mlp, RELU_TAIL),
                             args.iters)
                t = {"new": (n1 + n2) / 2, "old": (o1 + o2) / 2}
                turns = {"old": [o1, o2], "new": [n1, n2]}
            else:
                t = {"new": time_ms(torch, new_fn, args.iters)}
            bound, by = mlp_bound_ms(b, wbytes=1 if w == "int8" else 2)
            row = {"weights": w, "B": b, "ms": t, "bound_ms": bound,
                   "bound_by": by, "outside": share,
                   "plan": {"cluster": plan.cluster, "rows": plan.rows,
                            "nb": plan.nb, "stages": plan.stages,
                            "grid": plan.grid, "smem": plan.smem}}
            if old:
                row["bit_equal_to_old"] = same
                row["turns_ms"] = turns
                # how far the old kernel's own two turns lie apart
                row["old_spread"] = abs(o1 - o2) / t["old"]
            if args.sweep:
                row["sweep_ms"] = {}
                for p in sweep_plans(K, b, mlp, props, w == "int8"):
                    if K._active_clusters(dev, w == "int8", p) == 0:
                        continue
                    out = K._launch_wgmma(x, mlp, RELU_TAIL, 3, p)
                    if not torch.equal(torch.nan_to_num(out),
                                       torch.nan_to_num(got)):
                        raise RuntimeError(
                            f"plan {p.cluster}x{p.rows}s{p.stages} at B={b} "
                            f"({w}) changes the output's bits")
                    row["sweep_ms"][f"c{p.cluster}r{p.rows}s{p.stages}"] = \
                        time_ms(torch, lambda: K._launch_wgmma(
                            x, mlp, RELU_TAIL, 3, p), args.iters)
            rows_out.append(row)
            print(f"{w} B={b:5d}: " + "  ".join(
                f"{k} {v:.4f} ms" for k, v in t.items())
                + (f"  new/old {t['new'] / t['old']:.4f} (old's own turns "
                   f"{row['old_spread']:.2%} apart)  bit-equal to old "
                   f"{same}" if old else "")
                + "  outside " + " ".join(f"{k} {v:.4%}"
                                          for k, v in share.items())
                + f"  bound {bound:.5f} ms ({by})  plan cluster "
                f"{plan.cluster} x {plan.rows} rows, {plan.nb} chunks a CTA,"
                f" {plan.stages} stages, {plan.grid} CTAs"
                + ("  sweep best " + " ".join(
                    f"{k} {v:.4f}" for k, v in sorted(
                        row["sweep_ms"].items(), key=lambda kv: kv[1])[:4])
                   if args.sweep else ""), flush=True)
    if old:
        slower = [f"{r['weights']} B={r['B']}" for r in rows_out
                  if r["ms"]["new"] > r["ms"]["old"]]
        print(f"batches where new is slower: {slower or 'none'}", flush=True)
        beyond = [f"{r['weights']} B={r['B']}" for r in rows_out
                  if r["ms"]["new"] > r["ms"]["old"] * (1 + r["old_spread"])]
        print(f"slower beyond the old turns' spread: {beyond or 'none'}",
              flush=True)
    print(json.dumps({"card": card, "rows": rows_out}))
    if bad:
        print("outside tolerance: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
