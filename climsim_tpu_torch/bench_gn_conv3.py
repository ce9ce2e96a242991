"""Benchmark: kernel 5 (fused GroupNorm -> silu -> conv3) on one GPU, shape
by shape, against another build of it.

At each of the 13 (L, C, Cout) chain shapes of the unet_v5 forward
(``unet_v5_chains``, with each shape's count in one forward) and each batch
of --batches, the kernel of this checkout is held against its plain
version (within ``GN_TOL`` of max|y|) and timed (CUDA events around a
replayed CUDA graph of --iters calls: device time) beside its bound: the larger of the bytes it must move (x in, y out, gamma,
beta, bias, the bf16 weights, each once) over 3.35 TB/s and its bf16
products over 989 TFLOP/s (H100 SXM data sheet, dense).

``--old DIR`` also builds the kernel library of the checkout in DIR (an
earlier commit, unpacked with ``git archive`` into a git-ignored
directory), loads it beside this one, checks its output the same way and
times the two in turns, old, new, new, old, on the same inputs.  Its C
entry is taken with the argument list it had before the tile plan (no
nwg, nt, stages, samples).  ``--sweep`` times every tiling of
``_TILES`` with 2 and with 3 weight stages that fits, at each shape and
batch (each must give the plan's output bit for bit): how the plan's
rules were settled.

Prints a line a shape and batch, then one JSON line: per shape and batch
the times (ms), the bound, the plan, and the 82-chain sums.  Without a
CUDA device it exits non-zero.

  python -m climsim_tpu_torch.bench_gn_conv3 [--old _checkout]
      [--batches 384,1024] [--sweep] [--iters 20]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

GN_TOL = 5e-4         # * max|y|, as chip_smoke.py
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12


def unet_v5_chains() -> dict:
    """(L, C, Cout) -> calls: the 82 fused chains of one unet_v5 forward,
    counted from the model's shapes (on the meta device)."""
    from . import get_varspec
    from .models.unet import ClimSimUNet
    from .serve import UNET_V5

    return ClimSimUNet(get_varspec("v5"), fused_gn_conv=True,
                       **UNET_V5).fused_chains(16)


def chain_bound_ms(b: int, l: int, c: int, cout: int) -> tuple:
    """(least time in ms, "bytes" or "operations") of one chain call."""
    nbytes = 4 * b * l * (c + cout) + 4 * (2 * c + cout) + 2 * 3 * c * cout
    ops = 2 * b * l * 3 * c * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chain_args(torch, g, b, l, c, cout, offset=0.0, wdtype=None):
    """Inputs of one fused chain on the card: x ~ N(offset, 1), gamma ~
    1 + 0.2 N, beta ~ 0.1 N, w xavier-uniform in ``wdtype`` (bf16 by
    default), bias ~ 0.1 N."""
    def randn(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    lim = (6.0 / (3 * (c + cout))) ** 0.5
    w = (torch.rand(3, c, cout, device="cuda", generator=g) * 2 - 1) * lim
    return (randn(b, l, c) + offset, 1.0 + 0.2 * randn(c), 0.1 * randn(c),
            w.to(wdtype or torch.bfloat16).contiguous(), 0.1 * randn(cout))


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one CUDA
    graph and replayed: the host's time a call (the wrapper's checks and
    its ctypes launch, tens of microseconds) is left out, so a short
    kernel is timed and not its launch."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def load_old(root: str):
    """Build the kernel library of the checkout at ``root`` (in a child
    process, from that checkout's own ``ops/_build.py``) and return
    ``fn(x, gamma, beta, w, b) -> out`` on its kernel-5 entry."""
    import torch

    from .models.unet import _num_groups
    from .ops.unet_fused import EPS

    root = str(Path(root).resolve())
    res = subprocess.run(
        [sys.executable, "-c", "from climsim_tpu_torch.ops import _build; "
         "print(_build.build())"], cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": root}, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"building {root} failed:\n{res.stdout}"
                           f"{res.stderr}")
    lib = ctypes.CDLL(res.stdout.strip().splitlines()[-1])
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.cst_fused_gn_silu_conv3
    fn.argtypes = [P] * 6 + [I] * 5 + [ctypes.c_float, P]
    fn.restype = I

    def run(x, gamma, beta, w, b):
        bsz, l, c = x.shape
        out = torch.empty(bsz, l, w.shape[2], device=x.device)
        # the current stream: a CUDA graph captures the launch
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, l, c,
                  w.shape[2], _num_groups(c), EPS,
                  torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"the old kernel returned CUDA error {code}")
        return out

    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="a checkout whose kernel library to time beside")
    ap.add_argument("--batches", default="384,1024")
    ap.add_argument("--sweep", action="store_true",
                    help="time every tiling that fits at each shape")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_gn_conv3: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    from .ops import unet_fused as PU

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    old = load_old(args.old) if args.old else None
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    props = torch.cuda.get_device_properties(0)
    rows, sums, bad = [], {}, []
    chains = unet_v5_chains()
    for b in (int(v) for v in args.batches.split(",")):
        for (l, c, cout), calls in chains.items():
            a = chain_args(torch, g, b, l, c, cout)
            plan = PU._device_plan(b, l, c, cout, a[0].device)
            want = PU.xla_gn_silu_conv3_plain(*a)
            scale = float(want.abs().max())
            got = PU.fused_gn_silu_conv3(*a)
            errs = {"new": float((got - want).abs().max()) / scale}
            if old:
                errs["old"] = float((old(*a) - want).abs().max()) / scale
            bad += [f"{k} kernel at B={b} L={l} C={c} Cout={cout}: "
                    f"{e:.3e} of max|y|" for k, e in errs.items()
                    if not e <= GN_TOL]
            def new_fn():
                return PU.fused_gn_silu_conv3(*a)

            if old:
                o1 = time_ms(torch, lambda: old(*a), args.iters)
                n1 = time_ms(torch, new_fn, args.iters)
                n2 = time_ms(torch, new_fn, args.iters)
                o2 = time_ms(torch, lambda: old(*a), args.iters)
                t = {"new": (n1 + n2) / 2, "old": (o1 + o2) / 2}
            else:
                t = {"new": time_ms(torch, new_fn, args.iters)}
            bound, by = chain_bound_ms(b, l, c, cout)
            row = {"B": b, "L": l, "C": c, "Cout": cout, "calls": calls,
                   "ms": t, "bound_ms": bound, "bound_by": by,
                   "err_of_max_y": errs,
                   "plan": {"nwg": plan.nwg, "nt": plan.nt,
                            "stages": plan.stages, "samples": plan.samples,
                            "rows": plan.rows, "n_tile": plan.n_tile,
                            "grid": plan.grid, "smem": plan.smem}}
            if args.sweep:
                out = torch.empty(b, l, cout, device="cuda")
                row["sweep_ms"] = {}
                for tiles in [(*t, st) for t in PU._TILES for st in (2, 3)]:
                    try:
                        p = PU.plan_gn_silu_conv3(
                            b, l, c, cout, props.shared_memory_per_block_optin,
                            props.multi_processor_count, tiles)
                    except ValueError:
                        continue
                    PU._launch(*a, out, p)
                    if not torch.equal(out, got):
                        raise RuntimeError(
                            f"tiling {tiles} at B={b} L={l} C={c} Cout={cout}"
                            " changes the output's bits")
                    row["sweep_ms"]["{}x{}s{}".format(*tiles)] = time_ms(
                        torch, lambda: PU._launch(*a, out, p), args.iters)
            rows.append(row)
            for k, v in t.items():
                sums[(b, k)] = sums.get((b, k), 0.0) + calls * v
            sums[(b, "bound")] = sums.get((b, "bound"), 0.0) + calls * bound
            print(f"B={b:5d} L={l:2d} C={c:3d} Cout={cout} x{calls:2d}: "
                  + "  ".join(f"{k} {v:.4f} ms" for k, v in t.items())
                  + "  errors " + " ".join(f"{k} {e:.2e}"
                                           for k, e in errs.items())
                  + f"  bound {bound:.4f} ms ({by}; new at "
                  f"{bound / t['new']:.1%})  plan {plan.nwg}x{plan.nt} "
                  f"S={plan.samples} stages={plan.stages} grid={plan.grid}"
                  + ("  sweep best " + " ".join(
                      f"{k} {v:.4f}" for k, v in sorted(
                          row["sweep_ms"].items(), key=lambda kv: kv[1])[:4])
                     if args.sweep else ""), flush=True)
    for (b, k), v in sorted(sums.items()):
        print(f"B={b}: 82-chain sum {k} {v:.4f} ms", flush=True)
    if old:
        for b in sorted({b for b, _ in sums}):
            slower = [f"L={r['L']} C={r['C']} Cout={r['Cout']}" for r in rows
                      if r["B"] == b and r["ms"]["new"] > r["ms"]["old"]]
            print(f"B={b}: new / old {sums[(b, 'new')] / sums[(b, 'old')]:.4f}"
                  f"; shapes where new is slower: {slower or 'none'}",
                  flush=True)
    print(json.dumps({"card": card, "rows": rows, "sums": {
        f"{k}_B{b}": v for (b, k), v in sums.items()}}))
    if bad:
        print("outside GN_TOL: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
