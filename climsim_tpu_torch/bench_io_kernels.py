"""Benchmark: kernels 1 and 4 (the input transform and the v5 constraint
head) on one GPU, against another build of them.

Kernel 1 at the v2_rh width (557) at B = 1, 384 and 6144, at the v1
trainer's (124, B = 32768) and the v5 wrapper's (1405, B = 1024); kernel 4
at B = 1, 384 and 6144, with t, qc and qi as views of a raw (B, 1525) v4
row, as the U-Net wrapper passes them.  At each shape the kernel of this
checkout is held against its plain version (kernel 1 bit-equal; kernel 4
within rtol 2e-4 / atol 1e-9, bit-equality printed) and timed two ways:

  * device time: CUDA events around a replayed CUDA graph of --iters calls
    (the host's time a call left out), beside the bound, the bytes it must
    move (every input read once, the output written once) over 3.35 TB/s
    (H100 SXM data sheet);
  * host cost a call: the host clock around --host-calls calls of the
    Python wrapper issued back to back without a synchronize (the card's
    queue absorbs them), the least of five runs (the host's noise only
    adds time).

``--sweep`` also times other tilings at each shape (rows a tile, direct
or pipelined), each bit-equal to the plan's output, and adds B = 32768 of
both kernels, whose inputs do not fit the 50 MB L2: how the plans' rules
were settled.

``--old DIR`` also imports the port of the checkout in DIR (an earlier
commit, unpacked with ``git archive`` into a git-ignored directory) as the
package ``cst_old``, whose wrappers build and load that checkout's own
kernel library, checks its output the same way, and times both wrappers
in turns, old, new, new, old, twice over, on the same inputs (the old
constraint head on contiguous copies of t, qc and qi, which it needs):
device time and host cost alike.

Prints a line a kernel and shape, then one JSON line.  Without a CUDA
device it exits non-zero.

  python -m climsim_tpu_torch.bench_io_kernels [--old _checkout]
      [--sweep] [--iters 50] [--host-calls 200] [--seed 0]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from .bench_gn_conv3 import HBM_BYTES_S, time_ms

HEAD_TOL = (2e-4, 1e-9)    # tests/test_pallas_kernels.py:69
# (label, variable set, rows): kernel 1's shapes, then kernel 4's rows
TRANSFORM_SHAPES = (("v2_rh B=1", "v2_rh", 1), ("v2_rh B=384", "v2_rh", 384),
                    ("v2_rh B=6144", "v2_rh", 6144),
                    ("v1 B=32768", "v1", 32768), ("v5 B=1024", "v5", 1024))
HEAD_ROWS = (1, 384, 6144)
# with --sweep also: inputs past the 50 MB L2 (cold), 73 MB and 112 MB
SWEEP_TRANSFORM_SHAPES = (("v2_rh B=32768", "v2_rh", 32768),)
SWEEP_HEAD_ROWS = (32768,)

def transform_bound_ms(b: int, d: int) -> float:
    """Kernel 1: x in, out back (4 B each an element), the (7, d) constants
    once, over the memory rate (about six float32 operations an element,
    far below the card's 67 TFLOP/s)."""
    return (8 * b * d + 28 * d) / HBM_BYTES_S * 1e3


def head_bound_ms(b: int) -> float:
    """Kernel 4: y (308), t, qc, qi (60 each) in, out (368) back, 4 B each,
    and the (2, 308) constants once."""
    return (3424 * b + 2464) / HBM_BYTES_S * 1e3


def load_old(root: str, submodule: str = "ops.kernels"):
    """The ``submodule`` of the port in the checkout at ``root`` (an
    earlier commit), imported beside this one as the package ``cst_old``:
    its own wrappers, which build and load its own kernel library at first
    use."""
    import importlib
    import importlib.util

    pkg = Path(root).resolve() / "climsim_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        "cst_old", pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["cst_old"] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"cst_old.{submodule}")


def host_ms(fns: dict, calls: int) -> dict:
    """{name: host ms a call} of the wrappers ``fns``, in turns (the order
    of ``fns``, then back), twice over: the host clock around ``calls``
    calls issued back to back without a synchronize (the card's queue
    absorbs them), the least of five runs a turn (the host's noise only
    adds time), averaged over a name's turns."""
    import torch

    order = list(fns) + list(fns)[::-1]
    got = {k: [] for k in fns}
    for k in order + order:
        runs = []
        for _ in range(6):
            for _ in range(3):
                fns[k]()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fns[k]()
            runs.append((time.perf_counter() - t0) * 1e3 / calls)
            torch.cuda.synchronize()
        got[k].append(min(runs[1:]))
    return {k: float(np.mean(v)) for k, v in got.items()}


def in_turns(torch, fns: dict, iters: int) -> dict:
    """{name: device ms} of the calls ``fns`` (new, and old where there is
    one): graph replays in turns old, new, new, old, twice over; each the
    mean of its turns."""
    order = list(fns) + list(fns)[::-1]
    t = {k: [] for k in fns}
    for k in order + order:
        t[k].append(time_ms(torch, fns[k], iters))
    return {k: float(np.mean(v)) for k, v in t.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="a checkout whose kernel library to time beside")
    ap.add_argument("--sweep", action="store_true",
                    help="time other tilings at each shape")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--host-calls", type=int, default=200,
                    help="wrapper calls a run of the host cost")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bench_io_kernels: no CUDA device; this benchmark runs on the "
              "GPU", file=sys.stderr)
        return 1
    from . import get_varspec, load_asset_norms, load_default_grid
    from .data import transforms as T
    from .data.synthetic import synthetic_inputs
    from .ops import kernels as K

    card = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    old = load_old(args.old) if args.old else None
    grid = load_default_grid()
    cfgs = {"v2_rh": T.TransformConfig(input_clip=True,
                                       input_clip_rhonly=True),
            "v1": T.TransformConfig(),
            "v5": T.TransformConfig(qn_transform=True, qinput_prune=True,
                                    strato_lev=15, input_clip=True,
                                    input_clip_rhonly=True)}
    rows_out, bad = [], []

    transform_shapes = TRANSFORM_SHAPES + (
        SWEEP_TRANSFORM_SHAPES if args.sweep else ())
    head_rows = HEAD_ROWS + (SWEEP_HEAD_ROWS if args.sweep else ())

    def both(new_fn, old_fn):
        return {"new": new_fn} if old is None else {"old": old_fn,
                                                     "new": new_fn}

    for label, var, b in transform_shapes:
        spec = get_varspec(var)
        consts = T.input_transform_consts(spec, load_asset_norms(var),
                                          cfgs[var], "cuda")
        x = torch.from_numpy(synthetic_inputs(spec, b, grid,
                                              seed=args.seed)).cuda()
        want = K.fused_input_transform_plain(x, consts)
        fns = both(lambda: K.fused_input_transform(x, consts),
                   old and (lambda: old.fused_input_transform(x, consts)))
        equal = {k: bool(torch.equal(fn(), want)) for k, fn in fns.items()}
        if not equal["new"]:
            bad.append(f"kernel 1 {label}: not bit-equal to plain")
        t = in_turns(torch, fns, args.iters)
        host = host_ms(fns, args.host_calls)
        extra = {"bit_equal": equal,
                 "plan": plan_dict(K.plan_input_transform(
                     b, spec.input_len, *K._device_limits(0)))}
        if args.sweep:
            extra["sweep_ms"] = sweep(
                torch, K, lambda p: K._launch_transform(x, consts, p),
                want, [K.plan_input_transform(b, spec.input_len,
                                              *K._device_limits(0), r, dr)
                       for dr, rs in ((True, (1, 2, 4, 8, 16)),
                                      (False, (4, 8, 16, 32)))
                       for r in rs
                       if fits(lambda: K.plan_input_transform(
                           b, spec.input_len, *K._device_limits(0), r,
                           dr))],
                args.iters)
        rows_out.append(report("fused_input_transform", label, t,
                               transform_bound_ms(b, spec.input_len), host,
                               extra))

    stats5 = load_asset_norms("v5")
    head_consts = K.constraint_head_consts(stats5.out_scale, 15,
                                           device="cuda")
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    for b in head_rows:
        raw = torch.randn(b, 1525, device="cuda", generator=g)
        raw[:, 0:60] = 250.0 + 40.0 * torch.rand(b, 60, device="cuda",
                                                 generator=g)
        raw[:, 120:240] = 1e-5 * torch.rand(b, 120, device="cuda",
                                            generator=g)
        y = torch.randn(b, 308, device="cuda", generator=g)
        views = (raw[:, 0:60], raw[:, 120:180], raw[:, 180:240])
        copies = tuple(v.contiguous() for v in views)
        want = K.fused_constraint_head_plain(y, *views, head_consts, 1200.0)
        # each as its wrapper takes them: the old one needs copies
        fns = both(lambda: K.fused_constraint_head(y, *views, head_consts,
                                                   1200.0),
                   old and (lambda: old.fused_constraint_head(
                       y, *copies, head_consts, 1200.0)))
        outs = {k: fn() for k, fn in fns.items()}
        check = {}
        for who, got in outs.items():
            ok = bool(((got - want).abs() <= HEAD_TOL[1]
                       + HEAD_TOL[0] * want.abs()).all())
            check[who] = {"within_tol": ok,
                          "bit_equal": bool(torch.equal(got, want)),
                          "max_abs_err": float((got - want).abs().max())}
            if who == "new" and not ok:
                bad.append(f"kernel 4 B={b}: outside {HEAD_TOL}")
        t = in_turns(torch, fns, args.iters)
        host = host_ms(fns, args.host_calls)
        extra = {"check": check, "plan": plan_dict(K.plan_constraint_head(
            b, *K._device_limits(0)))}
        if args.sweep:
            extra["sweep_ms"] = sweep(
                torch, K, lambda p: K._launch_head(y, *views, head_consts,
                                                   1200.0, p),
                outs["new"], [K.plan_constraint_head(
                    b, *K._device_limits(0), r, dr)
                    for r in (1, 2, 4, 8, 12) for dr in (False, True)],
                args.iters)
        rows_out.append(report("fused_constraint_head", f"B={b}", t,
                               head_bound_ms(b), host, extra))

    if old is not None:
        slower = [f"{r['kernel']} {r['shape']}" for r in rows_out
                  if r["ms"]["new"] > r["ms"]["old"]]
        print(f"shapes where new is slower (device time): "
              f"{slower or 'none'}", flush=True)
    print(json.dumps({"card": card, "rows": rows_out}))
    if bad:
        print("failed: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def plan_dict(plan) -> dict:
    return {k: getattr(plan, k) for k in ("rows", "stages", "grid",
                                          "threads", "direct", "smem")}


def fits(make) -> bool:
    """Whether ``make()`` gives a plan (ValueError: the tiling does not fit
    the card)."""
    try:
        make()
    except ValueError:
        return False
    return True


def sweep(torch, K, run, want, plans, iters) -> dict:
    """{"r<rows>[d]": ms} of ``run(plan)`` for each plan (d: direct), each
    required bit-equal to ``want``."""
    out = {}
    for p in plans:
        key = f"r{p.rows}{'d' if p.direct else ''}"
        if not torch.equal(run(p), want):
            raise RuntimeError(f"tiling {key} changes the output's bits")
        out[key] = time_ms(torch, lambda: run(p), iters)
    return out


def report(kernel, shape, t, bound_ms, host, extra) -> dict:
    """Print one kernel and shape; its JSON row."""
    print(f"{kernel:22s} {shape:13s} device " + "  ".join(
        f"{k} {v * 1e3:8.3f} us" for k, v in t.items())
        + (f"  new/old {t['new'] / t['old']:.3f}" if "old" in t else "")
        + f"  bound {bound_ms * 1e3:7.3f} us (new at "
        f"{bound_ms / t['new']:.1%})  host cost a call " + "  ".join(
            f"{k} {v * 1e3:7.2f} us" for k, v in host.items())
        + (f"  new/old {host['new'] / host['old']:.3f}" if "old" in host
           else "") + f"  {extra}", flush=True)
    return {"kernel": kernel, "shape": shape, "ms": t, "bound_ms": bound_ms,
            "bound_by": "bytes", "host_ms": host, **extra}


if __name__ == "__main__":
    sys.exit(main())
