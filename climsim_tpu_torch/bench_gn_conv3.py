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
times the two in turns, old, new, new, old, on the same inputs, and says
whether their outputs are bit-equal.  Its C entry is taken with the
argument list its ``_build`` declares: before the tile plan without nwg,
nt, stages and samples, since it with this checkout's plan.  ``--sweep``
times every tiling of ``_TILES`` with 2 and with 3 weight stages that
fits, at each shape and batch (each must give the plan's output bit for
bit): how the plan's rules were settled.

Prints a line a shape and batch, then one JSON line: per shape and batch
the times (ms), the bound, the plan, and the 82-chain sums.  Without a
CUDA device it exits non-zero.

``--backward`` takes 5''s backward instead (``fused_gn_silu_conv3_bwd``):
at each chain shape and batch its five gradients are held against
autograd of the plain chain (cuDNN off: reproducible convolutions) within
``GN_BWD_TOL`` (rel-L2 and cosine, as chip_smoke.py), and it is timed
(CUDA-graph replays) beside its bound (x and g read, dx written, the bf16
weights read and dw written, each once, over 3.35 TB/s, against dgrad's
and wgrad's bf16 products over 989 TFLOP/s), beside autograd of the plain
chain with cuDNN on (the chain recomputed and differentiated: the path
the kernel replaced; CUDA events over back-to-back calls), and beside
``torch.ops.aten.convolution_backward`` on the bf16 operands (dgrad and
wgrad of the conv alone, cuDNN: a yardstick, not the same function).
``--seeds 0,1,2,3`` first prints, a seed at a time, the readings the
tolerance rests on: the plain version against its twin with float64 sums,
the kernel and the control without the bf16 roundings of g, dxn and dw
against autograd; ``--sweep`` then times every (samples, nb, stages,
splits, dgrad blocks an SM) around the plan's at the largest batch.

  python -m climsim_tpu_torch.bench_gn_conv3 [--old _checkout]
      [--batches 384,1024] [--sweep] [--iters 20]
  python -m climsim_tpu_torch.bench_gn_conv3 --backward [--batches 1024]
      [--seeds 0,1,2,3]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

GN_TOL = 5e-4         # * max|y|, as chip_smoke.py
GRADS = ("dx", "dgamma", "dbeta", "dw", "db")
# ragged shapes the plans must take: L fills no tile, Cout no 64-column box
GN_RAGGED = ((60, 64, 48), (15, 128, 80))
# a chain of the 256-channel unet_v5 whose first tiling overflows shared
# memory at B = 1024 (kernel 5's plan steps the samples a tile down)
GN_STEPPED = (8, 1024, 512)
# 5''s backward kernel against autograd of the plain chain (cuDNN off), a
# gradient at a time: rel-L2 at most GN_BWD_TOL[0], cosine at least
# GN_BWD_TOL[1] (here and in chip_smoke.py's phase 10).  Both round g,
# dxn and dw to bf16 at the same places and differ only in their float32
# orders of summation, but a rounding that flips moves a value by 2**-8.
# On an H100 (--backward --seeds 0,1,2,3, at --batches 16,1024 and at
# 384,1024: the 13 chain shapes, GN_RAGGED and GN_STEPPED) the plain
# version was 1.98e-4 to 2.51e-4 (rel-L2, its worst gradient a seed) from
# its twin with float64 sums, cosine at least 0.999999969, and the kernel
# 1.73e-4 to 2.71e-4 from autograd, cosine at least 0.999999963: the
# bound is 1e-3, four times the twin's reading, and 0.9999995.  The
# control without the three roundings was 2.71e-3 to 3.21e-3 off at its
# worst gradient a seed (in chip_smoke.py's phase 10 2.32e-3 at least on
# dx and on dw; on the CPU 1.8e-3 to 2.9e-3 on every gradient but db,
# which sums g unrounded): it must fail the bound on dx and dw.
GN_BWD_TOL = (1e-3, 0.9999995)
HBM_BYTES_S = 3.35e12
BF16_OPS_S = 989e12


def unet_v5_chains() -> dict:
    """(L, C, Cout) -> calls: the 82 fused chains of one unet_v5 forward,
    counted from the model's shapes (on the meta device)."""
    from . import get_varspec
    from .config import PRESETS
    from .models.unet import ClimSimUNet

    return ClimSimUNet(get_varspec("v5"), fused_gn_conv=True,
                       **PRESETS["unet_v5"].model_kw).fused_chains(16)


def chain_bound_ms(b: int, l: int, c: int, cout: int) -> tuple:
    """(least time in ms, "bytes" or "operations") of one chain call."""
    nbytes = 4 * b * l * (c + cout) + 4 * (2 * c + cout) + 2 * 3 * c * cout
    ops = 2 * b * l * 3 * c * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_OPS_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chain_bwd_bound_ms(b: int, l: int, c: int, cout: int) -> tuple:
    """(least time in ms, "bytes" or "operations") of one chain's backward:
    x and g read and dx written (float32), gamma and beta read, dgamma,
    dbeta and db written, the bf16 weights read and the float32 dw written,
    each once; dgrad's and wgrad's bf16 products."""
    nbytes = (4 * b * l * (2 * c + cout) + 4 * (4 * c + cout)
              + (2 + 4) * 3 * c * cout)
    ops = 2 * 2 * b * l * 3 * c * cout
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


def time_events(torch, fn, iters: int) -> float:
    """Mean time of ``fn`` over ``iters`` back-to-back calls between two
    CUDA events (for work a CUDA graph cannot capture, such as autograd
    with its allocations between calls)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def rel_l2(got, want) -> float:
    d = (got.double() - want.double()).norm()
    return float(d / want.double().norm().clamp_min(1e-300))


def cosine(got, want) -> float:
    a, b = got.double().flatten(), want.double().flatten()
    return float(a @ b / (a.norm() * b.norm()).clamp_min(1e-300))


def bwd_args(torch, g, b, l, c, cout):
    """One chain's inputs (``chain_args``, w in bf16) and a cotangent ~
    N(0, 1)."""
    return (*chain_args(torch, g, b, l, c, cout),
            torch.randn(b, l, cout, device="cuda", generator=g))


def autograd_plain(torch, PU, x, gamma, beta, w, bias, cot):
    """Autograd of the plain chain ``xla_gn_silu_conv3_plain(f32_accum=
    False)`` at the inputs, w the bf16 weight widened to float32: the five
    gradients, float32."""
    ins = [t.detach().requires_grad_()
           for t in (x, gamma, beta, w.float(), bias)]
    y = PU.xla_gn_silu_conv3_plain(*ins, torch.bfloat16, f32_accum=False)
    return torch.autograd.grad(y, ins, cot)


def conv_yardstick(torch, PU, x, gamma, beta, w, cot):
    """``fn()`` running ``aten.convolution_backward`` of the conv on bf16
    operands (xn as the forward rounds it, the rounded cotangent, w):
    dgrad and wgrad alone, through cuDNN."""
    c = x.shape[2]
    g = PU._num_groups(c)
    xg = x.reshape(*x.shape[:2], g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + PU.EPS)).reshape(x.shape)
    xn = torch.nn.functional.silu(xn * gamma + beta).to(torch.bfloat16)
    xn = xn.transpose(1, 2).contiguous()
    gb = cot.to(torch.bfloat16).transpose(1, 2).contiguous()
    wt = w.permute(2, 1, 0).contiguous()

    def fn():
        return torch.ops.aten.convolution_backward(
            gb, xn, wt, None, [1], [1], [1], False, [0], 1,
            [True, True, False])

    return fn


def bwd_readings(torch, PU, chains, batches, seeds) -> dict:
    """A seed at a time, at every shape and batch: the largest rel-L2
    and the least cosine, over the five gradients, of the plain version
    against its twin with float64 sums, of the kernel against autograd of
    the plain chain, and of the control (the roundings of g, dxn and dw
    left out) against it; cuDNN off."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.enabled
    cudnn.deterministic, cudnn.enabled = True, False
    out = {}
    try:
        for seed in seeds:
            g = torch.Generator(device="cuda").manual_seed(seed)
            worst = {k: [0.0, 1.0] for k in ("plain_twin", "kernel",
                                             "control")}
            for b in batches:
                for (l, c, cout) in chains:
                    a = bwd_args(torch, g, b, l, c, cout)
                    want = autograd_plain(torch, PU, *a)
                    got = PU.fused_gn_silu_conv3_bwd(*a)
                    plain = PU.fused_gn_silu_conv3_bwd_plain(*a)
                    twin = PU.fused_gn_silu_conv3_bwd_plain(
                        *a, sum_dtype=torch.float64)
                    ctl = PU.fused_gn_silu_conv3_bwd_plain(*a, rounded=False)
                    for k, (xs, ys) in (("plain_twin", (plain, twin)),
                                        ("kernel", (got, want)),
                                        ("control", (ctl, want))):
                        for x, y in zip(xs, ys):
                            worst[k][0] = max(worst[k][0], rel_l2(x, y))
                            worst[k][1] = min(worst[k][1], cosine(x, y))
            out[seed] = worst
            print(f"seed {seed}: " + "; ".join(
                f"{k} rel-L2 {v[0]:.3e} cosine {v[1]:.9f}"
                for k, v in worst.items()), flush=True)
    finally:
        cudnn.deterministic, cudnn.enabled = saved
    return out


def bwd_split(torch, PU, chains, b, seed) -> dict:
    """Device time of one backward of each chain of a step at batch ``b``
    (weighted by its count), by pass: dgrad with the GroupNorm backward,
    wgrad, the reduction, and the rest (the outputs' zero fills)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    out = dict.fromkeys(("dgrad", "wgrad", "reduce", "other"), 0.0)
    for (l, c, cout), calls in chains.items():
        a = bwd_args(torch, g, b, l, c, cout)
        PU.fused_gn_silu_conv3_bwd(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            PU.fused_gn_silu_conv3_bwd(*a)
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA or ev.is_user_annotation:
                continue
            key = next((k for k in ("dgrad", "wgrad", "reduce")
                        if k in ev.name), "other")
            out[key] += calls * ev.device_time_total / 1e3
    return out


def bwd_sweep(torch, PU, chains, b, seed, iters) -> dict:
    """Every (samples, nb, stages, splits, blocks an SM) around the plan's
    that fits, at each chain shape and batch ``b``: device time (CUDA-graph
    replays),
    each within GN_BWD_TOL of the plan's output (the partials' orders
    change with the tiles).  Prints the best four a shape."""
    g = torch.Generator(device="cuda").manual_seed(seed + 2)
    props = torch.cuda.get_device_properties(0)
    out = {}
    for (l, c, cout) in chains:
        a = bwd_args(torch, g, b, l, c, cout)
        p0 = PU._bwd_device_plan(b, l, c, cout, a[0].device)
        want = PU.fused_gn_silu_conv3_bwd(*a)
        outs = [torch.empty_like(t) for t in want]
        times = {}
        for force in sorted({(s, nb, st, z, bl)
                             for s in (p0.samples, max(1, p0.samples // 2))
                             for nb in (1, 2) for st in (2, 3)
                             for z in (p0.splits, 2 * p0.splits)
                             for bl in (1, 2)}):
            try:
                p = PU.plan_gn_silu_conv3_bwd(
                    b, l, c, cout, props.shared_memory_per_block_optin,
                    props.multi_processor_count, force)
            except ValueError:
                continue

            def run(p=p):
                PU._launch_bwd(*a[:4], a[5], outs, p)

            run()
            for n, x, y in zip(GRADS, outs, want):
                if not rel_l2(x, y) <= GN_BWD_TOL[0]:
                    raise RuntimeError(f"force {force} at L={l} C={c} "
                                       f"Cout={cout}: {n} off")
            times["S{}nb{}st{}z{}x{}".format(*force)] = time_ms(
                torch, run, iters)
        out[f"L={l} C={c} Cout={cout}"] = times
        best = sorted(times.items(), key=lambda kv: kv[1])[:4]
        print(f"sweep B={b} L={l} C={c} Cout={cout}: plan S={p0.samples} "
              f"nb={p0.nb} stages={p0.stages} splits={p0.splits} blocks="
              f"{p0.blocks}; best "
              + " ".join(f"{k} {v:.4f}" for k, v in best), flush=True)
    return out


def backward_main(args, torch, PU, card) -> int:
    """--backward: 5''s backward, shape by shape (see the module's doc)."""
    chains = unet_v5_chains()
    batches = [int(v) for v in args.batches.split(",")]
    shapes = [*chains, *GN_RAGGED, GN_STEPPED]
    readings = (bwd_readings(torch, PU, shapes, batches,
                             [int(v) for v in args.seeds.split(",")])
                if args.seeds else {})
    g = torch.Generator(device="cuda").manual_seed(args.seed)
    rows, sums, bad = [], {}, []
    cudnn = torch.backends.cudnn
    for b in batches:
        for (l, c, cout), calls in chains.items():
            a = bwd_args(torch, g, b, l, c, cout)
            got = PU.fused_gn_silu_conv3_bwd(*a)
            again = PU.fused_gn_silu_conv3_bwd(*a)
            saved = cudnn.deterministic, cudnn.enabled
            cudnn.deterministic, cudnn.enabled = True, False
            try:
                want = autograd_plain(torch, PU, *a)
            finally:
                cudnn.deterministic, cudnn.enabled = saved
            errs = {n: (rel_l2(x, y), cosine(x, y))
                    for n, x, y in zip(GRADS, got, want)}
            bad += [f"B={b} L={l} C={c} Cout={cout} {n}: rel-L2 {r:.3e} "
                    f"cosine {cs:.9f}" for n, (r, cs) in errs.items()
                    if not (r <= GN_BWD_TOL[0] and cs >= GN_BWD_TOL[1])]
            if not all(torch.equal(x, y) for x, y in zip(got, again)):
                bad.append(f"B={b} L={l} C={c} Cout={cout}: two runs differ")
            t = {"kernel": time_ms(
                     torch, lambda: PU.fused_gn_silu_conv3_bwd(*a),
                     args.iters),
                 "plain_autograd": time_events(
                     torch, lambda: autograd_plain(torch, PU, *a),
                     max(2, args.iters // 4)),
                 "cudnn_bf16_yardstick": time_ms(
                     torch, conv_yardstick(torch, PU, *a[:4], a[5]),
                     args.iters)}
            bound, by = chain_bwd_bound_ms(b, l, c, cout)
            plan = PU._bwd_device_plan(b, l, c, cout, a[0].device)
            rows.append({"B": b, "L": l, "C": c, "Cout": cout,
                         "calls": calls, "ms": t, "bound_ms": bound,
                         "bound_by": by, "errors": errs,
                         "plan": dataclasses.asdict(plan)})
            for k, v in t.items():
                sums[(b, k)] = sums.get((b, k), 0.0) + calls * v
            sums[(b, "bound")] = sums.get((b, "bound"), 0.0) + calls * bound
            print(f"B={b:5d} L={l:2d} C={c:3d} Cout={cout} x{calls:2d}: "
                  + "  ".join(f"{k} {v:.4f} ms" for k, v in t.items())
                  + f"  bound {bound:.4f} ms ({by}; kernel at "
                  f"{bound / t['kernel']:.1%})  worst rel-L2 "
                  f"{max(r for r, _ in errs.values()):.2e}  plan S="
                  f"{plan.samples} nb={plan.nb} stages={plan.stages} "
                  f"splits={plan.splits} blocks={plan.blocks}", flush=True)
    for (b, k), v in sorted(sums.items()):
        print(f"B={b}: 82-chain sum {k} {v:.4f} ms", flush=True)
    if args.sweep:
        sweep = bwd_sweep(torch, PU, chains, max(batches), args.seed,
                          args.iters)
    split = bwd_split(torch, PU, chains, max(batches), args.seed)
    print(f"B={max(batches)}: the 82 chains' backward by pass (torch."
          "profiler, device ms): " + ", ".join(
              f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    print(json.dumps({"card": card, "backward": True, "rows": rows,
                      "readings": readings, "split_ms": split,
                      **({"sweep_ms": sweep} if args.sweep else {}),
                      "sums": {
                          f"{k}_B{b}": v for (b, k), v in sums.items()}}))
    if bad:
        print("outside GN_BWD_TOL: " + "; ".join(bad), file=sys.stderr)
        return 1
    return 0


def load_old(root: str):
    """Build the kernel library of the checkout at ``root`` (in a child
    process, from that checkout's own ``ops/_build.py``) and return
    ``fn(x, gamma, beta, w, b) -> out`` on its kernel-5 entry."""
    import torch

    from .models.unet import _num_groups
    from .ops.unet_fused import EPS, _device_plan

    root = str(Path(root).resolve())
    res = subprocess.run(
        [sys.executable, "-c", "from climsim_tpu_torch.ops import _build; "
         "print(len(getattr(_build, '_SIGNATURES', {}).get("
         "'cst_fused_gn_silu_conv3', [()])[0])); print(_build.build())"],
        cwd=root, capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": root}, check=False)
    if res.returncode != 0:
        raise RuntimeError(f"building {root} failed:\n{res.stdout}"
                           f"{res.stderr}")
    n_args, path = res.stdout.strip().splitlines()[-2:]
    lib = ctypes.CDLL(path)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = lib.cst_fused_gn_silu_conv3
    # since the tile plan (17 arguments) the entry takes nwg, nt, stages
    # and samples after eps: the old checkout's plan is then this one's
    planned = int(n_args) == 17
    fn.argtypes = ([P] * 6 + [I] * 5 + [ctypes.c_float] + [I] * 4 * planned
                   + [P])
    fn.restype = I

    def run(x, gamma, beta, w, b):
        bsz, l, c = x.shape
        out = torch.empty(bsz, l, w.shape[2], device=x.device)
        tiles = ()
        if planned:
            p = _device_plan(bsz, l, c, w.shape[2], x.device)
            tiles = (p.nwg, p.nt, p.stages, p.samples)
        # the current stream: a CUDA graph captures the launch
        code = fn(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                  w.data_ptr(), b.data_ptr(), out.data_ptr(), bsz, l, c,
                  w.shape[2], _num_groups(c), EPS, *tiles,
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
    ap.add_argument("--backward", action="store_true",
                    help="5''s backward (fused_gn_silu_conv3_bwd) instead")
    ap.add_argument("--seeds", default="",
                    help="with --backward: the tolerance's readings first")
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
    if args.backward:
        return backward_main(args, torch, PU, card)
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
                out_old = old(*a)
                errs["old"] = float((out_old - want).abs().max()) / scale
                bit_equal = torch.equal(out_old, got)
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
                   **({"bit_equal_to_old": bit_equal} if old else {}),
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
                  + (f"  bit-equal to old: {bit_equal}" if old else "")
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
