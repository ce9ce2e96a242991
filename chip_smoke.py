#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (climsim_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py [--seed N]

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from climsim_tpu_torch/ops/csrc (nvcc, sm_90a)
   and prints the build time and the compiler's register/spill report.
3. Checks each kernel against its plain PyTorch version on the card, at
   the shapes the serving path gives it (B = 1, 7, 384, 6144; the v2_rh
   width 557 and the v5 width 1405 for the input transform; the full
   557 -> 1024 x 4 -> 368 MLP_v2rh for the fused MLPs), and times both
   with CUDA events at B = 384 and 6144.
4. Serves the full-width MLP_v2rh (random weights from --seed, in the flax
   layout, moved across by the weight porter) through the port's
   CouplingServer, bf16 and then int8 weights: three concurrent 384-column
   chunks, one ragged 50-row request, then N_LOOP sequential requests.
   Every reply must equal the direct wrapper call on the card, match the
   plain path (the same wrapper on the CPU) within tolerance, and the
   launch counts of all three kernels must have risen in that run.
5. With --profile, times the fused MLPs at both tile heights and traces
   the served path with torch.profiler (device time per kernel and copy,
   the card's busy share, the costliest host ops).
6. Prints one JSON line of the kernels' results, then, last,
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Nothing is caught: any failure exits non-zero and prints no result.
Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time

import numpy as np

FULL_HIDDEN = (1024, 1024, 1024, 1024)
KERNEL_ROWS = (1, 7, 384, 6144)
TIMED_ROWS = (384, 6144)
N_LOOP = 1000   # sequential requests a weight type: p99 has 10 beyond it
N_TRACE = 100   # served requests a weight type under --profile
# Tolerances (rtol, atol) of the JAX package's tests for the same
# functions (tests/test_pallas_kernels.py:28, :88).
TOL = {"fused_input_transform": (1e-5, 1e-7),
       "fused_mlp_forward": (2e-4, 1e-4)}
# The int8 kernel rounds every activation to bf16 before its product.
# Where its float32 sum differs in the last bits from the plain version's
# (cuBLAS sums in another order), a rounding can flip by 2**-8 relative
# and carry through the later layers.  On an H100 that left 0 to 11% of
# the whole network's output elements outside TOL["fused_mlp_forward"]
# (one flipped row of seven is 11%), against 89-93% for float32
# activations in place of the rounding.  So the int8 kernel is checked
# link by link instead (int8_chain): every prefix of the network through
# the kernel, each layer against the plain version of that layer alone,
# fed the kernel's own output of the layers before it.  Both sides round
# the same float32 values to bf16, nothing can flip, and no element may
# fall outside the tolerance.  A control runs the same chain with float32
# activations and must fail it.
SOURCES = {
    "fused_input_transform": (
        "climsim_tpu_torch/ops/csrc/fused_input_transform.cu",
        "climsim_tpu/ops/kernels.py:64"),
    "fused_mlp_forward": ("climsim_tpu_torch/ops/csrc/fused_mlp_forward.cu",
                          "climsim_tpu/ops/kernels.py:228"),
    "fused_mlp_forward_int8": (
        "climsim_tpu_torch/ops/csrc/fused_mlp_forward_int8.cu",
        "climsim_tpu/ops/kernels.py:331"),
}


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip()


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(3):
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


def compare_timed(torch, kernel, plain, iters):
    """(kernel ms, plain ms), measured in turns: plain, kernel, kernel,
    plain; each the mean of its two turns."""
    p1 = time_ms(torch, plain, iters)
    k1 = time_ms(torch, kernel, iters)
    k2 = time_ms(torch, kernel, iters)
    p2 = time_ms(torch, plain, iters)
    return (k1 + k2) / 2, (p1 + p2) / 2


def errors(got, want):
    d = (got.double() - want.double()).abs()
    rel = d / want.double().abs().clamp_min(1e-30)
    return float(d.max()), float(rel.max())


def outside(got, want, rtol, atol):
    """Share of the elements of ``got`` outside rtol/atol of ``want``."""
    return float(((got - want).abs() > atol + rtol * want.abs()).double()
                 .mean())


def check_close(torch, name, got, want, rtol, atol):
    """Require got == want within rtol/atol.  Returns (max abs, max rel)
    err."""
    require(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} "
            f"!= {tuple(want.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    share = outside(got, want, rtol, atol)
    require(share == 0, f"{name}: {share:.3%} of the elements outside "
            f"rtol={rtol} atol={atol}; max abs err {errors(got, want)[0]:.3e}")
    return errors(got, want)


def int8_chain(torch, K, x, mlp, run):
    """Run ``run(x, net, relu_tail)`` on every prefix ``net`` of the int8
    network ``mlp`` and hold its output against the plain version of the
    prefix's last layer alone, fed ``run``'s output of the prefix before
    it.  Returns (the largest share of elements outside
    TOL["fused_mlp_forward"] at any link, max abs err)."""
    layers = list(mlp.layers())
    h, worst, err = x, 0.0, 0.0
    n_w = n_b = 0
    for i, (q, b, s) in enumerate(layers):
        n_w, n_b = n_w + q.numel(), n_b + b.numel()
        # a last layer's relu_tail that covers every output is the relu
        # between layers
        tail = 8 if i == len(layers) - 1 else q.shape[1]
        got = run(x, K.PackedMLP(mlp.widths[:i + 2], mlp.w[:n_w],
                                 mlp.b[:n_b], mlp.scale[:n_b]), tail)
        want = K.fused_mlp_forward_int8_plain(
            h, K.PackedMLP(tuple(q.shape), q.reshape(-1), b, s), tail)
        require(bool(torch.isfinite(got).all()), "non-finite output")
        worst = max(worst, outside(got, want, *TOL["fused_mlp_forward"]))
        err = max(err, errors(got, want)[0])
        h = got
    return worst, err


def check_int8(torch, K, name, x, mlp):
    """The int8 kernel on ``x`` through int8_chain, with its control.
    Returns the chain's max abs err, and that of the whole network against
    the plain version, which flips may put outside the tolerance."""
    share, chain_err = int8_chain(torch, K, x, mlp, K.fused_mlp_forward_int8)
    deq = [(q.float() * s).numpy(force=True) for q, _, s in mlp.layers()]
    f32 = K.pack_mlp(deq, [b for _, b, _ in mlp.layers()], torch.float32,
                     x.device)

    def float32_activations(h, net, relu_tail):
        return K.fused_mlp_forward_plain(
            h, K.PackedMLP(net.widths, f32.w[:net.w.numel()], net.b),
            relu_tail)

    control, _ = int8_chain(torch, K, x, mlp, float32_activations)
    got = K.fused_mlp_forward_int8(x, mlp, 8)
    want = K.fused_mlp_forward_int8_plain(x, mlp, 8)
    print(f"  {name}: B={x.shape[0]} link by link max_abs_err="
          f"{chain_err:.3e}, {share:.4%} outside (control: {control:.4%}); "
          f"whole network {outside(got, want, *TOL['fused_mlp_forward']):.4%}"
          f" outside, max_abs_err={errors(got, want)[0]:.3e}", flush=True)
    require(share == 0, f"{name}: {share:.4%} of the elements outside "
            f"{TOL['fused_mlp_forward']} at a link of the chain")
    require(control > 0, f"{name}: float32 activations pass the chain too")
    return chain_err, errors(got, want)[0]


def flax_tree(spec, hidden, seed):
    """A flax-layout OnlineMLP parameter tree of numpy arrays: lecun-normal
    kernels (unit normal truncated to +/-2, std sqrt(1/fan_in)), small
    random biases."""
    rng = np.random.default_rng(seed)
    widths = (spec.input_len, *hidden, spec.output_len)

    def dense(din, dout):
        z = rng.standard_normal((din, dout))
        bad = np.abs(z) > 2
        while bad.any():
            z[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(z) > 2
        std = np.sqrt(1.0 / din) / 0.87962566103423978
        return {"kernel": (z * std).astype(np.float32),
                "bias": (0.01 * rng.standard_normal(dout)).astype(np.float32)}

    pairs = list(zip(widths[:-1], widths[1:]))
    return {"MLPTrunk_0": {f"Dense_{i}": dense(*p)
                           for i, p in enumerate(pairs[:-1])},
            "out": dense(*pairs[-1])}


def with_nonfinite(x):
    x = x.copy()
    x[0, 3] = np.nan
    if x.shape[0] > 2:
        x[1, 9] = np.inf
        x[2, 130] = -np.inf
    return x


def kernel_checks(torch, K, T, spec, stats, spec5, stats5, model, columns):
    """Each kernel against its plain version on the card; returns
    {name: {"max_abs_err", "ms": {B: ms}, "plain_ms": {B: ms}}}, and for
    the int8 kernel "whole_network_max_abs_err" (see int8_chain)."""
    dev = torch.device("cuda")
    res = {n: {"max_abs_err": 0.0, "ms": {}, "plain_ms": {}}
           for n in SOURCES}

    def record(name, b, err):
        r = res[name]
        r["max_abs_err"] = max(r["max_abs_err"], err[0])
        print(f"  {name:24s} B={b:5d} max_abs_err={err[0]:.3e} "
              f"max_rel_err={err[1]:.3e}", flush=True)

    # -- kernel 1: the v2_rh serving config and the v5 online config -----
    v2_consts = T.input_transform_consts(
        spec, stats, T.TransformConfig(input_clip=True,
                                       input_clip_rhonly=True), dev)
    v5_consts = T.input_transform_consts(
        spec5, stats5, T.v5_online_config(), dev)
    for label, consts, cols in (("v2_rh", v2_consts, columns["v2_rh"]),
                                ("v5", v5_consts, columns["v5"])):
        for b in KERNEL_ROWS:
            x = torch.from_numpy(with_nonfinite(cols[:b])).to(dev)
            got = K.fused_input_transform(x, consts)
            want = K.fused_input_transform_plain(x, consts)
            err = check_close(torch, f"transform {label}", got, want,
                              *TOL["fused_input_transform"])
            record("fused_input_transform", b, err)
    for b in TIMED_ROWS:
        x = torch.from_numpy(columns["v2_rh"][:b]).to(dev)
        k, p = compare_timed(
            torch, lambda: K.fused_input_transform(x, v2_consts),
            lambda: K.fused_input_transform_plain(x, v2_consts), 200)
        res["fused_input_transform"]["ms"][b] = k
        res["fused_input_transform"]["plain_ms"][b] = p

    # -- kernels 2 and 3: the full-width MLP on normalized columns --------
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    packed = {w: K.pack_mlp(ws, bs, dt, dev) for w, dt in (
        ("bf16", torch.bfloat16), ("f32", torch.float32), ("int8", "int8"))}
    xn = K.fused_input_transform_plain(
        torch.from_numpy(columns["v2_rh"]).to(dev), v2_consts)
    for b in KERNEL_ROWS:
        x = xn[:b].contiguous()
        for w in ("bf16", "f32"):
            got = K.fused_mlp_forward(x, packed[w], 8)
            want = K.fused_mlp_forward_plain(x, packed[w], 8)
            err = check_close(torch, f"fused_mlp_forward[{w}]", got, want,
                              *TOL["fused_mlp_forward"])
            if w == "bf16":
                record("fused_mlp_forward", b, err)
        r = res["fused_mlp_forward_int8"]
        chain_err, whole_err = check_int8(
            torch, K, "fused_mlp_forward_int8", x, packed["int8"])
        r["max_abs_err"] = max(r["max_abs_err"], chain_err)
        r["whole_network_max_abs_err"] = max(
            r.get("whole_network_max_abs_err", 0.0), whole_err)
        # weight-only int8 stays within quantization error of float32
        got = K.fused_mlp_forward_int8(x, packed["int8"], 8)
        f32 = K.fused_mlp_forward_plain(x, packed["f32"], 8)
        q_err = float(((got - f32).abs() / (f32.abs().mean() + 1e-6)).mean())
        require(q_err < 0.02, f"int8 vs f32 mean error {q_err:.4f}")
    # widths that are not multiples of 4 take the kernels' unaligned,
    # guarded weight loads (the coupling MLP never does)
    rng = np.random.default_rng(1)
    ragged = (spec.input_len, 97, 64, 30, spec.output_len)
    rw = [rng.standard_normal((i, o)).astype(np.float32) / np.sqrt(i)
          for i, o in zip(ragged[:-1], ragged[1:])]
    rb = [(0.1 * rng.standard_normal(o)).astype(np.float32)
          for o in ragged[1:]]
    for b in (7, 384):
        x = xn[:b].contiguous()
        for dt in (torch.float32, torch.bfloat16):
            p = K.pack_mlp(rw, rb, dt, dev)
            check_close(torch, f"fused_mlp_forward[ragged {dt}]",
                        K.fused_mlp_forward(x, p, 8),
                        K.fused_mlp_forward_plain(x, p, 8),
                        *TOL["fused_mlp_forward"])
        p = K.pack_mlp(rw, rb, "int8", dev)
        check_int8(torch, K, "fused_mlp_forward_int8[ragged]", x, p)
    print(f"  ragged widths {ragged}: bf16, f32, int8 match", flush=True)
    for b in TIMED_ROWS:
        x = xn[:b].contiguous()
        for name, kern, plain, p in (
                ("fused_mlp_forward", K.fused_mlp_forward,
                 K.fused_mlp_forward_plain, packed["bf16"]),
                ("fused_mlp_forward_int8", K.fused_mlp_forward_int8,
                 K.fused_mlp_forward_int8_plain, packed["int8"])):
            k, pl = compare_timed(torch, lambda: kern(x, p, 8),
                                  lambda: plain(x, p, 8), 20)
            res[name]["ms"][b] = k
            res[name]["plain_ms"][b] = pl
    for name, r in res.items():
        for b in TIMED_ROWS:
            print(f"  {name:24s} B={b:5d} kernel {r['ms'][b]:.4f} ms  "
                  f"plain {r['plain_ms'][b]:.4f} ms", flush=True)
    return res


def profile(torch, K, T, model, stats, spec, cols, chunk):
    """--profile: each fused MLP at every tile height (the choice in
    kernels._tile_rows), then a torch.profiler trace of N_TRACE sequential
    served 384-column requests a weight type: device time per kernel and
    copy, the card's busy share of the traced wall time, and the host ops
    that take longest."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper

    dev = torch.device("cuda")
    consts = T.input_transform_consts(
        spec, stats, T.TransformConfig(input_clip=True,
                                       input_clip_rhonly=True), dev)
    xn = K.fused_input_transform_plain(torch.from_numpy(cols).to(dev), consts)
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    weights = (("bf16", torch.bfloat16, "fused_mlp_forward_bf16"),
               ("int8", "int8", "fused_mlp_forward_int8"))
    print("profile: fused MLP at each tile height", flush=True)
    for w, dt, entry in weights:
        p = K.pack_mlp(ws, bs, dt, dev)
        for b in (384, 1536, 6144):
            x = xn[:b].contiguous()
            ms = {tb: time_ms(torch, lambda: K._launch_mlp(entry, x, p, 8, tb),
                              20) for tb in K.TILE_ROWS}
            print(f"  {w} B={b:5d} " + " ".join(
                f"TB={tb} {t:.4f} ms" for tb, t in ms.items())
                + f" (picked: TB={K._tile_rows(b, dev)})", flush=True)
    for w, dt, _ in weights:
        wrap = make_fast_mlp_wrapper(model, stats, spec, dt, device="cuda")
        srv = CouplingServer(wrap, spec.input_len, base_chunk=384,
                             max_batch=6144, device="cuda").start()
        try:
            cl = CouplingClient("127.0.0.1", srv.port)
            for _ in range(20):
                cl.step(chunk)
            with trace(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(N_TRACE):
                    cl.step(chunk)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
            cl.close()
        finally:
            srv.stop()
        ops = prof.key_averages()
        dev_ops = [e for e in ops if e.self_device_time_total > 0]
        busy_ms = sum(e.self_device_time_total for e in dev_ops) / 1e3
        print(f"profile: served {w}, {N_TRACE} requests in {wall_ms:.1f} ms; "
              f"card busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%})",
              flush=True)
        for e in sorted(dev_ops, key=lambda e: -e.self_device_time_total)[:6]:
            print(f"  device {e.self_device_time_total / N_TRACE:9.2f} "
                  f"us/request {e.count:5d} x {e.key[:80]}")
        for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:6]:
            print(f"  host   {e.self_cpu_time_total / N_TRACE:9.2f} "
                  f"us/request {e.count:5d} x {e.key[:80]}")


def drive(CouplingClient, srv, chunks, ragged, n_loop):
    """The main path: concurrent chunks, a ragged request, a latency loop.
    Returns (replies, client round-trip ms list)."""
    replies = [None] * len(chunks)

    def call(i):
        cl = CouplingClient("127.0.0.1", srv.port)
        replies[i] = cl.step(chunks[i])
        cl.close()

    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(chunks))]
    for t in threads:
        t.start()
    cl = CouplingClient("127.0.0.1", srv.port)
    replies.append(cl.step(ragged))
    for t in threads:
        t.join(timeout=120)
        require(not t.is_alive(), "a client thread did not finish")
    lat = []
    for i in range(n_loop):
        t0 = time.perf_counter()
        cl.step(chunks[i % len(chunks)])
        lat.append((time.perf_counter() - t0) * 1e3)
    cl.close()
    return replies, lat


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="then time the fused MLPs at both tile heights and "
                    "trace the served path with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1

    from climsim_tpu_torch import (get_varspec, load_asset_norms,
                                   load_default_grid)
    from climsim_tpu_torch.data import transforms as T
    from climsim_tpu_torch.data.synthetic import synthetic_inputs
    from climsim_tpu_torch.models import OnlineMLP
    from climsim_tpu_torch.online.server import (CouplingClient,
                                                 CouplingServer)
    from climsim_tpu_torch.online.wrapper import make_fast_mlp_wrapper
    from climsim_tpu_torch.ops import _build
    from climsim_tpu_torch.ops import kernels as K
    from climsim_tpu_torch.utils.migrate import port_flax_online_mlp

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    require(not torch.backends.cuda.matmul.allow_tf32,
            "float32 products must not run in TF32")

    t0 = time.perf_counter()
    _build.load()
    print(f"kernel build+load: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().parent.name})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())

    spec, stats = get_varspec("v2_rh"), load_asset_norms("v2_rh")
    spec5, stats5 = get_varspec("v5"), load_asset_norms("v5")
    grid = load_default_grid()
    columns = {"v2_rh": synthetic_inputs(spec, max(KERNEL_ROWS), grid,
                                         seed=args.seed),
               "v5": synthetic_inputs(spec5, max(KERNEL_ROWS), grid,
                                      seed=args.seed + 1)}
    model = OnlineMLP(spec, hidden=FULL_HIDDEN)
    model.load_state_dict(port_flax_online_mlp(
        flax_tree(spec, FULL_HIDDEN, args.seed)))
    n_params = sum(p.numel() for p in model.parameters())
    print(f"MLP_v2rh {spec.input_len} -> {'x'.join(map(str, FULL_HIDDEN))} "
          f"-> {spec.output_len}: {n_params} parameters", flush=True)

    print("kernel vs plain on the card:", flush=True)
    res = kernel_checks(torch, K, T, spec, stats, spec5, stats5, model,
                        columns)

    # -- the slice: the port's sidecar serving the full-width MLP --------
    chunks = [synthetic_inputs(spec, 384, grid, seed=args.seed + 10 + i)
              for i in range(3)]
    ragged = synthetic_inputs(spec, 50, grid, seed=args.seed + 20)
    servers, plain = {}, {}
    for w, dt in (("bf16", torch.bfloat16), ("int8", "int8")):
        wrap = make_fast_mlp_wrapper(model, stats, spec, dt, device="cuda")
        servers[w] = (wrap, CouplingServer(
            wrap, spec.input_len, base_chunk=384, max_batch=6144,
            device="cuda").start())
        plain[w] = make_fast_mlp_wrapper(model, stats, spec, dt,
                                         device="cpu")
    try:
        K.reset_launches()
        driven = {w: drive(CouplingClient, srv, chunks, ragged, N_LOOP)
                  for w, (_, srv) in servers.items()}
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        summaries = {w: srv.stats.summary() for w, (_, srv) in servers.items()}
    finally:
        for _, srv in servers.values():
            srv.stop()
    print(f"launches in the served run: {launches}", flush=True)
    for name, n in launches.items():
        require(n > 0, f"{name} was not launched by the served path")

    # Replies are compared in normalized units (times out_scale): raw
    # tendencies span 1e-8 (water) to 1e2 (fluxes), beyond any one atol.
    # The int8 replies are held to the plain path link by link (int8_chain)
    # on their own normalized columns, and to the kernel's output there.
    scale = torch.as_tensor(stats.out_scale, dtype=torch.float32)
    consts = T.input_transform_consts(spec, stats, T.TransformConfig(
        input_clip=True, input_clip_rhonly=True), "cuda")
    int8_mlp = K.pack_mlp(*K.mlp_params_to_matrices(model.state_dict()),
                          "int8", "cuda")
    for w, (replies, lat) in driven.items():
        wrap, served_outside = servers[w][0], 0.0
        for x, y in zip(chunks + [ragged], replies):
            require(y.shape == (x.shape[0], spec.output_len),
                    f"reply shape {y.shape}")
            require(bool(np.isfinite(y).all()), "non-finite reply")
            with torch.inference_mode():
                direct = wrap(torch.from_numpy(x).cuda()).cpu().numpy()
                ref = plain[w](torch.from_numpy(x)) * scale
            require(np.array_equal(y, direct),
                    f"{w}: served reply differs from the direct call")
            y = torch.from_numpy(y.copy()) * scale
            if w == "bf16":
                check_close(torch, "served[bf16] vs plain", y, ref,
                            *TOL["fused_mlp_forward"])
            else:
                xn = K.fused_input_transform_plain(
                    torch.from_numpy(x).cuda(), consts)
                check_int8(torch, K, "served[int8] columns", xn, int8_mlp)
                check_close(torch, "served[int8] vs kernel", y,
                            K.fused_mlp_forward_int8(xn, int8_mlp, 8).cpu(),
                            *TOL["fused_mlp_forward"])
            served_outside = max(served_outside, outside(
                y, ref, *TOL["fused_mlp_forward"]))
        s = summaries[w]
        lat = np.asarray(lat)
        print(f"served {w}: {s['requests']} requests, {s['batches']} "
              f"device calls, device call p50 {s['latency_ms_p50']:.3f} ms "
              f"p99 {s['latency_ms_p99']:.3f} ms; 384-column round trip "
              f"p50 {np.percentile(lat, 50):.3f} ms "
              f"p99 {np.percentile(lat, 99):.3f} ms; replies against the "
              f"plain path: {served_outside:.4%} of the elements outside",
              flush=True)

    if args.profile:
        profile(torch, K, T, model, stats, spec, columns["v2_rh"], chunks[0])
    require("jax" not in sys.modules, "the port must not load jax")
    kernels = []
    for name, (source, replaces) in SOURCES.items():
        r = res[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"],
            **{k: r[k] for k in ("whole_network_max_abs_err",) if k in r},
            "ms": r["ms"][384], "plain_ms": r["plain_ms"][384],
            "ms_b6144": r["ms"][6144], "plain_ms_b6144": r["plain_ms"][6144],
        })
    print(json.dumps({"kernels": kernels, "card": card}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
