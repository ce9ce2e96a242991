"""Benchmark: the coupling sidecar against direct in-process calls.

The counterpart of ``scripts/bench_server.py``.  For each served path, at
the E3SM chunk of B = 384 columns:

  1. the direct wrapper call (host columns -> the card -> host tendencies,
     what ``CouplingServer`` runs a device call);
  2. a ``torch.export`` program of the path (``online.wrapper.export_aot``
     / ``load_aot``, the deployable unit ``package_e3sm`` ships), which
     reaches kernels 1, 4 and 5 through ``torch.library`` operators,
     beside the live wrapper it was exported from.  For the U-Net paths
     that is the served wrapper itself.  Kernels 2 and 3 have no operator,
     so a program cannot hold the MLPs' fast wrapper: the MLP paths'
     program is the MLP_v2rh as ``package_e3sm`` bundles it
     (``make_v2rh_wrapper``: kernel 1, then the model's torch products);
  3. the served round trip over ``CouplingServer`` with 1 client, and
  4. with 8 concurrent clients (micro-batching coalesces their chunks),
     each client sending its own chunk ``--requests`` times.

Each time is given as its median, p90 and p99 over the calls, with the
served legs' columns/s, rows a device call, pad fraction and device-call
times (``ServerStats``).  The paths are those ``chip_smoke.py`` serves:
``mlp_bf16`` and ``mlp_int8`` (MLP_v2rh 557 -> 1024 x 4 -> 368 through
the fast wrapper), ``unet_v5`` (the unet_v5 preset through the v5 wrapper
on raw v4 columns) and ``two_stage_v5`` (that U-Net gated by the
unet_v5_classifier).  Weights are random, from ``SEED``.  Prints one
JSON line a path.

  python -m climsim_tpu_torch.bench_server [--path mlp_bf16 ...]
      [--clients 1,8] [--requests N] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

PATHS = ("mlp_bf16", "mlp_int8", "unet_v5", "two_stage_v5")
BATCH = 384
CLIENTS = (1, 8)
# requests a client: fewer for the U-Net paths, whose device calls take
# tens of times the MLPs' (PERF.md)
REQUESTS = {"mlp_bf16": 200, "mlp_int8": 200, "unet_v5": 50,
            "two_stage_v5": 50}
REPS = 30          # direct and program calls
MAX_BATCH = 6144
SEED = 0


def build_path(name: str, device="cuda", seed: int = 0,
               hidden=(1024,) * 4, overrides: tuple = ()):
    """(served wrapper, the wrapper a program is exported from, input
    VarSpec) of a served path; ``overrides`` ('a.b=c') apply to both U-Net
    presets."""
    import torch

    from .config import PRESETS
    from .models import build_model
    from .norms import load_asset_norms
    from .online import wrapper as W
    from .ops.unet_infer import unet_apply_fused
    from .varspec import get_varspec

    gen = torch.Generator().manual_seed(seed)
    if name.startswith("mlp_"):
        spec = get_varspec("v2_rh")
        model = build_model("mlp_online", spec, hidden=tuple(hidden),
                            generator=gen)
        stats = load_asset_norms("v2_rh")
        weights = {"mlp_bf16": torch.bfloat16, "mlp_int8": "int8"}[name]
        fast = W.make_fast_mlp_wrapper(model, stats, spec, weights,
                                       device=device, max_batch=MAX_BATCH)
        return fast, W.make_v2rh_wrapper(model.to(device).eval(), stats,
                                         spec, device=device), spec

    def unet(preset, g):
        cfg = PRESETS[preset].override(*overrides)
        model = build_model(cfg.model, get_varspec(cfg.data.varspec),
                            **cfg.model_kw, generator=g)
        return partial(unet_apply_fused, model.to(device).eval())

    stats5 = load_asset_norms("v5")
    apply = unet("unet_v5", gen)
    if name == "two_stage_v5":
        from .online.two_stage import make_two_stage_apply

        apply = make_two_stage_apply(
            apply, unet("unet_v5_classifier",
                        torch.Generator().manual_seed(seed + 1)),
            stats=stats5, device=device)
    elif name != "unet_v5":
        raise ValueError(f"unknown path {name!r}; the paths are {PATHS}")
    wrap = W.make_wrapper(apply, stats5, W.WrapperConfig(input_version="v4"),
                          device=device)
    return wrap, wrap, get_varspec("v4")


def percentiles(ms) -> dict:
    a = np.asarray(ms, np.float64)
    return {"p50": float(np.percentile(a, 50)),
            "p90": float(np.percentile(a, 90)),
            "p99": float(np.percentile(a, 99)), "n": int(a.size)}


def call_ms(fn, x: np.ndarray, device, reps: int = REPS) -> dict:
    """Host-clock times of ``fn`` on host columns ``x`` moved to
    ``device``, the reply copied back (a server's device call), after two
    warm calls."""
    import torch

    t = []
    with torch.inference_mode():
        for i in range(reps + 2):
            t0 = time.perf_counter()
            fn(torch.from_numpy(x).to(device)).cpu()
            if i >= 2:
                t.append((time.perf_counter() - t0) * 1e3)
    return percentiles(t)


def served(srv, chunks, clients: int, requests: int) -> dict:
    """``clients`` concurrent clients (closed loop), client i sending
    ``chunks[i % len(chunks)]`` ``requests`` times after one warm request;
    each request's round trip, and the server's counts over the run."""
    from .online.server import CouplingClient

    start = threading.Barrier(clients + 1, timeout=600)

    def client(i):
        c = CouplingClient("127.0.0.1", srv.port)
        try:
            x = chunks[i % len(chunks)]
            c.step(x)
            start.wait()
            lat = []
            for _ in range(requests):
                t0 = time.perf_counter()
                y = c.step(x)
                lat.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(y).all():
                raise RuntimeError("non-finite reply")
            return lat
        finally:
            c.close()

    with ThreadPoolExecutor(clients) as pool:
        futs = [pool.submit(client, i) for i in range(clients)]
        start.wait()
        s = srv.stats
        b0, r0, p0, n0 = s.batches, s.rows, s.padded_rows, len(
            s.latencies_ms)
        t0 = time.perf_counter()
        lat = [t for f in futs for t in f.result()]
        wall = time.perf_counter() - t0
    calls = s.batches - b0
    rows = s.rows - r0
    padded = s.padded_rows - p0
    cols = clients * requests * chunks[0].shape[0]
    return {"round_trip_ms": percentiles(lat),
            "columns_per_s": cols / wall, "device_calls": calls,
            "requests": clients * requests,
            "rows_per_call": rows / max(calls, 1),
            "pad_fraction": padded / max(rows + padded, 1),
            "device_call_ms": percentiles(s.latencies_ms[n0:] or [0.0])}


def measure(wrap, n_features: int, chunks, program=None, live=None,
            clients=CLIENTS, requests: int = 200, reps: int = REPS,
            device="cuda") -> dict:
    """The direct call; where ``program`` is given, its call beside the
    call of ``live``, the wrapper it was exported from (``wrap`` where
    None); and the served legs at each count of ``clients``; on
    ``chunks`` (host (384, n_features) float32 arrays, one a client)."""
    import torch

    from .online.server import CouplingServer

    dev = torch.device(device)
    out = {"batch": chunks[0].shape[0],
           "direct_ms": call_ms(wrap, chunks[0], dev, reps)}
    if program is not None:
        out["program_ms"] = call_ms(program, chunks[0], dev, reps)
        out["program_live_ms"] = (out["direct_ms"] if live is None else
                                  call_ms(live, chunks[0], dev, reps))
        out["program_minus_live_p50_ms"] = (
            out["program_ms"]["p50"] - out["program_live_ms"]["p50"])
    srv = CouplingServer(wrap, n_features, base_chunk=chunks[0].shape[0],
                         max_batch=MAX_BATCH, device=dev).start()
    try:
        out["served"] = {str(c): served(srv, chunks, c, requests)
                         for c in clients}
    finally:
        srv.stop()
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--path", action="append", choices=PATHS,
                    help="a served path (repeatable); default all four")
    ap.add_argument("--clients", default=",".join(map(str, CLIENTS)))
    ap.add_argument("--requests", type=int,
                    help="requests a client (default 200 for the MLPs, "
                    "50 for the U-Nets)")
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--hidden", default="1024,1024,1024,1024",
                    help="the MLP's hidden widths")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="a.b=c override of both U-Net presets")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from .data.synthetic import synthetic_inputs
    from .grid import load_default_grid
    from .online.wrapper import export_aot, load_aot

    dev = torch.device(args.device)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    clients = tuple(int(c) for c in args.clients.split(","))
    hidden = tuple(int(h) for h in args.hidden.split(","))
    grid = load_default_grid()
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for path in args.path or PATHS:
            wrap, live, spec = build_path(path, dev, SEED, hidden,
                                          tuple(args.overrides))
            chunks = [synthetic_inputs(spec, BATCH, grid,
                                       seed=SEED + 10 + i)
                      for i in range(max(clients))]
            t0 = time.perf_counter()
            pt2 = os.path.join(tmp, f"{path}.pt2")
            export_aot(live, BATCH, spec.input_len, pt2, device=dev)
            export_s = time.perf_counter() - t0
            res = measure(wrap, spec.input_len, chunks, load_aot(pt2),
                          None if live is wrap else live, clients,
                          args.requests or REQUESTS[path], args.reps, dev)
            line = {"bench": "server", "path": path, "device": name,
                    "export_s": export_s, **res}
            print(json.dumps(line), flush=True)
            lines.append(line)
    return lines


if __name__ == "__main__":
    main()
