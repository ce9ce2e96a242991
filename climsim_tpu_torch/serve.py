"""Serve a wrapped coupling emulator over the TCP bridge (online/server.py).

Three modes:

``--bundle DIR [--batch B]`` serves the program of bucket B (default 384)
of a ``package_e3sm`` bundle; a B the bundle did not export is refused,
with the buckets it has.  ``--aot PATH --features N --batch B`` serves one
program from ``online.wrapper.export_aot``.  A program has one fixed
batch: requests are padded or split to it.  It runs on the device it was
exported on, which ``--device`` must name.

``--demo`` builds an untrained model at its preset's full width from
``--seed``, for wire and latency testing of the bridge itself:

  * ``v2rh``: MLP_v2rh (557 -> 1024 x 4 -> 368) through the fast wrapper,
    the input-transform kernel then the fused-MLP kernel with bf16, int8
    or float32 weights;
  * ``v5``: the ``unet_v5`` U-Net (21,231,125 parameters) through the v5
    coupling wrapper on raw v4 columns (1525 wide): the input-transform
    kernel, the fused engine with its GroupNorm -> silu -> conv3 kernel,
    then the constraint-head kernel; ``--two-stage`` adds the
    ``unet_v5_classifier`` gate on the qn tendency (a second fused
    engine);
  * ``v4``: the ``unet_v4`` U-Net through the v4 wrapper on raw v4
    columns: the input-transform kernel with the qc/qi rates, then the
    fused engine.

Example:
  python -m climsim_tpu_torch.serve --demo v2rh --weights bf16 --port 9999
  python -m climsim_tpu_torch.serve --demo v5 --two-stage
  python -m climsim_tpu_torch.serve --bundle deploy/unet_v5 --batch 384
  # host side: send <III magic,rows,features> + f32 payload; read reply
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import threading
from functools import partial


def resolve_bundle(bundle_dir: str, batch: int) -> tuple:
    """The program of bucket ``batch`` in a ``package_e3sm`` bundle:
    (path, n_features, platform).  Raises ValueError, naming the buckets
    the bundle has, where it has none of ``batch`` rows: a bucket is never
    swapped for another."""
    with open(os.path.join(bundle_dir, "metadata.json")) as f:
        meta = json.load(f)
    names = {a["batch"]: n for n, a in meta["artifacts"].items()}
    if batch not in names:
        raise ValueError(f"bundle {bundle_dir} has no program for a batch "
                         f"of {batch}; its buckets are {sorted(names)}")
    return (os.path.join(bundle_dir, names[batch]), meta["n_features"],
            meta["platform"])


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--bundle", help="package_e3sm bundle directory")
    mode.add_argument("--aot", help="a program saved by export_aot")
    mode.add_argument("--demo", choices=["v2rh", "v5", "v4"])
    ap.add_argument("--features", type=int,
                    help="input width (required with --aot)")
    ap.add_argument("--two-stage", action="store_true",
                    help="v5: gate the qn tendency with the classifier")
    ap.add_argument("--hidden", default="1024,1024,1024,1024",
                    help="v2rh: comma-separated hidden widths")
    ap.add_argument("--weights", choices=["f32", "bf16", "int8"],
                    default="bf16", help="v2rh: weight type")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=384,
                    help="a program's batch; a demo's base chunk of the "
                    "bucket ladder")
    ap.add_argument("--max-batch", type=int, default=6144)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9876)
    args = ap.parse_args(argv)
    if args.aot and not args.features:
        ap.error("--features is required with --aot")
    if args.two_stage and args.demo != "v5":
        ap.error("--two-stage is for --demo v5")
    return args


def _demo(args):
    """(wrapper, n_features, description) of an untrained demo model."""
    import torch

    from .config import PRESETS
    from .models import build_model
    from .norms import load_asset_norms
    from .online import wrapper as W
    from .ops.unet_infer import unet_apply_fused
    from .varspec import get_varspec

    gen = torch.Generator().manual_seed(args.seed)
    if args.demo == "v2rh":
        spec = get_varspec("v2_rh")
        hidden = tuple(int(h) for h in args.hidden.split(","))
        model = build_model("mlp_online", spec, hidden=hidden, generator=gen)
        weights_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                         "int8": "int8"}[args.weights]
        wrap = W.make_fast_mlp_wrapper(model, load_asset_norms("v2_rh"), spec,
                                       weights_dtype, device=args.device,
                                       max_batch=args.max_batch)
        return wrap, spec.input_len, f"weights={args.weights}"

    def unet(preset, g):
        cfg = PRESETS[preset]
        model = build_model(cfg.model, get_varspec(cfg.data.varspec),
                            **cfg.model_kw, generator=g)
        return partial(unet_apply_fused, model.to(args.device).eval())

    spec4 = get_varspec("v4")
    if args.demo == "v4":
        wrap = W.make_v4_wrapper(unet("unet_v4", gen),
                                 load_asset_norms("v4"), spec4,
                                 device=args.device)
        return wrap, spec4.input_len, "unet_v4"
    stats5 = load_asset_norms("v5")
    apply = unet("unet_v5", gen)
    if args.two_stage:
        from .online.two_stage import make_two_stage_apply

        apply = make_two_stage_apply(
            apply, unet("unet_v5_classifier",
                        torch.Generator().manual_seed(args.seed + 1)),
            stats=stats5, device=args.device)
    wrap = W.make_wrapper(apply, stats5, W.WrapperConfig(input_version="v4"),
                          device=args.device)
    return wrap, spec4.input_len, ("unet_v5 two-stage" if args.two_stage
                                   else "unet_v5")


def make_server(args):
    """(CouplingServer, description) for parsed ``args``; the server is
    warmed (every bucket run once) and not yet started."""
    import torch

    from .online.server import CouplingServer

    if args.bundle or args.aot:
        from .online.wrapper import load_aot

        path, n_features = args.aot, args.features
        if args.bundle:
            path, n_features, platform = resolve_bundle(args.bundle,
                                                        args.batch)
            if platform != torch.device(args.device).type:
                raise ValueError(f"the bundle's programs run on {platform}, "
                                 f"not on {args.device}")
        # a program has one fixed batch: one bucket
        return (CouplingServer(load_aot(path), n_features,
                               base_chunk=args.batch, max_batch=args.batch,
                               host=args.host, port=args.port,
                               device=args.device),
                f"program {path}")
    wrap, n_features, what = _demo(args)
    return (CouplingServer(wrap, n_features, base_chunk=args.batch,
                           max_batch=args.max_batch, host=args.host,
                           port=args.port, device=args.device), what)


def main(argv=None):
    args = parse_args(argv)
    try:
        srv, what = make_server(args)
    except ValueError as e:
        raise SystemExit(f"serve: {e}") from None

    stop = threading.Event()
    # Event.wait wakes immediately on set() from the handler (a bare
    # time.sleep would resume for its full remainder per PEP 475)
    signal.signal(signal.SIGTERM, lambda signum, frame: stop.set())
    srv.start()
    print(f"serving on {args.host}:{srv.port} "
          f"(features={srv.n_features}, buckets={srv.buckets}, "
          f"{what}, device={args.device})", flush=True)
    try:
        while not stop.wait(10.0):
            s = srv.stats.summary()
            if s["requests"]:
                print(f"reqs={s['requests']} rows={s['rows']} "
                      f"rows/batch={s['rows_per_batch']:.0f} "
                      f"p50={s['latency_ms_p50']:.3f}ms "
                      f"p99={s['latency_ms_p99']:.3f}ms", flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


if __name__ == "__main__":
    main()
