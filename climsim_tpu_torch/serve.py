"""Serve a wrapped coupling emulator over the TCP bridge (online/server.py).

``--demo v2rh`` builds an untrained MLP_v2rh at the ``mlp_v2rh`` preset's
full width (557 -> 1024 x 4 -> 368) from ``--seed`` and serves it through
the fast wrapper: the input-transform kernel, then the fused-MLP kernel
with bf16, int8 or float32 weights.

``--demo v5`` builds an untrained U-Net at the ``unet_v5`` preset's full
width (21,231,125 parameters) from ``--seed`` and serves it through the
v5 coupling wrapper on raw v4 columns (1525 wide): the input-transform
kernel, the fused engine with its GroupNorm -> silu -> conv3 kernel, then
the constraint-head kernel.  Both are for wire and latency testing of the
bridge itself.

Example:
  python -m climsim_tpu_torch.serve --demo v2rh --weights bf16 --port 9999
  python -m climsim_tpu_torch.serve --demo v5
  # host side: send <III magic,rows,features> + f32 payload; read reply
"""

from __future__ import annotations

import argparse
import signal
import threading
from functools import partial

# The unet_v5 preset's model (climsim_tpu/config.py:156-160).
UNET_V5 = dict(model_channels=128, channel_mult=(1, 2, 2, 2), num_blocks=4,
               attn_resolutions=(8,), output_prune=True, strato_lev_out=15)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--demo", choices=["v2rh", "v5"], required=True)
    ap.add_argument("--hidden", default="1024,1024,1024,1024",
                    help="v2rh: comma-separated hidden widths")
    ap.add_argument("--weights", choices=["f32", "bf16", "int8"],
                    default="bf16", help="v2rh: weight type")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=384,
                    help="base chunk of the bucket ladder")
    ap.add_argument("--max-batch", type=int, default=6144)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=9876)
    args = ap.parse_args(argv)

    import torch

    from .models import build_model
    from .norms import load_asset_norms
    from .online.server import CouplingServer
    from .online.wrapper import (WrapperConfig, make_fast_mlp_wrapper,
                                 make_wrapper)
    from .ops.unet_infer import unet_apply_fused
    from .varspec import get_varspec

    gen = torch.Generator().manual_seed(args.seed)
    if args.demo == "v2rh":
        spec = get_varspec("v2_rh")
        hidden = tuple(int(h) for h in args.hidden.split(","))
        model = build_model("mlp_online", spec, hidden=hidden, generator=gen)
        weights_dtype = {"f32": torch.float32, "bf16": torch.bfloat16,
                         "int8": "int8"}[args.weights]
        wrap = make_fast_mlp_wrapper(model, load_asset_norms("v2_rh"), spec,
                                     weights_dtype, device=args.device)
        n_features, what = spec.input_len, f"weights={args.weights}"
    else:
        model = build_model("unet", get_varspec("v5"), **UNET_V5,
                            generator=gen).to(args.device).eval()
        wrap = make_wrapper(partial(unet_apply_fused, model),
                            load_asset_norms("v5"),
                            WrapperConfig(input_version="v4"),
                            device=args.device)
        n_features, what = get_varspec("v4").input_len, "unet_v5"
    srv = CouplingServer(wrap, n_features, base_chunk=args.batch,
                         max_batch=args.max_batch, host=args.host,
                         port=args.port, device=args.device)

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
