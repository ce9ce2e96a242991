"""Package a trained coupling model into a bundle a host model deploys.

The port's entry for ``scripts/package_e3sm.py``: one command from a
checkpoint to the directory a host-model integration consumes.  The
reference saves a TorchScript wrapper and comma-separated normalization
txt files for the E3SM-MMF bridge (v5_nn_wrapper.ipynb ``save_wrapper``;
data_utils.py:973-987); here the wrapper is a ``torch.export`` program:

    python -m climsim_tpu_torch.package_e3sm --preset unet_v5 \\
        --ckpt ckpt.pt --cls-ckpt cls.pt --buckets 384,1536 \\
        --out deploy/unet_v5 --verify

writes to --out:
    wrapper_b{B}.pt2   a program a batch bucket (weights embedded; runs
                       without the model source, through
                       climsim_tpu_torch.online.wrapper.load_aot)
    inp_sub.txt inp_div.txt out_scale.txt [lbd_qn.txt]
                       the coupling contract's normalization vectors
    metadata.json      the contract, sha256 and bytes of every file

Serve a bucket with the TCP sidecar:
    python -m climsim_tpu_torch.serve --bundle deploy/unet_v5 --batch 384

Presets: ``unet_v5`` (raw v4 columns in; ``--cls-ckpt`` adds the
``unet_v5_classifier`` gate of the two-stage scheme), ``unet_v4`` and
``mlp_v2rh``.  A checkpoint is a ``train.checkpoints.save_state`` file or
a ``TopKCheckpointer`` directory (its best entry).  ``--norms`` names the
npz of the norms the checkpoint was trained with.  Without it, a
checkpoint of ``python -m climsim_tpu_torch.run`` whose
``run_manifest.json`` names norms other than the packaged assets
(``data.norms=compute`` or ``identity``) takes the ``run_norms.npz`` the
run saved beside it, and is refused without one; otherwise the packaged
asset of the preset's varspec.  The metadata records their source and
feature space.  The programs run on the device they were exported on
(``--device``, the card by default), and their kernels build there at
first use.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import time
from functools import partial


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _file_entry(path: str) -> dict:
    return {"sha256": _sha256(path), "bytes": os.path.getsize(path)}


def _load_weights(ckpt: str, model):
    """A ``save_state`` file, or a top-K directory's best entry, loaded
    into ``model``."""
    from .train.checkpoints import TopKCheckpointer, load_state

    if os.path.isdir(ckpt):
        if not os.path.exists(os.path.join(ckpt, "topk.json")):
            raise SystemExit(f"{ckpt}: a directory without topk.json (the "
                             "port has no orbax checkpoints)")
        topk = TopKCheckpointer(ckpt)
        if topk.load_best(model) is None:
            raise SystemExit(f"{ckpt}/topk.json lists no checkpoints")
        metric, step, _ = topk.best()
        print(f"loaded top-K best: step {step} (metric {metric:g})")
        return model
    return load_state(ckpt, model)


def _run_norms(ckpt: str) -> str | None:
    """The norms the checkpoint's run trained with, where its
    ``run_manifest.json`` (``python -m climsim_tpu_torch.run``) lies beside
    it and names norms other than the packaged assets: the npz the run
    saved there.  Refuses such a run without that npz.  None where there
    is no manifest or the run trained on the assets."""
    from .norms import RUN_NORMS

    d = ckpt if os.path.isdir(ckpt) else os.path.dirname(
        os.path.abspath(ckpt))
    manifest = os.path.join(d, "run_manifest.json")
    if not os.path.exists(manifest):
        return None
    with open(manifest) as f:
        mode = json.load(f)["config"]["data"]["norms"]
    if mode == "asset":
        return None
    path = os.path.join(d, RUN_NORMS)
    if not os.path.exists(path):
        raise SystemExit(f"{manifest}: the run trained with data.norms="
                         f"{mode}, and {RUN_NORMS} is not beside it; pass "
                         "the npz of its norms with --norms")
    return path


def _model(cfg, spec, ckpt, seed: int):
    import torch

    from .models import build_model

    model = build_model(cfg.model, spec, **cfg.model_kw,
                        generator=torch.Generator().manual_seed(seed))
    if ckpt:
        _load_weights(ckpt, model)
    return model.eval()


def build_bundle(preset: str, ckpt: str | None, out: str, buckets,
                 cls_ckpt: str | None = None, verify: bool = False,
                 seed: int = 0, overrides: tuple = (),
                 cls_overrides: tuple = (), norms: str | None = None,
                 device="cuda") -> dict:
    """Export ``preset``'s coupling wrapper for every batch of ``buckets``
    into ``out``; returns the metadata.  ``ckpt`` None is a fresh model
    from ``seed`` (wire testing only).  ``verify`` loads every program and
    holds it to the live wrapper within 1e-5 * max(1, max|want|), the JAX
    packager's tolerance (scripts/package_e3sm.py:187-205)."""
    import numpy as np
    import torch

    from .config import PRESETS
    from .data.synthetic import synthetic_inputs
    from .grid import load_default_grid
    from .norms import NormStats, load_asset_norms
    from .online import wrapper as W
    from .ops.unet_infer import unet_apply_fused
    from .varspec import get_varspec

    cfg = PRESETS[preset]
    if overrides:
        cfg = cfg.override(*overrides)
    spec = get_varspec(cfg.data.varspec)
    run_norms = None if norms or not ckpt else _run_norms(ckpt)
    if norms:
        stats = NormStats.from_npz(norms)
        norm_source = {"path": os.path.abspath(norms), **_file_entry(norms)}
    elif run_norms:
        stats = NormStats.from_npz(run_norms)
        norm_source = {"run": os.path.abspath(run_norms),
                       **_file_entry(run_norms)}
    else:
        stats = load_asset_norms(cfg.data.varspec)
        norm_source = {"asset": f"norms_{cfg.data.varspec}.npz"}
    lengths = {k: len(getattr(stats, k)) for k in (
        "inp_sub", "inp_div", "out_scale", "lbd_qn", "lbd_qc", "lbd_qi")
        if getattr(stats, k) is not None}
    if (lengths["inp_sub"], lengths["out_scale"]) != (spec.input_len,
                                                      spec.output_len):
        raise SystemExit(f"norms of {lengths['inp_sub']} inputs and "
                         f"{lengths['out_scale']} outputs; the {preset} "
                         f"model ({spec.name}) takes {spec.input_len} and "
                         f"gives {spec.output_len}")
    if cls_ckpt is not None and cfg.data.varspec != "v5":
        raise SystemExit("--cls-ckpt is only meaningful for v5 presets")
    model = _model(cfg, spec, ckpt, seed).to(device)
    models = [model]

    # the host's input contract a model family (online_testing/README.md
    # 3.1: E3SM links v5 models through the raw v4 feature vector)
    if cfg.data.varspec == "v5":
        in_spec = get_varspec("v4")
        apply = partial(unet_apply_fused, model)
        if cls_ckpt is not None:
            from .online.two_stage import make_two_stage_apply

            cls_cfg = PRESETS["unet_v5_classifier"]
            if cls_overrides:
                cls_cfg = cls_cfg.override(*cls_overrides)
            cls_model = _model(cls_cfg, spec, cls_ckpt, seed + 1).to(device)
            models.append(cls_model)
            apply = make_two_stage_apply(
                apply, partial(unet_apply_fused, cls_model), stats=stats,
                device=device)
        wrap = W.make_wrapper(apply, stats, W.WrapperConfig(), device=device)
    elif cfg.data.varspec == "v4":
        # serve with the input chain the preset trains with: a wrapper
        # whose preprocessing differs from training breaks the contract
        in_spec = spec
        wrap = W.make_v4_wrapper(partial(unet_apply_fused, model), stats,
                                 spec, tcfg=cfg.transform, device=device)
    elif cfg.data.varspec == "v2_rh":
        in_spec = spec
        wrap = W.make_v2rh_wrapper(model, stats, spec, tcfg=cfg.transform,
                                   device=device)
    else:
        raise SystemExit(f"preset {preset!r} (varspec {cfg.data.varspec}) "
                         "has no online coupling contract")

    os.makedirs(out, exist_ok=True)
    stats.save_txt(out)
    norm_files = [f"{k}.txt" for k in ("inp_sub", "inp_div", "out_scale",
                                       "lbd_qn") if k in lengths]
    artifacts = {}
    for b in buckets:
        path = os.path.join(out, f"wrapper_b{b}.pt2")
        t0 = time.perf_counter()
        W.export_aot(wrap, b, in_spec.input_len, path, device=device)
        export_s = time.perf_counter() - t0
        print(f"exported b={b} in {export_s:.1f} s "
              f"({os.path.getsize(path)} bytes)", flush=True)
        artifacts[os.path.basename(path)] = {
            "batch": b, **_file_entry(path), "export_s": export_s}

    dev = torch.device(device)
    meta = {
        "preset": preset,
        "model": cfg.model,
        "varspec": cfg.data.varspec,
        "input_version": in_spec.name,
        "n_features": in_spec.input_len,
        "n_outputs": 368,
        "scheme": "two_stage" if cls_ckpt else "regressor",
        # a program keeps the device it was exported on
        "platform": dev.type,
        "device_name": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else None),
        "load": "climsim_tpu_torch.online.wrapper.load_aot: it imports "
                "climsim_tpu_torch.ops, which registers the kernels' "
                "operators (namespace climsim_tpu_torch)",
        "transform": (
            "v5_nn_wrapper chain (qn-lambda, prune, clip, repartition)"
            if cfg.data.varspec == "v5"
            else dataclasses.asdict(cfg.transform)),
        "untrained": ckpt is None,
        "param_count": sum(p.numel() for m in models
                           for p in m.parameters()),
        # the feature space the norm vectors are in, beside input_version
        "norm_space": cfg.data.varspec,
        "norms": {"source": norm_source, "lengths": lengths},
        "norm_files": {f: _file_entry(os.path.join(out, f))
                       for f in norm_files},
        "artifacts": artifacts,
        "serve": (f"python -m climsim_tpu_torch.serve --bundle {{bundle}} "
                  f"--batch {buckets[0]}"),
    }
    if verify:
        grid = load_default_grid()
        for b in buckets:
            x = synthetic_inputs(in_spec, b, grid, seed=seed)
            if "icol" in in_spec.input_slices:
                x[:, in_spec.input_slices["icol"]] = (
                    np.arange(b) % 384 + 1)[:, None]
            x = torch.from_numpy(np.asarray(x, np.float32)).to(device)
            program = W.load_aot(os.path.join(out, f"wrapper_b{b}.pt2"))
            with torch.inference_mode():
                got, want = program(x), wrap(x)
            err = float((got - want).abs().max())
            if tuple(got.shape) != (b, 368):
                raise AssertionError(f"b={b}: program gives {got.shape}")
            limit = 1e-5 * max(1.0, float(want.abs().max()))
            if not err <= limit:
                raise AssertionError(f"b={b}: program {err:.3e} from the "
                                     f"live wrapper (> {limit:.3e})")
            artifacts[f"wrapper_b{b}.pt2"]["verify_max_abs_diff"] = err
            print(f"verify b={b}: program == wrapper (max abs diff "
                  f"{err:.2e}, bit-equal {bool(torch.equal(got, want))})",
                  flush=True)
    with open(os.path.join(out, "metadata.json"), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--preset", required=True,
                    help="config preset (unet_v5, unet_v4, mlp_v2rh)")
    ap.add_argument("--ckpt", help="save_state file or top-K checkpoint "
                    "directory (its best entry); omitted = fresh weights "
                    "from --seed (wire testing only)")
    ap.add_argument("--cls-ckpt",
                    help="classifier checkpoint -> package the two-stage "
                    "composition (v5 presets only)")
    ap.add_argument("--buckets", default="384",
                    help="comma-separated batch buckets to export")
    ap.add_argument("--out", required=True, help="bundle output directory")
    ap.add_argument("--norms", help="npz of the norms the checkpoint was "
                    "trained with (default: the run's run_norms.npz where "
                    "its manifest names computed norms, else the packaged "
                    "asset)")
    ap.add_argument("--verify", action="store_true",
                    help="load each program and hold it to the live "
                    "wrapper on synthetic columns")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    metavar="K.EY=V", help="dotted config override on the "
                    "preset (e.g. model_kw.model_channels=32); repeatable")
    ap.add_argument("--cls-set", dest="cls_overrides", action="append",
                    default=[], metavar="K.EY=V",
                    help="the same, on the classifier preset")
    args = ap.parse_args(argv)

    buckets = [int(b) for b in args.buckets.split(",") if b]
    if not buckets or any(b <= 0 for b in buckets):
        ap.error("--buckets must be positive integers")
    meta = build_bundle(args.preset, args.ckpt, args.out, buckets,
                        cls_ckpt=args.cls_ckpt, verify=args.verify,
                        seed=args.seed, overrides=tuple(args.overrides),
                        cls_overrides=tuple(args.cls_overrides),
                        norms=args.norms, device=args.device)
    print(json.dumps(meta, indent=2))


if __name__ == "__main__":
    main()
