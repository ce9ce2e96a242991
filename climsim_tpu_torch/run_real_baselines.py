"""ONE command from a raw E3SM-MMF directory to BASELINE-format tables.

The port's entry for ``scripts/run_real_baselines.py``: point --data-dir
at a tree of raw ``E3SM-MMF.mli/.mlo.*.nc`` files (the low-res dataset, or
any subset with matching mli/mlo pairs) and it

  1. selects the canonical train/scoring splits (years 1-7 + 0008-01
     stride 7 / 0008-02..0009-01 stride 6 -- preprocessing/README.md),
     or a capped subset via --max-files,
  2. ingests them to raw float32 shards with the process-pool builder
     (data/ingest.py; resumable -- existing shards are reused),
  3. trains all six NeurIPS baselines with
     ``run_all_baselines.train_and_score`` on the card,
  4. scores them in the common W/m^2 metric space and writes a table with
     the reference's published numbers (BASELINE.md) side by side.

    python -m climsim_tpu_torch.run_real_baselines --data-dir DIR \\
        [--max-files N] [--epochs 12] [--out docs/REAL_RESULTS.torch.md]

The report goes to ``docs/REAL_RESULTS.torch.md`` by default, never to
the JAX script's ``docs/REAL_RESULTS.md``.
"""

from __future__ import annotations

import argparse
import os
import re
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse_baseline_md(path: str) -> dict:
    """BASELINE.md metric tables -> {variable: {metric: {model: value}}}.

    The tables are the reference's published numbers
    (website/evaluating.md:15-70); parsing the in-repo copy avoids
    duplicating them here."""
    out: dict = {}
    if not os.path.exists(path):
        return out
    metric = None
    models: list[str] = []
    name_map = {"dT/dt": "ptend_t", "dq/dt": "ptend_q0001",
                "NETSW": "cam_out_NETSW", "FLWDS": "cam_out_FLWDS",
                "PRECSC": "cam_out_PRECSC", "PRECC": "cam_out_PRECC",
                "SOLS": "cam_out_SOLS", "SOLL": "cam_out_SOLL",
                "SOLSD": "cam_out_SOLSD", "SOLLD": "cam_out_SOLLD"}
    with open(path) as f:
        lines = f.readlines()
    for line in lines:
        m = re.match(r"^## (MAE|R²|R2|RMSE|CRPS)", line.strip())
        if m:
            metric = {"R²": "R2"}.get(m.group(1), m.group(1))
            models = []
            continue
        if metric is None or not line.startswith("|"):
            continue
        cells = [c.strip() for c in line.strip().strip("|").split("|")]
        if cells and cells[0] == "Variable":
            models = cells[1:]
            continue
        if not models or set(cells[0]) <= {"-", " "}:
            continue
        var = name_map.get(cells[0])
        if var is None:
            continue
        for mod, val in zip(models, cells[1:]):
            val = val.replace("**", "").replace("−", "-").strip()
            if val in ("—", "--", ""):
                continue
            try:
                out.setdefault(var, {}).setdefault(metric, {})[mod] = \
                    float(val)
            except ValueError:
                pass
    return out


def fallback_filelist(data_dir: str, split: str) -> list:
    """Capsule-tree (one-month) split: parity-split the full file list
    FIRST so train/scoring are disjoint, THEN apply the canonical stride.
    (Striding first and parity-splitting after overlaps at every lcm
    index.)"""
    from .data import ingest

    stride = ingest.CANONICAL_SPLITS[split][1]
    files = ingest.build_filelist(data_dir, ["E3SM-MMF.mli.*.nc"], 1)
    return (files[0::2] if split == "train" else files[1::2])[::stride]


def ingest_splits(data_dir: str, shard_dir: str, spec, grid, stats,
                  max_files: int | None, workers: int,
                  verbose: bool = True) -> dict:
    """Canonical splits -> shards (skip splits already built)."""
    from .data import ingest

    paths = {}
    for split in ("train", "scoring"):
        xp = os.path.join(shard_dir, f"{split}_input.npy")
        yp = os.path.join(shard_dir, f"{split}_target.npy")
        if os.path.exists(xp) and os.path.exists(yp):
            if verbose:
                print(f"{split}: reusing existing shards in {shard_dir}")
            paths[split] = (xp, yp)
            continue
        files = ingest.canonical_filelist(data_dir, split)
        if not files:
            # capsule trees (one month) predate the canonical periods
            files = fallback_filelist(data_dir, split)
        if max_files:
            files = files[:max_files]
        if not files:
            raise FileNotFoundError(
                f"no E3SM-MMF.mli files for split '{split}' under "
                f"{data_dir}")
        t0 = time.time()
        ingest.build_split(files, spec, shard_dir, split, grid=grid,
                           stats=stats, workers=workers)
        if verbose:
            print(f"{split}: {len(files)} files -> shards in "
                  f"{time.time() - t0:.0f}s")
        paths[split] = (xp, yp)
    return paths


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", required=True,
                    help="root of the raw E3SM-MMF mli/mlo nc tree")
    ap.add_argument("--shard-dir", default=None,
                    help="where to write/reuse npy shards "
                         "(default <data-dir>/../climsim_shards)")
    ap.add_argument("--grid-file", default=None,
                    help="ClimSim grid-info netCDF (default: bundled "
                         "ne4 assets)")
    ap.add_argument("--norms", default="assets",
                    choices=("assets", "compute"),
                    help="'assets': the published normalization factors; "
                         "'compute': fit from the ingested train split")
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--max-files", type=int, default=None,
                    help="cap files per split (capsule runs)")
    ap.add_argument("--workers", type=int, default=max(
        (os.cpu_count() or 1) - 1, 0))
    ap.add_argument("--out", default=os.path.join("docs",
                                                  "REAL_RESULTS.torch.md"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from .grid import Grid, load_default_grid
    from .norms import compute_norms_from_data, load_asset_norms
    from .run_all_baselines import (card_line, metric_tables_markdown,
                                    train_and_score, training_table_markdown)
    from .varspec import get_varspec

    t_all = time.time()
    spec = get_varspec("v1")
    grid = (Grid.from_netcdf(args.grid_file) if args.grid_file
            else load_default_grid())
    shard_dir = args.shard_dir or os.path.join(
        os.path.dirname(os.path.abspath(args.data_dir)), "climsim_shards")
    os.makedirs(shard_dir, exist_ok=True)

    # shards are RAW (normalization runs inside the train step,
    # data/transforms.py); --norms only selects the trainers' and the
    # scorer's stats
    paths = ingest_splits(args.data_dir, shard_dir, spec, grid, None,
                          args.max_files, args.workers)

    x_tr = np.asarray(np.load(paths["train"][0], mmap_mode="r"))
    y_tr = np.asarray(np.load(paths["train"][1], mmap_mode="r"))
    x_sc = np.asarray(np.load(paths["scoring"][0], mmap_mode="r"))
    y_sc = np.asarray(np.load(paths["scoring"][1], mmap_mode="r"))
    print(f"train {x_tr.shape}, scoring {x_sc.shape}")

    stats = (load_asset_norms("v1") if args.norms == "assets"
             else compute_norms_from_data(spec, x_tr, y_tr))

    tables, train_info, _preds, _samples = train_and_score(
        spec, grid, stats, x_tr, y_tr, x_sc, y_sc, epochs=args.epochs,
        device=args.device)

    reference = parse_baseline_md(os.path.join(_REPO, "BASELINE.md"))
    lines = [
        "# Real-dataset baseline results (PyTorch port)",
        "",
        f"Produced by `python -m climsim_tpu_torch.run_real_baselines "
        f"--data-dir {args.data_dir}` -- raw E3SM-MMF nc tree -> canonical "
        "splits -> shards -> all six NeurIPS baselines -> weighted metrics "
        f"(device: {card_line(args.device)}; {args.epochs} epochs, "
        f"{x_tr.shape[0]:,} train / {x_sc.shape[0]:,} scoring samples).",
        "",
        "`ref MODEL` columns are the reference's published numbers "
        "(BASELINE.md <- website/evaluating.md:15-70).  Published numbers "
        "are for the FULL canonical splits; capsule runs (--max-files) "
        "undertrain by construction.",
        "",
    ]
    lines += metric_tables_markdown(tables, reference=reference)
    lines += training_table_markdown(train_info)
    lines += ["", f"Total wall-clock: {time.time() - t_all:.0f} s."]
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out} ({time.time() - t_all:.0f}s total)")
    return dict(tables=tables, train_info=train_info, out=args.out)


if __name__ == "__main__":
    main()
