"""Ingest throughput benchmark: raw nc tree -> shards at volume.

The port's entry for ``scripts/bench_ingest.py`` (host only: no device,
no kernel).  It times the port's ``data.ingest.build_split`` (the
streaming numpy reader and its process pool) on production-shaped files
(ncol=384, 60 levels, float64, the full mli/mlo variable sets -- the real
low-res file geometry) and projects the full-dataset ingest wall-clock:

  * writes a synthetic nc tree of --pairs mli/mlo pairs (~2.6 MB a pair;
    the real low-res set is ~3.5 MB a pair) with the package's copy of
    the test tree builder (``data.synthnc.make_tree``)
  * times build_split serially and with worker pools (v2 flat mode and
    v5 expanded-window mode)
  * reports pairs/s and MB/s a mode and worker count
  * projects the 744 GB low-res and 41.2 TB high-res ingest wall-clock
    for N-core ingest nodes (the work a pair is independent of the others)

    python -m climsim_tpu_torch.bench_ingest [--pairs 400] [--workers 0,1,2,4]

Prints a markdown table and one JSON line; the tree lives in a temporary
directory (under TMPDIR) and is removed unless --keep.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from pathlib import Path

NCOL_PROD = 384

# the real low-res dataset: 10 yr x 365 d x 72 steps = 262,800 step pairs
# minus spinup months actually on HuggingFace ~ 210,240; 744 GB total.
LOWRES_PAIRS = 210_240
LOWRES_GB = 744.0
HIGHRES_GB = 41_200.0  # ne30: same timesteps, ncol=21600 (56.25x columns)


def gen_tree(root: Path, pairs: int, ncol: int = NCOL_PROD) -> float:
    """Production-geometry synthetic tree; returns total GB."""
    from .data.synthnc import make_tree
    from .grid import load_default_grid

    grid = load_default_grid()
    t0 = time.time()
    make_tree(root / "0001-02", grid, nsteps=pairs, ncol=ncol)
    gb = sum(f.stat().st_size for f in root.rglob("*.nc")) / 1e9
    print(f"generated {pairs} pairs, {gb:.2f} GB "
          f"in {time.time() - t0:.1f}s")
    return gb


def bench(filelist, spec, grid, workers: int, out: Path, window: bool):
    from .data.ingest import build_split

    t0 = time.time()
    build_split(filelist, spec, str(out), f"bench_w{workers}", grid=grid,
                window=window, workers=workers)
    return time.time() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=400)
    ap.add_argument("--workers", default="0,1,2,4")
    ap.add_argument("--keep", action="store_true")
    args = ap.parse_args(argv)

    from .grid import load_default_grid
    from .varspec import get_varspec

    grid = load_default_grid()
    worker_list = [int(w) for w in args.workers.split(",")]
    tmp = Path(tempfile.mkdtemp(prefix="bench_ingest_"))
    try:
        tree = tmp / "tree"
        gb = gen_tree(tree, args.pairs)
        files = sorted(str(p) for p in tree.rglob("*.mli.*.nc"))
        gb_per_pair = gb / args.pairs
        rows = []
        for mode, spec_name, window in (("v2 flat", "v2", False),
                                        ("v5 window", "v5", True)):
            spec = get_varspec(spec_name)
            n_emitted = args.pairs - (2 if window else 0)
            for w in worker_list:
                dt = bench(files, spec, grid, w, tmp / "out", window)
                fps = n_emitted / dt
                rows.append({
                    "mode": mode, "workers": w, "seconds": round(dt, 2),
                    "pairs_per_s": round(fps, 2),
                    "mb_per_s": round(fps * gb_per_pair * 1000, 1),
                })
                print(f"{mode} workers={w}: {dt:.1f}s  "
                      f"{fps:.2f} pairs/s  "
                      f"{fps * gb_per_pair * 1000:.1f} MB/s")

        best = max(rows, key=lambda r: r["pairs_per_s"])
        # projections: the work a pair is independent of the others
        best_fps = best["pairs_per_s"]
        ncores = os.cpu_count() or 1
        print("\n| mode | workers | wall s | pairs/s | MB/s |")
        print("|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['mode']} | {r['workers']} | {r['seconds']} | "
                  f"{r['pairs_per_s']} | {r['mb_per_s']} |")
        print(f"\nthis host: {ncores} core(s); best {best_fps} pairs/s "
              f"({best['mode']}, workers={best['workers']})")
        for cores in (1, 16, 64):
            hrs = LOWRES_PAIRS / (best_fps * cores) / 3600
            hrs_hi = hrs * (HIGHRES_GB / LOWRES_GB)
            print(f"projected full ingest at {cores} cores: "
                  f"low-res 744 GB = {hrs:.1f} h, "
                  f"high-res 41.2 TB = {hrs_hi:.1f} h")
        print(json.dumps({
            "metric": "ingest_pairs_per_s", "value": best_fps,
            "unit": "pairs/s", "rows": rows,
            "host_cores": ncores, "gb_per_pair": round(gb_per_pair, 4),
            "lowres_hours_64core": round(
                LOWRES_PAIRS / (best_fps * 64) / 3600, 2)}))
        return rows
    finally:
        if not args.keep:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
