"""The readings that a cell's correctness limits are set from.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,...
        [--control-seeds 1,2,3] [--seconds 4]

For each seed it drives the cell's program as a run does and prints, as
one JSON line, each number that the run compares (``program``).  For the
control seeds it also prints the same numbers of the control: the plain
reference computed at fp8 (e4m3's mantissa; the precision below the
configuration's bf16) in the program's place; and, for a training cell,
of the reference put in the program's place with half of each batch left
out (the mean over the rest), whose model receives half of each batch.  A
state left unchanged reads 1 by the
measure of the gaps and is not run.  A served cell's program readings
come from a window of ``--seconds`` at the cell's own load.  Runs on the
card; not a part of the benchmark's runs.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)

from portbench import harness  # noqa: E402


def train_seed(ctx, control: bool) -> dict:
    import torch

    from portbench.drivers import train as T

    mix = ctx.mix
    x, y = T.pool(ctx)
    tr, loader, weights = T.build(ctx, x, y)
    rec = T.Recorder(tr.train_step, tr.model, mix["follow"])
    loader.make_epoch_runner(rec)(tr.state, mix["warm_epochs"])
    rec.close()
    prog = {"loss": rec.losses, "grad": rec.first_grad,
            "change": {k: rec.after[k] - weights[k] for k in weights}}
    batches = rec.batches
    unseen = T.rows_unseen(batches, rec.rows_seen)
    del tr, loader, rec
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    ref = T.follow(ctx, weights, batches)
    out = {"program": {**T.gaps(prog, ref), "batch_rows_unseen": unseen}}
    if control:
        out["control"] = T.gaps(T.follow(ctx, weights, batches, "fp8"), ref)
        half = [(xb[:len(xb) // 2], yb[:len(yb) // 2]) for xb, yb in batches]
        # the model of a step that leaves half its batch out receives half
        out["half_batch"] = {
            **T.gaps(T.follow(ctx, weights, half), ref),
            "batch_rows_unseen": T.rows_unseen(
                batches, [len(xb) for xb, _ in half])}
    return out


def serve_seed(ctx, control: bool) -> dict:
    from portbench.drivers import serve as S

    res = ctx.cell.driver.run(ctx)
    out = {"program": {k: v["value"] for k, v in res["checks"].items()},
           "served_columns_per_s":
               res["end_to_end"]["served_columns_per_s"]["value"]}
    if control:
        wts = ctx.reference.make_weights(ctx.config, ctx.seed, ctx.device)
        wts = {k: v.cpu() for k, v in wts.items()}
        ref, scale = S.reference_replies(ctx, wts)
        ctl, _ = S.reference_replies(ctx, wts, "fp8")
        out["control"] = {"reply_gap": max(
            harness.gap_by_column(ctl[c, k], ref[c, k], scale)
            for c in range(ref.shape[0]) for k in range(ref.shape[1]))}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=4.0)
    args = ap.parse_args(argv)

    from portbench.run import Context

    cell = harness.Cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        ctx = Context(cell, seed, args.seconds, False,
                      t_process=time.perf_counter())
        fn = train_seed if cell.mix["driver"] == "train" else serve_seed
        row = {"workload": cell.name, "seed": seed,
               **fn(ctx, seed in controls),
               "seconds": time.perf_counter() - t}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
