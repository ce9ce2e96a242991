"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The run builds the cell's program from the seed, warms up every shape its
traffic uses (set-up, ``setup_s``), measures for ``--seconds``, checks
what the timed path produced against the plain reference, and prints one
JSON line last on standard output: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a profiler trace of a stretch of the window),
``device``, with ``--trace 1`` a ``breakdown``, and last ``checks``: each
number compared beside its limit, which also end standard error.  Without
a CUDA device it exits 2 and prints no result; if JAX or the JAX package
was loaded, 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    sys.path[0] = str(ROOT)        # run as a script: no shadowed names
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402

T_PROCESS = harness.process_start()
CACHE = ROOT / "portbench" / "_cache"


class Context:
    """What a driver gets: the cell and the run's arguments."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t_process: float = T_PROCESS):
        from portbench.tracing import Tracer

        self.cell, self.config, self.mix = cell, cell.config, cell.mix
        self.reference, self.limits = cell.reference, cell.limits
        self.seed, self.seconds, self.device = seed, seconds, device
        self.t_process = t_process
        stretch = cell.spec["trace"]
        self.tracer = (Tracer(min(stretch["start_s"], 0.25 * seconds),
                              min(stretch["seconds"], 0.5 * seconds))
                       if trace else None)


def per_layer(data: dict) -> dict:
    """Each reader's reading; a reader with nothing to read is left out."""
    out = {}
    for name in harness.names("metrics"):
        mod = harness.load_module("metrics", name)
        value = mod.read(data)
        if value is not None:
            out[name] = {"value": value, "unit": mod.UNIT}
    return out


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unread"


def result_line(res: dict, ctx: Context, trace: bool) -> dict:
    import torch

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": ctx.cell.spec["chips"],
              "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": bool(res["correct"]),
            "attempted": int(res["attempted"]), "failed": int(res["failed"])}
    if trace:
        tracer = res["data"].get("trace")
        digest = None if tracer is None else tracer.digest
        line["metrics"] = per_layer(res["data"])
        if digest is not None:
            device["busy_s"] = digest.busy_s
            device["window_s"] = digest.window_s
        line["device"] = device
        if digest is not None:
            line["breakdown"] = digest.breakdown()
    else:
        line["metrics"] = res["end_to_end"]
        line["device"] = device
    line["card"] = power_limit()
    line["checks"] = res["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)
    cell = harness.Cell(args.workload)

    import torch

    harness.say(T_PROCESS, "torch imported")
    if not torch.cuda.is_available():
        print("portbench: no CUDA device; the benchmark runs on the card "
              "only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.spec["chips"]:
        print(f"portbench: {cell.name} needs {cell.spec['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    res = cell.driver.run(ctx)
    line = result_line(res, ctx, bool(args.trace))
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: the run loaded {loaded}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for name, c in res["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
