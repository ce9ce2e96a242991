"""Finding the benchmark's pieces by name, and what every run shares.

A cell is ``workloads/<cell>.json``: its configuration, its traffic mix
and its traced stretch, with the limits of its correctness check.  A
configuration is ``configs/<config>.json`` with its plain reference
``reference/<config>.py``; a traffic mix is ``traffic/mixes/<mix>.json``,
which names its driver, ``drivers/<driver>.py``; a per-layer metric is
the reader ``metrics/<metric>.py``.  Adding any of them is adding files.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: JAX, its companions, and
# the JAX package beside the port (compared whole: the port's name
# begins with it)
FORBIDDEN = ("jax", "jaxlib", "flax", "climsim_tpu")


def load_json(kind: str, name: str) -> dict:
    """``kind`` is "configs", "workloads" or "mixes"."""
    folder = HERE / "traffic" / "mixes" if kind == "mixes" else HERE / kind
    path = folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r} ({path})")
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """The module ``<kind>/<name>.py`` ("drivers", "metrics" or
    "reference"), imported as a submodule of ``portbench.<kind>``."""
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module {name!r} ({path})")
    importlib.import_module(f"portbench.{kind}")
    modname = f"portbench.{kind}.{re.sub(r'[^0-9A-Za-z_]', '_', name)}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def names(kind: str) -> list:
    """Every name of ``kind`` present, from the file names."""
    if kind == "mixes":
        return sorted(p.stem for p in (HERE / "traffic" / "mixes").glob(
            "*.json"))
    suffix = ".py" if kind in ("drivers", "metrics", "reference") \
        else ".json"
    return sorted(p.name[:-len(suffix)] for p in (HERE / kind).glob(
        f"*{suffix}") if p.name != "__init__.py" and p.name[0] != "_")


class Cell:
    """A cell, its configuration, traffic mix, driver and reference."""

    def __init__(self, name: str):
        self.name = name
        self.spec = load_json("workloads", name)
        self.config = load_json("configs", self.spec["config"])
        self.mix = load_json("mixes", self.spec["traffic"])
        self.driver = load_module("drivers", self.mix["driver"])
        self.reference = load_module("reference", self.spec["config"])
        self.limits = self.spec["limits"]

    def path(self, rel: str) -> str:
        """A file of the checkout named relative to its root."""
        return str(ROOT / rel)


def host_copy(t):
    """A copy of tensor ``t`` on the host (never a view of a host
    tensor, which the program may go on changing)."""
    return t.detach().to("cpu", copy=True)


def forbidden_loaded() -> list:
    """Modules of ``sys.modules`` whose top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock, from its
    age in /proc (clock ticks since boot); now where that cannot be read."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return now
    return now - max(age, 0.0)


def nearest_rank(values, q: float) -> float:
    """The ``q`` quantile (0 < q <= 1) by nearest rank: the least value
    with at least a share ``q`` of all values at or below it.  A failed
    request enters as +inf and so misses every limit."""
    import math

    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(q * len(v)) - 1, 0)]


def gap_by_leaf(prog: dict, ref: dict, keep=None) -> float:
    """The widest gap between the norms of the program's leaves and the
    reference's, each over the larger of the reference leaf's norm and the
    median leaf's: ``max |‖p‖ - ‖r‖| / max(‖r‖, median ‖r‖)``, over the
    leaves of ``keep`` (all by default)."""
    import torch

    names_ = [n for n in ref if keep is None or n in keep]
    rn = {n: float(torch.linalg.vector_norm(ref[n].double())) for n in names_}
    pn = {n: float(torch.linalg.vector_norm(prog[n].double())) for n in names_}
    med = float(torch.tensor(list(rn.values())).median())
    return max(abs(pn[n] - rn[n]) / max(rn[n], med) for n in names_)


def diff_by_leaf(prog: dict, ref: dict) -> float:
    """The widest difference of the program's leaves from the reference's:
    ``max ‖p - r‖ / max(‖r‖, median ‖r‖)`` over the leaves."""
    import torch

    rn = {n: float(torch.linalg.vector_norm(r.double()))
          for n, r in ref.items()}
    med = float(torch.tensor(list(rn.values())).median())
    return max(float(torch.linalg.vector_norm(prog[n].double()
                                              - ref[n].double()))
               / max(rn[n], med) for n in ref)


def counted_leaves(grad: dict, share: float = 1e-3) -> set:
    """Leaves whose reference gradient's norm is at least ``share`` of the
    median leaf's: the others (a key's bias under softmax) move under Adam
    by round-off alone."""
    import torch

    n = {k: float(torch.linalg.vector_norm(g.double()))
         for k, g in grad.items()}
    med = float(torch.tensor(list(n.values())).median())
    return {k for k, v in n.items() if v >= share * med}


def gap_by_column(prog, ref, scale) -> float:
    """The widest gap of a reply to the reference's, column by column in
    scaled units: ``max_j ‖p_j - r_j‖ / max(‖r_j‖, median_j ‖r_j‖)``, the
    norms over the rows; +inf where the shapes differ or a value is not
    finite."""
    import torch

    if tuple(prog.shape) != tuple(ref.shape):
        return float("inf")
    p = torch.as_tensor(prog, dtype=torch.float64) * scale
    r = torch.as_tensor(ref, dtype=torch.float64) * scale
    if not bool(torch.isfinite(p).all()):
        return float("inf")
    rn = torch.linalg.vector_norm(r, dim=0)
    den = torch.maximum(rn, rn.median())
    return float((torch.linalg.vector_norm(p - r, dim=0) / den).max())


def say(t_process: float, what: str) -> None:
    """A line on standard error: seconds since the process started, and
    what set-up has just done."""
    print(f"portbench: {time.perf_counter() - t_process:8.2f} s  {what}",
          file=sys.stderr, flush=True)
