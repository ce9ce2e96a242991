"""Raw netCDF -> columnar training shards (the L1 preprocessing layer).

Replaces the reference's xarray generator pipeline (data_utils.py:619-944)
and the feature-expansion script (online_testing/data_preparation/
expand_feature/climsim_adding_input.py) with a dependency-light, streaming
shard builder on the pure-numpy netCDF reader:

  * canonical split selection (regex + stride), preprocessing/README.md:
    train = years 1-7 + 0008-01 stride 7; val = 0008-02..0009-01 stride 7;
    scoring = same period stride 6
  * derived input variables on read (state_rh, state_qn, liq_partition,
    icol, qn_prvphy sums -- data_utils.get_xrdata :619-676)
  * target construction: ptend = (mlo - mli)/1200 s (:685-712)
  * expanded v4/v5 features computed from a 3-file window (tm_* previous
    state, *_prvphy physics tendencies, *_dyn forcings, clat/slat/icol --
    climsim_adding_input.py:35-78) WITHOUT writing intermediate 'mlexpand'
    netCDF files: the window is assembled in memory
  * float32 shard output with inf/nan -> 0 (:894-897), .npy and/or .h5

Everything is a pure function over file paths; parallelize over files with
any process pool.
"""

from __future__ import annotations

import fnmatch
import os
import re

import numpy as np

from ..grid import Grid
from ..physics import relative_humidity_np
from ..varspec import NUM_LEVELS, VarSpec, var_len
from ..utils.ncread import read_netcdf

DT = 1200.0

CANONICAL_SPLITS = {
    # regexps over 'E3SM-MMF.mli.YYYY-MM-DD-SSSSS.nc' basenames + stride
    "train": (["E3SM-MMF.mli.000[1234567]-*-*-*.nc",
               "E3SM-MMF.mli.0008-01-*-*.nc"], 7),
    "val": (["E3SM-MMF.mli.0008-0[23456789]-*-*.nc",
             "E3SM-MMF.mli.0008-1[012]-*-*.nc",
             "E3SM-MMF.mli.0009-01-*-*.nc"], 7),
    "scoring": (["E3SM-MMF.mli.0008-0[23456789]-*-*.nc",
                 "E3SM-MMF.mli.0008-1[012]-*-*.nc",
                 "E3SM-MMF.mli.0009-01-*-*.nc"], 6),
}


def build_filelist(data_path: str, regexps, stride: int, start: int = 0,
                   end: int | None = None) -> list[str]:
    """Glob-style selection over all subdirectories, sorted then strided
    (data_utils.set_filelist :742-771)."""
    out = []
    for root, _dirs, files in os.walk(data_path):
        for f in files:
            if any(fnmatch.fnmatch(f, rx) for rx in regexps):
                out.append(os.path.join(root, f))
    out = sorted(out)
    return out[start:end:stride]


def canonical_filelist(data_path: str, split: str) -> list[str]:
    regexps, stride = CANONICAL_SPLITS[split]
    return build_filelist(data_path, regexps, stride)


def _read_vars(path: str) -> dict[str, np.ndarray]:
    nc = read_netcdf(path)
    return {k: np.asarray(v.data, np.float64)
            for k, v in nc.variables.items()}


def derive_inputs(ds: dict, needed, grid: Grid | None = None) -> dict:
    """Add derived variables the raw files don't carry."""
    ds = dict(ds)
    if "state_rh" in needed and "state_rh" not in ds:
        ds["state_rh"] = relative_humidity_np(
            ds["state_t"], ds["state_q0001"], ds["state_pmid"])
    if "state_qn" in needed and "state_qn" not in ds:
        ds["state_qn"] = ds["state_q0002"] + ds["state_q0003"]
    if "liq_partition" in needed and "liq_partition" not in ds:
        ds["liq_partition"] = np.clip(
            (ds["state_t"] - 253.16) / 20.0, 0.0, 1.0)
    if "state_qn_prvphy" in needed and "state_qn_prvphy" not in ds \
            and "state_q0002_prvphy" in ds:
        ds["state_qn_prvphy"] = (ds["state_q0002_prvphy"]
                                 + ds["state_q0003_prvphy"])
    if "tm_state_qn_prvphy" in needed and "tm_state_qn_prvphy" not in ds \
            and "tm_state_q0002_prvphy" in ds:
        ds["tm_state_qn_prvphy"] = (ds["tm_state_q0002_prvphy"]
                                    + ds["tm_state_q0003_prvphy"])
    if "icol" in needed and "icol" not in ds:
        ncol = ds["state_t"].shape[-2] if ds["state_t"].ndim > 1 else 1
        ds["icol"] = np.arange(1, ncol + 1, dtype=np.float64)
    return ds


def expand_features(ds_in: dict, ds_in_prev: dict, ds_in_prev2: dict,
                    ds_out_prev: dict, ds_out_prev2: dict,
                    lat: np.ndarray) -> dict:
    """v4/v5 memory features from the 3-step window
    (climsim_adding_input.py:35-78)."""
    ds = dict(ds_in)
    for v in ("state_t", "state_q0001", "state_q0002", "state_q0003",
              "state_u", "state_v"):
        ds[f"tm_{v}"] = ds_in_prev[v]
    for v in ("state_t", "state_q0001", "state_q0002", "state_q0003",
              "state_u"):
        ds[f"{v}_prvphy"] = (ds_out_prev[v] - ds_in_prev[v]) / DT
        ds[f"tm_{v}_prvphy"] = (ds_out_prev2[v] - ds_in_prev2[v]) / DT
    ds["state_t_dyn"] = (ds_in["state_t"] - ds_out_prev["state_t"]) / DT
    ds["state_q0_dyn"] = sum(
        ds_in[q] - ds_out_prev[q]
        for q in ("state_q0001", "state_q0002", "state_q0003")) / DT
    ds["state_u_dyn"] = (ds_in["state_u"] - ds_out_prev["state_u"]) / DT
    ds["tm_state_t_dyn"] = (ds_in_prev["state_t"]
                            - ds_out_prev2["state_t"]) / DT
    ds["tm_state_q0_dyn"] = sum(
        ds_in_prev[q] - ds_out_prev2[q]
        for q in ("state_q0001", "state_q0002", "state_q0003")) / DT
    ds["tm_state_u_dyn"] = (ds_in_prev["state_u"]
                            - ds_out_prev2["state_u"]) / DT
    for v in ("state_ps", "pbuf_SOLIN", "pbuf_SHFLX", "pbuf_LHFLX",
              "pbuf_COSZRS"):
        ds[f"tm_{v}"] = ds_in_prev[v]
    ds["clat"] = np.cos(lat * 2.0 * np.pi / 360.0)
    ds["slat"] = np.sin(lat * 2.0 * np.pi / 360.0)
    ds["icol"] = np.arange(1, lat.shape[0] + 1, dtype=np.float64)
    return ds


def compute_targets(ds_in: dict, ds_out: dict, spec: VarSpec) -> dict:
    """ptend_* = (out - in)/1200; cam_out_* pass through
    (data_utils.get_target :685-712)."""
    tgt = {}
    for v in spec.outputs:
        if v.startswith("ptend_"):
            s = v.replace("ptend_", "state_")
            if v == "ptend_qn":
                tgt[v] = ((ds_out["state_q0002"] - ds_in["state_q0002"]
                           + ds_out["state_q0003"] - ds_in["state_q0003"])
                          / DT)
            else:
                tgt[v] = (ds_out[s] - ds_in[s]) / DT
        else:
            tgt[v] = ds_out[v]
    return tgt


def flatten(ds: dict, names, ncol: int) -> np.ndarray:
    """dict of (ncol,) / (lev, ncol) or (ncol, lev) arrays -> (ncol, D)."""
    parts = []
    for v in names:
        a = np.asarray(ds[v], np.float64)
        n = var_len(v)
        if n == 1:
            a = np.broadcast_to(np.atleast_1d(a.squeeze()), (ncol,))
            parts.append(a[:, None])
        else:
            if a.shape == (NUM_LEVELS, ncol):
                a = a.T
            assert a.shape == (ncol, NUM_LEVELS), (v, a.shape)
            parts.append(a)
    return np.concatenate(parts, axis=1)


def process_file_pair(in_path: str, spec: VarSpec,
                      grid: Grid | None = None,
                      input_abbrev: str = "mli",
                      output_abbrev: str = "mlo",
                      window_paths: tuple[str, str] | None = None):
    """One timestep -> (inputs (ncol, D_in), targets (ncol, D_out)) raw.

    window_paths: (prev, prev2) input paths when the spec needs expanded
    features (v4/v5).
    """
    out_path = in_path.replace(f".{input_abbrev}.", f".{output_abbrev}.")
    ds_in = _read_vars(in_path)
    ds_out = _read_vars(out_path)
    ncol = ds_in["state_t"].shape[-1] if ds_in["state_t"].ndim == 2 \
        and ds_in["state_t"].shape[0] == NUM_LEVELS else \
        ds_in["state_t"].shape[0]

    needs_window = any(v.endswith(("_dyn", "_prvphy")) or
                       v.startswith("tm_") for v in spec.inputs)
    if needs_window:
        assert window_paths is not None, \
            f"{spec.name} needs (prev, prev2) window files"
        prev, prev2 = window_paths
        ds_in = expand_features(
            ds_in, _read_vars(prev), _read_vars(prev2),
            _read_vars(prev.replace(f".{input_abbrev}.",
                                    f".{output_abbrev}.")),
            _read_vars(prev2.replace(f".{input_abbrev}.",
                                     f".{output_abbrev}.")),
            np.asarray(ds_in["lat"]) if "lat" in ds_in
            else (grid.lat if grid is not None else np.zeros(ncol)))
    ds_in = derive_inputs(ds_in, spec.inputs, grid)
    x = flatten(ds_in, spec.inputs, ncol)
    y = flatten(compute_targets(ds_in, ds_out, spec), spec.outputs, ncol)
    return x, y


_WORKER_CTX: dict = {}


def _init_build_worker(spec, grid, stats):
    """Pool initializer: ship (spec, grid, stats) ONCE per worker
    instead of pickling them into every task tuple."""
    _WORKER_CTX.update(spec=spec, grid=grid, stats=stats)


def _build_one_pooled(task):
    f, wp = task
    return _build_one((f, wp, _WORKER_CTX["spec"], _WORKER_CTX["grid"],
                       _WORKER_CTX["stats"]))


def _build_one(task):
    """One file pair -> normalized float32 (x, y).  Module-level so a
    ProcessPoolExecutor can pickle it (build_split(workers=N))."""
    f, wp, spec, grid, stats = task
    x, y = process_file_pair(f, spec, grid, window_paths=wp)
    if stats is not None:
        x = (x - stats.inp_sub) / stats.inp_div
        y = y * stats.out_scale
    return x.astype(np.float32), y.astype(np.float32)


def build_split(filelist, spec: VarSpec, save_path: str, split: str,
                grid: Grid | None = None, stats=None,
                save_npy: bool = True, save_h5: bool = False,
                window: bool = False, emit_stride: int = 1,
                workers: int = 0):
    """Materialize a split to {split}_input.npy / {split}_target.npy.

    With stats given, applies training-space normalization on write (the
    reference's normalize=True path, data_utils.py:807-809); inf/nan -> 0.

    window=True computes the expanded v4/v5 features from the two files
    *immediately* preceding each emitted file -- so pass the UN-strided
    filelist and use ``emit_stride`` for temporal subsampling (the
    reference expands features over consecutive timesteps first and
    strides afterwards: climsim_adding_input.py runs on the full list,
    the canonical stride applies to the mlexpand files).  Without window,
    pre-striding the filelist is equivalent.

    workers>0 fans file-pair processing over a process pool (results
    identical to serial; tested).
    """
    os.makedirs(save_path, exist_ok=True)
    tasks = []  # (path, window_paths) in emission order
    for i, f in enumerate(filelist):
        wp = None
        if window:
            if i < 2 or (i - 2) % emit_stride != 0:
                continue
            wp = (filelist[i - 1], filelist[i - 2])
        elif i % emit_stride != 0:
            continue
        tasks.append((f, wp))
    # workers>0: file pairs are independent -> process pool, emission
    # order preserved by map.  The reference's ingest is single-process
    # and documented as too slow for direct use (preprocessing/
    # README.md); at 744 GB low-res parallel ingest is the lever.
    if workers > 0:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        # spawn, not fork: the caller usually has jax loaded, and forking
        # a multithreaded process can deadlock the children
        with ProcessPoolExecutor(
                max_workers=workers,
                mp_context=multiprocessing.get_context("spawn"),
                initializer=_init_build_worker,
                initargs=(spec, grid, stats)) as pool:
            results = list(pool.map(_build_one_pooled, tasks, chunksize=4))
    else:
        results = [_build_one((f, wp, spec, grid, stats))
                   for f, wp in tasks]
    x = np.concatenate([r[0] for r in results])
    y = np.concatenate([r[1] for r in results])
    x[~np.isfinite(x)] = 0.0
    y[~np.isfinite(y)] = 0.0
    outputs = {}
    if save_npy:
        for name, arr in (("input", x), ("target", y)):
            p = os.path.join(save_path, f"{split}_{name}.npy")
            np.save(p, arr)
            outputs[name] = p
    if save_h5:
        import h5py

        for name, arr in (("input", x), ("target", y)):
            p = os.path.join(save_path, f"{split}_{name}.h5")
            with h5py.File(p, "w") as hf:
                hf.create_dataset("data", data=arr)
            outputs[name + "_h5"] = p
    return outputs


def index_to_latlontime(filelist, grid: Grid, input_abbrev="mli") -> dict:
    """Sample index -> ((lat, lon), date string) mapping
    (data_utils.save_as_npy save_latlontime_dict :935-944)."""
    dates = [re.sub(r"^.*" + input_abbrev + r"\.", "",
                    os.path.basename(f)).replace(".nc", "")
             for f in filelist]
    out = {}
    i = 0
    for d in dates:
        for c in range(grid.ncol):
            out[i] = [(float(grid.lat[c]), float(grid.lon[c])), d]
            i += 1
    return out
