"""Build the CUDA kernels of ``ops/csrc`` and load them with ctypes.

``nvcc`` compiles every ``csrc/*.cu`` for Hopper (``sm_90a``), one
process a source, all started together, and links the objects into one
shared library with a plain C interface: no PyTorch headers, so the build
takes seconds.  It runs at first use, into ``ops/_build/<key>/`` (listed in
``.gitignore``), where the key hashes the sources and the flags, so a
checkout builds once and an edited source builds anew.  The compiler's
output, register and shared-memory counts included (``-Xptxas -v``), is
kept beside the library as ``build.log``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libclimsim_kernels.so"

# No --use_fast_math: it lets the compiler fold isfinite away and swaps
# expf for __expf, which breaks fused_input_transform's contract.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PP = ctypes.POINTER(ctypes.c_void_p)  # an array of device pointers
_SIGNATURES = {
    "cst_error_string": ([_I], ctypes.c_char_p),
    # x, consts, out, rows, d, stream
    "cst_fused_input_transform": ([_P, _P, _P, _I, _I, _P], _I),
    # x, w, bias, out, widths, n_layers, rows, relu_tail, tile_rows, stream
    "cst_fused_mlp_forward_f32": (
        [_P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I, _I, _P], _I),
    # x, w, bias, out, act, widths, n_layers, rows, relu_tail, nwg, nb,
    # cluster, stages, passes, stream
    "cst_fused_mlp_forward_bf16": (
        [_P, _P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I, _I,
         _I, _P], _I),
    # x, q, scale, bias, out, act, widths, n_layers, rows, relu_tail, nwg,
    # nb, cluster, stages, stream
    "cst_fused_mlp_forward_int8": (
        [_P, _P, _P, _P, _P, _P, ctypes.POINTER(_I), _I, _I, _I, _I, _I, _I,
         _I, _P], _I),
    # nwg, nb, cluster, smem
    "cst_mlp_forward_clusters_bf16": ([_I, _I, _I, _I], _I),
    "cst_mlp_forward_clusters_int8": ([_I, _I, _I, _I], _I),
    # int8, nwg, nb, stages
    "cst_mlp_forward_smem": ([_I, _I, _I, _I], _I),
    # y, t, qc, qi, consts, out, rows, dt, stream
    "cst_fused_constraint_head": (
        [_P, _P, _P, _P, _P, _P, _I, _F, _P], _I),
    # x, gamma, beta, w, bias, out, batch, L, C, Cout, G, eps, nwg, nt,
    # stages, samples, stream
    "cst_fused_gn_silu_conv3": (
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _I, _I, _P],
        _I),
    # x, w[], b[], out, widths, n_layers, rows, tile_rows, stream
    "cst_fused_mlp_train_fwd": (
        [_P, _PP, _PP, _P, ctypes.POINTER(_I), _I, _I, _I, _P], _I),
    # x, dy, w[], b[], dw[], db[], widths, n_layers, rows, tile_b,
    # tile_rows, h, dh, partial, stream
    "cst_fused_mlp_train_bwd": (
        [_P, _P, _PP, _PP, _PP, _PP, ctypes.POINTER(_I), _I, _I, _I, _I, _P,
         _P, _P, _P], _I),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def _nvcc() -> str:
    # the toolkit torch itself would build with: $CUDA_HOME, nvcc on PATH,
    # or the toolkit's default install location
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found: set CUDA_HOME or put nvcc "
                           "on PATH")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def build() -> Path:
    """Compile the library unless it is already built; return its path."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = [s for s in _sources() if s.suffix == ".cu"]
    objs = [path.with_name(f"{s.stem}.{tag}.o") for s in srcs]
    cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)]
            for s, o in zip(srcs, objs)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    log = [" ".join(c) + "\n" + o for c, o in zip(cmds, outs)]
    failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
    tmp = path.with_name(f"{LIB_NAME}.{tag}")
    if not failed:
        link = [_nvcc(), "-shared", *NVCC_FLAGS[:2], "-o", str(tmp),
                *map(str, objs)]
        res = subprocess.run(link, capture_output=True, text=True,
                             check=False)
        log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            failed.append("link")
    for o in objs:
        o.unlink(missing_ok=True)
    (path.parent / "build.log").write_text("".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "".join(log))
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def build_log() -> str:
    """The compiler output of the current build ('' before the build)."""
    log = library_path().parent / "build.log"
    return log.read_text() if log.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _lib = lib
    return _lib


def check(code: int, what: str) -> None:
    """Raise if a kernel entry returned a CUDA error."""
    if code != 0:
        msg = load().cst_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
