"""The native shard loader (the counterpart of ``climsim_tpu.data.native``).

A C++ engine (``csrc/climload.cpp``, the port's copy of
``runtime/climload.cpp``, held byte-equal to it by the tests)
memory-maps float32 ``.npy`` shards, gathers shuffled batches with a
thread pool and keeps a ring of ready batches ahead of the consumer.
``NativeLoader`` binds it with ctypes and streams its batches to the
device through the same pinned ring and copy stream as the numpy loaders
(``pipeline._Streaming``).

The library is built at first use with ``g++`` and the flags of
``runtime/Makefile``, into ``data/_build/<key>/`` (listed in
``.gitignore``), where the key hashes the source and the flags; a build
or a load that fails raises.  ``make_loader`` never falls back to the
numpy ``BatchLoader`` by itself: only ``prefer_native=False`` asks for it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..parallel.mesh import BATCH
from .pipeline import BatchLoader, _process_split, _Streaming

SOURCE = Path(__file__).resolve().parent / "csrc" / "climload.cpp"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libclimload.so"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def build() -> Path:
    """Compile the library unless it is already built; return its path.
    Raises RuntimeError with the compiler's output if g++ fails or is
    missing."""
    path = library_path()
    if path.exists():
        return path
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{LIB_NAME}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             check=False)
    except FileNotFoundError as e:
        raise RuntimeError(f"cannot build the native loader: {e}") from e
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("g++ failed on the native loader:\n"
                           + " ".join(cmd) + "\n" + res.stdout + res.stderr)
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path


def load() -> ctypes.CDLL:
    """The library, built first where needed, its functions typed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        f32 = ctypes.POINTER(ctypes.c_float)
        i64 = ctypes.POINTER(ctypes.c_int64)
        lib.climload_open.restype = ctypes.c_void_p
        lib.climload_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
        lib.climload_dims.restype = None
        lib.climload_dims.argtypes = [ctypes.c_void_p, i64, i64, i64]
        lib.climload_gather.restype = None
        lib.climload_gather.argtypes = [ctypes.c_void_p, i64, ctypes.c_int,
                                        f32, f32]
        lib.climload_start_epoch.restype = None
        lib.climload_start_epoch.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int]
        lib.climload_next.restype = ctypes.c_int
        lib.climload_next.argtypes = [ctypes.c_void_p, f32, f32]
        lib.climload_close.restype = None
        lib.climload_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def _f32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeLoader(_Streaming):
    """Epochs of shuffled batches of an ``.npy`` shard pair (float32,
    C order, 2-D), gathered by the C++ engine's ``threads`` workers into
    its ``ring`` of batches, streamed to ``device``.  Epoch e shuffles
    with the engine's mt19937_64 seeded ``seed + e``, as the JAX loader
    does, so the two yield the same batches.

    Over several processes (``rules``) every rank's engine gathers the
    whole global batch (its permutation lives in the engine) and the rank
    stages only its contiguous 1/world_size of the rows, as the numpy
    loaders do."""

    def __init__(self, input_path: str, target_path: str, batch_size: int,
                 threads: int = 4, ring: int = 4, shuffle: bool = True,
                 seed: int = 0, rules=None, prefetch: int = 2,
                 device="cuda"):
        self.pidx, self.pcount = _process_split(rules, batch_size)
        if rules is not None:
            device = rules.device
        self._init_streaming(device, prefetch)
        lib = load()
        self._lib = lib
        self._h = lib.climload_open(str(input_path).encode(),
                                    str(target_path).encode())
        if not self._h:
            raise OSError(f"climload_open failed for {input_path} "
                          "(float32 C-order 2-D .npy required)")
        n, dx, dy = (ctypes.c_int64() for _ in range(3))
        lib.climload_dims(self._h, ctypes.byref(n), ctypes.byref(dx),
                          ctypes.byref(dy))
        self.num_samples = n.value
        self.dx, self.dy = dx.value, dy.value
        self.batch_size = batch_size
        self.threads = threads
        self.ring = ring
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0

    @property
    def steps_per_epoch(self) -> int:
        return self.num_samples // self.batch_size

    def gather(self, indices: np.ndarray):
        """Rows ``indices`` of both shards, gathered on the host by the
        engine's threads: (x, y) numpy float32."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self.num_samples):
            raise IndexError(f"indices outside [0, {self.num_samples})")
        x = np.empty((len(idx), self.dx), np.float32)
        y = np.empty((len(idx), self.dy), np.float32)
        self._lib.climload_gather(
            self._h, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), _f32(x), _f32(y))
        return x, y

    def _jobs(self):
        lib, h, b = self._lib, self._h, self.batch_size
        lib.climload_start_epoch(h, self.seed + self._epoch, b,
                                 self.threads, self.ring,
                                 1 if self.shuffle else 0)
        self._epoch += 1

        # the whole batch lands here first where it is split over ranks
        whole = ((np.empty((b, self.dx), np.float32),
                  np.empty((b, self.dy), np.float32))
                 if self.pcount > 1 else None)

        def fill(ox, oy):
            wx, wy = whole or (ox, oy)
            got = lib.climload_next(h, _f32(wx), _f32(wy))
            if got != b:
                raise RuntimeError(f"the native loader returned {got} rows "
                                   f"of a batch of {b}")
            if whole:
                ox[...] = BATCH.local(wx, self.pidx, self.pcount)
                oy[...] = BATCH.local(wy, self.pidx, self.pcount)

        per = b // self.pcount
        shapes = [(per, self.dx), (per, self.dy)]
        for _ in range(self.steps_per_epoch):
            yield shapes, (np.float32, np.float32), fill

    def close(self):
        if getattr(self, "_h", None):
            self._lib.climload_close(self._h)
            self._h = None

    def __del__(self):
        self.close()


def make_loader(input_path: str, target_path: str, batch_size: int,
                rules=None, shuffle: bool = True, seed: int = 0,
                prefer_native: bool = True, device="cuda", **kw):
    """``NativeLoader`` (built at first use; a failed build raises), or
    with ``prefer_native=False`` the numpy ``BatchLoader`` over the
    memory-mapped shards."""
    if prefer_native:
        return NativeLoader(input_path, target_path, batch_size,
                            shuffle=shuffle, seed=seed, rules=rules,
                            device=device, **kw)
    x = np.load(input_path, mmap_mode="r")
    y = np.load(target_path, mmap_mode="r")
    return BatchLoader(x, y, batch_size, rules, shuffle, seed, device=device,
                       **kw)
