"""The serving path's kernels, each beside its plain PyTorch version.

Four hand-written CUDA kernels (sources in ``ops/csrc``, built by
``ops/_build.py``) replace the Pallas kernels of ``climsim_tpu.ops.kernels``
that the coupling sidecar runs:

  * ``fused_input_transform``  -- cloud exponential rate, normalize,
    nan/inf -> 0, prune mask, clip: one pass over the raw columns
  * ``fused_mlp_forward``      -- the whole relu MLP in one launch, f32 or
    bf16 weights, float32 activations
  * ``fused_mlp_forward_int8`` -- the same with weight-only int8 weights,
    bf16-rounded activations
  * ``fused_constraint_head``  -- the U-Net v5 wrapper's postprocess:
    stratosphere zeroing, un-scaling, cloud repartition, the 368 contract

The U-Net's GroupNorm -> silu -> conv3 kernel is in ``ops/unet_fused.py``,
the counterpart module of ``climsim_tpu.ops.unet_fused``, and the fused
MLP-training kernel's pack, forward and backward are in
``ops/fused_mlp_train.py`` (its forward is the tensor-core kernel of kernel
2 below); they count their launches here too.

Each public function checks its arguments, then takes the plain version
for a tensor on the CPU and launches its kernel for a tensor on a CUDA
device; there is no fallback from the kernel to the plain version.  Each
launch adds one to ``LAUNCHES[<name>]``, so a run can show that it went
through the kernels.  The ``*_plain`` functions hold the same math in
PyTorch: the CPU path, and the reference the kernels are checked against
on the card.  Kernels 1 and 4 carry a gradient where one is wanted: their
backward is autograd of the plain version (``_InputTransformGrad``,
``_ConstraintHeadGrad``).

No lane padding: the kernels mask their own ragged edges.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .. import physics
from ..utils.profiling import profiler_range
from ..varspec import NUM_LEVELS
from . import _build

LAUNCHES = {"fused_input_transform": 0, "fused_mlp_forward": 0,
            "fused_mlp_forward_int8": 0, "fused_constraint_head": 0,
            "fused_gn_silu_conv3": 0, "fused_gn_silu_conv3_bwd": 0,
            "fused_mlp_train_pack": 0,
            "fused_mlp_train_fwd": 0, "fused_mlp_train_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device,
           contiguous: bool = True) -> None:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` (None matches
    any size) on ``device``, and contiguous unless told otherwise."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: want a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    got = t.shape
    if len(got) != len(shape):
        raise ValueError(f"{name}: want shape {shape}, got {tuple(got)}")
    for g, want in zip(got, shape):
        if want is not None and g != want:
            raise ValueError(f"{name}: want shape {shape}, got {tuple(got)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raise for any other device."""
    if x.is_cuda:
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for {x.device}")


def _launch_on(device: torch.device, entry, *args) -> int:
    """``entry(*args, stream)``, a library entry called with the raw handle
    of ``device``'s current stream, with ``device`` the current device
    during the call: switched to, and back, only where another device is
    current.  The device and stream are read by the C calls PyTorch's own
    ``current_device`` and Triton's launcher make (no lazy-init check and
    no Stream object a call).  Returns the entry's CUDA error code."""
    idx = device.index
    if torch._C._cuda_getDevice() == idx:
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return entry(*args, torch._C._cuda_getCurrentRawStream(idx))


@functools.lru_cache(maxsize=None)
def _device_limits(index: int) -> tuple[int, int, int]:
    """(shared memory a block can opt in to, SMs, L2 bytes) of CUDA device
    ``index``, read once."""
    props = torch.cuda.get_device_properties(index)
    return (props.shared_memory_per_block_optin, props.multi_processor_count,
            props.L2_cache_size)


def _ctas_an_sm(smem: int, smem_limit: int) -> int:
    """CTAs of ``smem`` bytes of dynamic shared memory that fit an SM (at
    most two), where an SM holds ``smem_limit`` (the block limit) + 1 KB
    and every CTA reserves 1 KB of it (an H100: 228 KB an SM, 227 a
    block)."""
    return max(1, min(2, (smem_limit + 1024) // (smem + 1024)))


# --------------------------------------------------------------------------
# fused input transform
# --------------------------------------------------------------------------
TRANSFORM_ROWS = ("sub", "divinv", "mask", "lo", "hi", "lbd", "is_cloud")
# The plan of csrc/fused_input_transform.cu: a CTA of up to
# TRANSFORM_THREADS threads, each owning up to TRANSFORM_MAX_COLS columns;
# tiles of whole rows, a multiple of 4 (16-byte tiles at any width), about
# TRANSFORM_TILE_BYTES each; up to TRANSFORM_STAGES input tiles in flight a
# CTA and two output tiles.
TRANSFORM_THREADS = 512
TRANSFORM_MAX_COLS = 3
TRANSFORM_MAX_WIDTH = TRANSFORM_THREADS * TRANSFORM_MAX_COLS
TRANSFORM_TILE_BYTES = 16384
TRANSFORM_STAGES = 4
TRANSFORM_ROW_THREADS = 256   # fewer threads a row than this: row phases
TRANSFORM_DIRECT_CTAS = 8     # direct: CTAs an SM the tiles aim at,
TRANSFORM_DIRECT_ROWS = 8     # and rows a thread at most


@dataclass(frozen=True)
class TransformPlan:
    """How kernel 1 tiles one (rows, d) call."""
    rows: int           # rows a tile (pipelined: a multiple of 4)
    stages: int         # input tiles in flight a CTA
    grid: int           # CTAs: CTA i takes tiles i, i + grid, ... (direct:
                        # a tile a CTA, times col_blocks)
    threads: int        # threads a CTA
    row_threads: int    # threads a row phase (threads // row_threads phases)
    cols: int           # columns a thread: j, j + row_threads, ...
    tiles: int
    direct: bool        # ordinary loads and stores, a tile a CTA
    smem: int           # dynamic shared memory a CTA, bytes (0 if direct)
    col_blocks: int = 1  # direct: CTAs a tile, row_threads columns each

    def args(self, batch: int, d: int) -> ctypes.Array:
        """The kernel's plan argument (csrc/fused_input_transform.cu
        Plan)."""
        return (ctypes.c_int * 12)(
            batch, d, self.rows, self.stages, self.grid, self.threads,
            self.row_threads, self.cols, self.smem, int(self.direct),
            self.tiles, self.threads // self.row_threads)


def _transform_smem(rows: int, d: int, stages: int) -> int:
    """``stages`` input tiles and two output tiles of rows x d float32,
    then a barrier a stage."""
    return (stages + 2) * rows * d * 4 + 8 * stages


def _check_transform_width(d: int) -> None:
    if not 1 <= d <= TRANSFORM_MAX_WIDTH:
        raise ValueError(f"a width of {d}: the input transform kernel takes "
                         f"1..{TRANSFORM_MAX_WIDTH} columns "
                         f"({TRANSFORM_MAX_COLS} a thread of "
                         f"{TRANSFORM_THREADS})")


@functools.lru_cache(maxsize=4096)
def plan_input_transform(rows: int, d: int, smem_limit: int, n_sm: int,
                         l2_bytes: int, tile_rows: int | None = None,
                         direct: bool | None = None) -> TransformPlan:
    """Kernel 1's plan for x (rows, d) on a card with ``smem_limit`` bytes
    of shared memory a block, ``n_sm`` SMs and ``l2_bytes`` of L2; raises
    ValueError, with the reason, for a width it cannot take (none at a
    width it takes at some other batch: the smallest tile and two stages
    decide).

    Direct (ordinary loads and stores) where x fits half the L2: its
    callers hand it rows they have just written, which L2 still holds, and
    there the pipeline only adds the copy engine's round trips
    (``bench_io_kernels --sweep`` on an H100).  Then one column a thread,
    a tile's columns over ``col_blocks`` CTAs, a tile a CTA, and rows a
    tile the fewest that keep the CTAs within TRANSFORM_DIRECT_CTAS an SM,
    but no more than TRANSFORM_DIRECT_ROWS a thread.  Else pipelined: rows
    a tile the most (a multiple of 4) within TRANSFORM_TILE_BYTES, at
    least 4, and no more than spreads the batch over every SM; stages the
    most, up to TRANSFORM_STAGES, that let two CTAs share an SM, else one;
    as many CTAs as the SMs hold, no more than tiles.  ``tile_rows`` and
    ``direct`` replace the rules' choices (the benchmark's sweep)."""
    _check_transform_width(d)
    if rows < 1:
        raise ValueError(f"rows {rows}: want at least 1")
    cols = -(-d // TRANSFORM_THREADS)
    row_threads = -(-d // (32 * cols)) * 32
    threads = row_threads * max(1, TRANSFORM_ROW_THREADS // row_threads)
    r = max(4, TRANSFORM_TILE_BYTES // (4 * d) // 4 * 4)
    r = min(r, max(4, -(-rows // (4 * n_sm)) * 4))
    if direct is False and tile_rows:
        r = tile_rows
    if r % 4:
        raise ValueError(f"tile_rows {r}: a pipelined tile takes a multiple "
                         "of 4 rows")
    stages = None
    for per_sm in (2, 1):
        fits = [s for s in range(2, TRANSFORM_STAGES + 1)
                if _transform_smem(r, d, s) <= smem_limit
                and _ctas_an_sm(_transform_smem(r, d, s), smem_limit)
                >= per_sm]
        if fits:
            stages = fits[-1]
            break
    if stages is None:
        raise ValueError(f"a width of {d} needs {_transform_smem(r, d, 2)} B "
                         f"of shared memory; the card has {smem_limit}")
    if direct is None:
        direct = 4 * rows * d <= l2_bytes // 2      # x, as read
    col_blocks = 1
    if direct:
        cols = 1
        col_blocks = -(-d // TRANSFORM_ROW_THREADS)
        row_threads = -(-d // (32 * col_blocks)) * 32   # blocks of one size
        phases = max(1, TRANSFORM_ROW_THREADS // row_threads)
        threads = row_threads * phases
        r = tile_rows or phases * min(
            TRANSFORM_DIRECT_ROWS,
            -(-rows * col_blocks // (TRANSFORM_DIRECT_CTAS * n_sm * phases)))
    tiles = -(-rows // r)
    return TransformPlan(r, stages, tiles if direct else min(tiles,
                                                             per_sm * n_sm),
                         threads, row_threads, cols, tiles, direct,
                         0 if direct else _transform_smem(r, d, stages),
                         col_blocks)


@functools.lru_cache(maxsize=4096)
def _transform_args(rows: int, d: int, index: int) -> ctypes.Array:
    """The plan argument of a (rows, d) call on CUDA device ``index``,
    built once."""
    return plan_input_transform(rows, d, *_device_limits(index)).args(rows,
                                                                       d)


def check_input_transform(d: int, device) -> None:
    """Raise, with the reason, where kernel 1 cannot take a width of ``d``:
    past TRANSFORM_MAX_WIDTH on any device, and on a CUDA device where the
    card's shared memory has no plan; so that a transform finds out when
    it is built, not at a request."""
    _check_transform_width(d)
    device = torch.device(device)
    if device.type == "cuda":
        limits = _device_limits(torch.cuda.current_device()
                                if device.index is None else device.index)
        for rows in (1, 65536):
            plan_input_transform(rows, d, *limits, direct=False)


def transform_consts(*, sub, divinv, mask, lo, hi, lbd, is_cloud,
                     device, dtype=torch.float32) -> torch.Tensor:
    """Stack the seven (D,) constant vectors in the kernel's row order into
    one (7, D) tensor on ``device``: float32 for the kernel, float64 for
    the plain version's oracle-parity path."""
    rows = [np.asarray(v, np.float64)
            for v in (sub, divinv, mask, lo, hi, lbd, is_cloud)]
    return torch.as_tensor(np.stack(rows), dtype=dtype, device=device)


def fused_input_transform_plain(x: torch.Tensor,
                                consts: torch.Tensor) -> torch.Tensor:
    sub, divinv, mask, lo, hi, lbd, is_cloud = consts
    x = torch.where(is_cloud > 0.5, 1.0 - torch.exp(-x * lbd), x)
    x = (x - sub) * divinv
    x = torch.where(torch.isfinite(x), x, torch.zeros_like(x))
    x = x * mask
    return physics.clip(x, lo, hi)   # jnp.clip's tie gradient


def fused_input_transform(x: torch.Tensor,
                          consts: torch.Tensor) -> torch.Tensor:
    """Raw (B, D) float32 -> normalized (B, D) float32; ``consts`` from
    ``transform_consts``.  ``x`` may start anywhere (a view such as x[1:])."""
    dev = consts.device if isinstance(consts, torch.Tensor) else None
    if not (type(x) is torch.Tensor and type(consts) is torch.Tensor
            and x.dtype == consts.dtype == torch.float32
            and x.dim() == consts.dim() == 2
            and consts.shape[0] == len(TRANSFORM_ROWS)
            and x.shape[1] == consts.shape[1] and x.device == dev
            and x.is_contiguous() and consts.is_contiguous()):
        # not the common case at a glance: the checks, one by one
        _check(consts, "consts", torch.float32, (len(TRANSFORM_ROWS), None),
               dev)
        _check(x, "x", torch.float32, (None, consts.shape[1]), dev)
    if torch.compiler.is_compiling():
        return _input_transform_op(x, consts)
    if not (x.is_cuda or _on_cuda(x, "fused_input_transform")):
        return fused_input_transform_plain(x, consts)
    if x.requires_grad and torch.is_grad_enabled():
        return _InputTransformGrad.apply(x, consts)
    return _transform_launch(x, consts, dev)


def _transform_launch(x: torch.Tensor, consts: torch.Tensor,
                      dev: torch.device) -> torch.Tensor:
    """Kernel 1 on checked CUDA tensors: a fresh output, no autograd."""
    rows, d = x.shape
    out = torch.empty_like(x)   # x is contiguous: so is out
    if rows:
        idx = dev.index
        fn = (_build._lib or _build.load()).cst_fused_input_transform
        args = (x.data_ptr(), consts.data_ptr(), out.data_ptr(),
                _transform_args(rows, d, idx))
        # _launch_on's common case, written out: this runs once a request
        with profiler_range("fused_input_transform"):
            code = (fn(*args, torch._C._cuda_getCurrentRawStream(idx))
                    if torch._C._cuda_getDevice() == idx
                    else _launch_on(dev, fn, *args))
        if code:
            _build.check(code, "fused_input_transform")
        LAUNCHES["fused_input_transform"] += 1
    return out


def _launch_transform(x: torch.Tensor, consts: torch.Tensor,
                      plan: TransformPlan) -> torch.Tensor:
    """Kernel 1 on checked CUDA tensors, tiled by ``plan`` (the benchmark's
    sweep)."""
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    code = _launch_on(x.device, _build.load().cst_fused_input_transform,
                      x.data_ptr(), consts.data_ptr(), out.data_ptr(),
                      plan.args(*x.shape))
    _build.check(code, "fused_input_transform")
    return out


# --------------------------------------------------------------------------
# fused constraint head (the U-Net v5 wrapper's postprocess)
# --------------------------------------------------------------------------
V5_OUT = 308        # t, q1, qn, u, v (60 each), 8 scalars
CONTRACT_OUT = 368  # t, q1, qc, qi, u, v (60 each), 8 scalars
# The plan of csrc/fused_constraint_head.cu: 256 column threads and one
# thread a (row, level) of a tile of up to HEAD_MAX_ROWS rows (at most
# HEAD_TILE_ROWS pipelined, HEAD_DIRECT_ROWS direct), up to HEAD_STAGES y
# tiles in flight a CTA.
HEAD_MAX_ROWS = 12
HEAD_TILE_ROWS = 8
HEAD_DIRECT_ROWS = 4
HEAD_STAGES = 4
HEAD_COL_THREADS = 256


@dataclass(frozen=True)
class HeadPlan:
    """How kernel 4 tiles one call."""
    rows: int           # rows a tile
    stages: int         # y tiles in flight a CTA
    grid: int           # CTAs: CTA i takes tiles i, i + grid, ...
    threads: int
    tiles: int
    direct: bool        # ordinary loads and stores, a tile a CTA
    smem: int           # dynamic shared memory a CTA, bytes (0 if direct)

    def args(self, batch: int, lds) -> ctypes.Array:
        """The kernel's geometry argument: the batch, t, qc and qi's row
        strides, the plan (csrc/fused_constraint_head.cu)."""
        return (ctypes.c_longlong * 11)(
            batch, *lds, self.rows, self.stages, self.grid, self.threads,
            self.smem, int(self.direct), self.tiles)


def _head_smem(rows: int, stages: int) -> int:
    """``stages`` y tiles (rows x 308), two output tiles (rows x 368),
    float32, then a barrier a stage."""
    return 4 * rows * (stages * V5_OUT + 2 * CONTRACT_OUT) + 8 * stages


@functools.lru_cache(maxsize=4096)
def plan_constraint_head(rows: int, smem_limit: int, n_sm: int,
                         l2_bytes: int, tile_rows: int | None = None,
                         direct: bool | None = None) -> HeadPlan:
    """Kernel 4's plan for ``rows`` rows, as kernel 1's: direct where its
    inputs (y, t, qc, qi) fit half the L2 (the model's output and the raw
    row were just written), a tile a CTA of the fewest rows that spread
    the batch over two CTAs an SM, at most HEAD_DIRECT_ROWS; else
    pipelined, tiles of HEAD_TILE_ROWS rows or fewer where that spreads
    the batch over every SM, the most stages, up to HEAD_STAGES, that let
    two CTAs share an SM, as many CTAs as the SMs hold, no more than
    tiles.  ``tile_rows`` and ``direct`` replace the rules' choices (the
    benchmark's sweep)."""
    if rows < 1:
        raise ValueError(f"rows {rows}: want at least 1")
    if direct is None:
        direct = 4 * rows * (V5_OUT + 3 * NUM_LEVELS) <= l2_bytes // 2
    r = tile_rows or (min(HEAD_DIRECT_ROWS, -(-rows // (2 * n_sm)))
                      if direct else min(HEAD_TILE_ROWS, -(-rows // n_sm)))
    if not 1 <= r <= HEAD_MAX_ROWS:
        raise ValueError(f"tile_rows {r}: want 1..{HEAD_MAX_ROWS}")
    threads = HEAD_COL_THREADS + -(-r * NUM_LEVELS // 32) * 32
    fits = [s for s in range(2, HEAD_STAGES + 1)
            if _head_smem(r, s) <= smem_limit]
    if not fits:
        raise ValueError(f"the constraint head needs {_head_smem(r, 2)} B "
                         f"of shared memory; the card has {smem_limit}")
    two = [s for s in fits if _ctas_an_sm(_head_smem(r, s), smem_limit) > 1]
    stages = (two or fits)[-1]
    per_sm = min(_ctas_an_sm(_head_smem(r, stages), smem_limit),
                 2048 // threads)
    tiles = -(-rows // r)
    return HeadPlan(r, stages, tiles if direct else min(tiles, per_sm * n_sm),
                    threads, tiles, direct,
                    0 if direct else _head_smem(r, stages))


@functools.lru_cache(maxsize=4096)
def _head_out(rows: int, device: torch.device) -> torch.Tensor:
    """A (rows, 368) float32 view with stride 0 of one element on
    ``device``, kept: ``torch.empty_like`` of it is a fresh contiguous
    output (its input overlaps itself), allocated faster than by
    ``torch.empty`` with a shape, a dtype and a device to parse."""
    return torch.empty(1, dtype=torch.float32, device=device).expand(
        rows, CONTRACT_OUT)


@functools.lru_cache(maxsize=4096)
def _head_args(rows: int, lds: tuple, index: int) -> ctypes.Array:
    """The geometry argument of a call on CUDA device ``index``, built
    once."""
    return plan_constraint_head(rows, *_device_limits(index)).args(rows, lds)


def constraint_head_consts(out_scale, strato_lev_out: int,
                           dtype=torch.float32, device="cuda") -> torch.Tensor:
    """The (2, 308) rows of the head: the stratosphere mask (the top
    ``strato_lev_out`` levels of q1, qn, u and v zeroed) and 1 / out_scale
    (divided in float64, then rounded, as the reference wrapper does)."""
    mask = np.ones(V5_OUT)
    for start in (60, 120, 180, 240):   # q1, qn, u, v
        mask[start:start + strato_lev_out] = 0.0
    rows = np.stack([mask, 1.0 / np.asarray(out_scale, np.float64)])
    return torch.as_tensor(rows, dtype=dtype, device=device)


def fused_constraint_head_plain(y_norm, t, qc, qi, consts,
                                dt: float) -> torch.Tensor:
    """The XLA chain of climsim_tpu/online/wrapper.py:112-125."""
    mask, scaleinv = consts
    y = y_norm * mask * scaleinv
    dqc, dqi = physics.repartition_clouds(
        t, qc, qi, y[:, 0:NUM_LEVELS], y[:, 2 * NUM_LEVELS:3 * NUM_LEVELS],
        dt)
    return torch.cat([y[:, :2 * NUM_LEVELS], dqc, dqi, y[:, 3 * NUM_LEVELS:]],
                     dim=1)


def _level_strides(rows: int, dev, named) -> tuple:
    """Check t, qc and qi ((rows, 60) float32 on ``dev``, a unit column
    stride, a row stride of at least 60) and return their row strides (60
    for a single row, whose stride is never read)."""
    lds = ()
    for name, a in named:
        if not (type(a) is torch.Tensor and a.dtype == torch.float32
                and a.shape == (rows, NUM_LEVELS) and a.device == dev):
            _check(a, name, torch.float32, (rows, NUM_LEVELS), dev,
                   contiguous=False)
        ld, unit = a.stride()
        if unit != 1 or (rows > 1 and ld < NUM_LEVELS):
            raise ValueError(f"{name}: want a unit column stride and a row "
                             f"stride of at least {NUM_LEVELS}, got strides "
                             f"{a.stride()}")
        lds += (ld if rows > 1 else NUM_LEVELS,)
    return lds


def fused_constraint_head(y_norm: torch.Tensor, t: torch.Tensor,
                          qc: torch.Tensor, qi: torch.Tensor,
                          consts: torch.Tensor, dt: float) -> torch.Tensor:
    """Normalized v5 output (B, 308) and t, qc, qi before the step (B, 60),
    all float32 -> the raw (B, 368) coupling contract; ``consts`` from
    ``constraint_head_consts``, ``dt`` the coupling step in seconds.

    t, qc and qi may be views with any row stride of at least 60 (slices of
    the raw v4 row, which the kernel reads in place), but a unit column
    stride; y_norm and consts contiguous."""
    dev = consts.device if isinstance(consts, torch.Tensor) else None
    if not (type(y_norm) is torch.Tensor and type(consts) is torch.Tensor
            and y_norm.dtype == consts.dtype == torch.float32
            and consts.shape == (2, V5_OUT) and y_norm.dim() == 2
            and y_norm.shape[1] == V5_OUT and y_norm.device == dev
            and y_norm.is_contiguous() and consts.is_contiguous()):
        # not the common case at a glance: the checks, one by one
        _check(consts, "consts", torch.float32, (2, V5_OUT), dev)
        _check(y_norm, "y_norm", torch.float32, (None, V5_OUT), dev)
    rows = y_norm.shape[0]
    shape = (rows, NUM_LEVELS)
    if (type(t) is torch.Tensor and type(qc) is torch.Tensor
            and type(qi) is torch.Tensor
            and t.dtype == qc.dtype == qi.dtype == torch.float32
            and t.shape == shape and qc.shape == shape and qi.shape == shape
            and t.device == dev and qc.device == dev and qi.device == dev):
        # the common case at a glance; the strides as _level_strides has
        # them
        (lt, ut), (lc, uc), (li, ui) = t.stride(), qc.stride(), qi.stride()
        lds = ((lt, lc, li) if rows > 1 and min(lt, lc, li) >= NUM_LEVELS
               and ut == uc == ui == 1 else
               _level_strides(rows, dev, (("t", t), ("qc", qc), ("qi", qi))))
    else:
        lds = _level_strides(rows, dev, (("t", t), ("qc", qc), ("qi", qi)))
    if not dt > 0:
        raise ValueError(f"dt {dt}: want a positive step")
    if torch.compiler.is_compiling():
        return _constraint_head_op(y_norm, t, qc, qi, consts, dt)
    if not (y_norm.is_cuda or _on_cuda(y_norm, "fused_constraint_head")):
        return fused_constraint_head_plain(y_norm, t, qc, qi, consts, dt)
    if torch.is_grad_enabled() and (y_norm.requires_grad or t.requires_grad
                                    or qc.requires_grad or qi.requires_grad):
        return _ConstraintHeadGrad.apply(y_norm, t, qc, qi, consts, dt, lds)
    return _head_launch(y_norm, t, qc, qi, consts, dt, lds, dev)


def _head_launch(y_norm, t, qc, qi, consts, dt: float, lds: tuple,
                 dev: torch.device) -> torch.Tensor:
    """Kernel 4 on checked CUDA tensors (t, qc, qi of row strides
    ``lds``): a fresh output, no autograd."""
    rows = y_norm.shape[0]
    out = torch.empty_like(_head_out(rows, dev))
    if rows:
        idx = dev.index
        fn = (_build._lib or _build.load()).cst_fused_constraint_head
        args = (y_norm.data_ptr(), t.data_ptr(), qc.data_ptr(),
                qi.data_ptr(), consts.data_ptr(), out.data_ptr(),
                _head_args(rows, lds, idx), dt)
        # _launch_on's common case, written out: this runs once a request
        with profiler_range("fused_constraint_head"):
            code = (fn(*args, torch._C._cuda_getCurrentRawStream(idx))
                    if torch._C._cuda_getDevice() == idx
                    else _launch_on(dev, fn, *args))
        if code:
            _build.check(code, "fused_constraint_head")
        LAUNCHES["fused_constraint_head"] += 1
    return out


def _launch_head(y_norm, t, qc, qi, consts, dt: float,
                 plan: HeadPlan) -> torch.Tensor:
    """Kernel 4 on checked CUDA tensors, tiled by ``plan`` (the benchmark's
    sweep)."""
    rows = y_norm.shape[0]
    out = torch.empty((rows, CONTRACT_OUT), dtype=torch.float32,
                      device=y_norm.device)
    lds = _level_strides(rows, y_norm.device,
                         (("t", t), ("qc", qc), ("qi", qi)))
    code = _launch_on(y_norm.device, _build.load().cst_fused_constraint_head,
                      y_norm.data_ptr(), t.data_ptr(), qc.data_ptr(),
                      qi.data_ptr(), consts.data_ptr(), out.data_ptr(),
                      plan.args(rows, lds), dt)
    _build.check(code, "fused_constraint_head")
    return out


# --------------------------------------------------------------------------
# kernels 1 and 4 under autograd
# --------------------------------------------------------------------------
# A launch writes into a fresh tensor through ctypes, which autograd cannot
# see: its output has no grad_fn.  Where a gradient is wanted (an input
# requires grad and grad mode is on: a differentiated rollout,
# train/rollout_ft.py), the public functions launch through these
# Functions instead.  The forward is the kernel; the backward is autograd
# of the plain version at the saved inputs (the pattern of 5',
# ops/unet_fused.py), so the gradient is exactly the plain chain's at the
# same inputs.  The JAX kernels have no VJP either: the JAX wrapper
# differentiates its XLA chain (climsim_tpu/online/wrapper.py:97-124).
# The served path needs no gradient and keeps its direct launch.
class _InputTransformGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, consts):
        ctx.save_for_backward(x, consts)
        return _transform_launch(x, consts, consts.device)

    @staticmethod
    def backward(ctx, g):
        x, consts = ctx.saved_tensors
        with torch.enable_grad():
            x = x.detach().requires_grad_()
            (dx,) = torch.autograd.grad(
                fused_input_transform_plain(x, consts), x, g)
        return dx, None


class _ConstraintHeadGrad(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y_norm, t, qc, qi, consts, dt, lds):
        ctx.save_for_backward(y_norm, t, qc, qi, consts)
        ctx.dt = dt
        return _head_launch(y_norm, t, qc, qi, consts, dt, lds,
                            consts.device)

    @staticmethod
    def backward(ctx, g):
        *ins, consts = ctx.saved_tensors
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            ins = [a.detach().requires_grad_(n) for a, n in zip(ins, need)]
            want = [a for a in ins if a.requires_grad]
            grads = iter(torch.autograd.grad(
                fused_constraint_head_plain(*ins, consts, ctx.dt), want, g))
        return (*(next(grads) if n else None for n in need), None, None,
                None)


# --------------------------------------------------------------------------
# kernels 1 and 4 as operators of torch.library, for torch.export
# --------------------------------------------------------------------------
# A traced program (online.wrapper.export_aot) cannot hold a ctypes launch:
# while torch.export traces, each public function above calls its operator
# instead, which the graph keeps as one node.  The operator's
# implementation is the public function itself, so a loaded program runs
# the kernel for a CUDA tensor and the plain version for a CPU tensor, as
# the live path does.  The live path never goes through the operator.
# The namespace is the package's own name (climsim_tpu_torch), so that a
# second copy of the port imported under another name registers its own.
OPS_NAMESPACE = __name__.split(".")[0]


@torch.library.custom_op(f"{OPS_NAMESPACE}::fused_input_transform",
                         mutates_args=())
def _input_transform_op(x: torch.Tensor,
                        consts: torch.Tensor) -> torch.Tensor:
    # a program's strides at run time need not be the traced ones
    return fused_input_transform(x.contiguous(), consts)


@_input_transform_op.register_fake
def _(x, consts):
    return torch.empty_like(x)


@torch.library.custom_op(f"{OPS_NAMESPACE}::fused_constraint_head",
                         mutates_args=())
def _constraint_head_op(y_norm: torch.Tensor, t: torch.Tensor,
                        qc: torch.Tensor, qi: torch.Tensor,
                        consts: torch.Tensor, dt: float) -> torch.Tensor:
    return fused_constraint_head(y_norm.contiguous(), t, qc, qi, consts, dt)


@_constraint_head_op.register_fake
def _(y_norm, t, qc, qi, consts, dt):
    return y_norm.new_empty((y_norm.shape[0], CONTRACT_OUT))


# --------------------------------------------------------------------------
# fused MLP forward
# --------------------------------------------------------------------------
def _host_f32(a) -> torch.Tensor:
    """A numpy array or tensor as a contiguous float32 CPU tensor."""
    return torch.as_tensor(a).detach().to(
        device="cpu", dtype=torch.float32).contiguous()


MAX_LAYERS = 16  # kMaxLayers in csrc/common.cuh
CHUNK = 64       # the wgmma kernel's K chunk and output column slice


def _padded(width: int) -> int:
    return -(-width // CHUNK) * CHUNK


@dataclass(frozen=True)
class PackedMLP:
    """A relu MLP's parameters in the layout of the fused-MLP kernels.

    ``widths`` is (d_in, h_1, ..., d_out).  float32 weights (the FMA
    kernel): ``w`` holds every layer's (d_in, d_out) row-major weights, one
    layer after the other, and ``b`` every layer's bias.  bf16 and int8
    weights (the tensor-core kernel, ``csrc/mlp_forward_wgmma.cuh``): ``w``
    stacks every layer's weights, each zero-padded to (Kp, Np) = (d_in,
    d_out) rounded up to CHUNK, in one (sum Kp, max Np) matrix, and ``b``
    and ``scale`` (int8: per output channel, float32) hold every layer's
    Np values, zero past d_out; so no weight box the kernel reads has a
    ragged edge.  ``layers()`` yields the unpadded views of either.
    """

    widths: tuple[int, ...]
    w: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor | None = None

    @property
    def padded(self) -> bool:
        """Whether the buffers are the tensor-core kernel's padded layout."""
        return self.w.dtype != torch.float32

    def __post_init__(self):
        if self.padded:
            kp = [_padded(d) for d in self.widths]
            w_ok = tuple(self.w.shape) == (sum(kp[:-1]), max(kp[1:]))
            n_b = sum(kp[1:])
        else:
            w_ok = self.w.numel() == sum(
                i * o for i, o in zip(self.widths[:-1], self.widths[1:]))
            n_b = sum(self.widths[1:])
        if (not w_ok or self.b.numel() != n_b
                or (self.scale is not None and self.scale.numel() != n_b)):
            raise ValueError(f"buffers do not match widths {self.widths}")

    def layers(self):
        """Yield (w (d_in, d_out), b, scale or None) views per layer."""
        ro = bo = 0
        for din, dout in zip(self.widths[:-1], self.widths[1:]):
            s = None if self.scale is None else self.scale[bo:bo + dout]
            if self.padded:
                yield self.w[ro:ro + din, :dout], self.b[bo:bo + dout], s
                ro, bo = ro + _padded(din), bo + _padded(dout)
            else:
                yield (self.w[ro:ro + din * dout].view(din, dout),
                       self.b[bo:bo + dout], s)
                ro, bo = ro + din * dout, bo + dout


def pack_layers(layers, device=None) -> PackedMLP:
    """A PackedMLP of (w (d_in, d_out), b, scale or None) triples that chain,
    such as another pack's ``layers()``, taken as they are: float32, bf16
    or int8 weights, no rounding and no quantization.  ``device``: that of
    the first weight if None."""
    layers = list(layers)
    w0 = layers[0][0]
    device = w0.device if device is None else device
    widths = (w0.shape[0],) + tuple(w.shape[1] for w, _, _ in layers)
    if w0.dtype == torch.float32:
        return PackedMLP(widths, torch.cat([w.reshape(-1) for w, _, _ in
                                            layers]).to(device),
                         torch.cat([b for _, b, _ in layers]).to(device))
    kp = [_padded(d) for d in widths]
    w = w0.new_zeros(sum(kp[:-1]), max(kp[1:]), device=device)
    b = torch.zeros(sum(kp[1:]), dtype=torch.float32, device=device)
    scale = None if layers[0][2] is None else torch.zeros_like(b)
    ro = bo = 0
    for i, (wi, bi, si) in enumerate(layers):
        w[ro:ro + widths[i], :widths[i + 1]] = wi
        b[bo:bo + widths[i + 1]] = bi
        if scale is not None:
            scale[bo:bo + widths[i + 1]] = si
        ro, bo = ro + kp[i], bo + kp[i + 1]
    return PackedMLP(widths, w, b, scale)


def pack_mlp(weights, biases, weights_dtype=torch.bfloat16,
             device="cuda") -> PackedMLP:
    """Pack (d_in, d_out) weights and biases once, at build time.

    ``weights_dtype`` is torch.float32, torch.bfloat16 or ``"int8"``
    (per-output-channel symmetric, ``quantize_weights_int8``).  Weights are
    taken to float32 first, so bf16 rounds from float32 as the reference's
    ``w.astype(jnp.bfloat16)`` does.
    """
    ws = [_host_f32(w) for w in weights]
    bs = [_host_f32(b) for b in biases]
    if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"want 1..{MAX_LAYERS} layers with one bias each, "
                         f"got {len(ws)} weights and {len(bs)} biases")
    widths = (ws[0].shape[0],) + tuple(w.shape[1] for w in ws)
    for i, (w, b) in enumerate(zip(ws, bs)):
        if w.shape != (widths[i], widths[i + 1]) or b.shape != (w.shape[1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)} and bias "
                             f"{tuple(b.shape)} do not chain from "
                             f"width {widths[i]}")
    scales = [None] * len(ws)
    if weights_dtype == "int8":
        ws, scales = quantize_weights_int8(ws)
    elif weights_dtype in (torch.float32, torch.bfloat16):
        ws = [w.to(weights_dtype) for w in ws]
    else:
        raise ValueError(f"weights_dtype {weights_dtype!r}: want "
                         "torch.float32, torch.bfloat16 or 'int8'")
    return pack_layers(zip(ws, bs, scales), device)


def _relu_tail(h: torch.Tensor, relu_tail: int) -> torch.Tensor:
    if relu_tail <= 0:
        return h
    d = h.shape[1]
    return torch.cat([h[:, :d - relu_tail], torch.relu(h[:, d - relu_tail:])],
                     dim=1)


def _plain_chain(x, mlp, relu_tail, layer):
    """``layer(h, w, b, s)`` through the network, relu between layers and
    on the last ``relu_tail`` outputs."""
    h = x
    layers = list(mlp.layers())
    for i, (w, b, s) in enumerate(layers):
        y = layer(h, w, b, s)
        h = torch.relu(y) if i < len(layers) - 1 else y
    return _relu_tail(h, relu_tail)


def fused_mlp_forward_plain(x: torch.Tensor, mlp: PackedMLP,
                            relu_tail: int = 0) -> torch.Tensor:
    return _plain_chain(x, mlp, relu_tail,
                        lambda h, w, b, s: h @ w.float() + b)


def fused_mlp_forward_int8_plain(x: torch.Tensor, mlp: PackedMLP,
                                 relu_tail: int = 0) -> torch.Tensor:
    # bf16 x bf16 products are exact in float32: the float32 product of the
    # rounded operands is the bf16 dot with float32 accumulation
    return _plain_chain(
        x, mlp, relu_tail,
        lambda h, q, b, s: (h.to(torch.bfloat16).float() @ q.float()) * s + b)


def split_bf16x3(h: torch.Tensor):
    """(hi, mid, lo) bf16 with hi + mid + lo == h exactly, as the tensor-core
    kernel 2 splits its float32 activations: hi is h truncated to bf16 (its
    top 16 bits), mid the remainder truncated, lo what is left; the two
    subtractions are exact in float32, and lo takes the last 8 significant
    bits whole.  Exact for every finite h of magnitude >= 2**-110; below
    that lo may lose a residue under bf16's subnormal spacing (2**-133).
    A non-finite h goes whole into hi (NaN stays NaN, inf inf) with mid = lo
    = 0, so the products are float32's inf * w and NaN."""
    h = h.float()
    mask = torch.tensor(-65536, dtype=torch.int32)          # 0xffff0000

    def trunc(v):
        return (v.view(torch.int32) & mask).view(torch.float32)

    finite = torch.isfinite(h)
    hf = torch.where(finite, h, torch.zeros_like(h))
    hi = trunc(hf)
    r1 = hf - hi
    mid = trunc(r1)
    lo = r1 - mid
    hi = torch.where(finite, hi, h)
    return hi.to(torch.bfloat16), mid.to(torch.bfloat16), lo.to(torch.bfloat16)


TILE_ROWS = (4, 16)  # the tile heights the float32-weight kernel is built for


def _tile_rows(rows: int, device: torch.device) -> int:
    """Rows a block of the float32-weight (FMA) kernel: 16 once every SM
    gets a block of 16 (fewer re-reads of the weights from L2), else 4, so
    B = 384 (one ne4 chunk) runs as 96 blocks."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 16 if rows >= 16 * n_sm else 4


def _launch_mlp(entry: str, x: torch.Tensor, mlp: PackedMLP,
                relu_tail: int, tile_rows: int | None = None) -> torch.Tensor:
    """Launch the float32-weight FMA entry; ``tile_rows`` (one of
    TILE_ROWS) fixes the tile height, which ``_tile_rows`` picks
    otherwise."""
    out = torch.empty((x.shape[0], mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    tb = tile_rows or _tile_rows(x.shape[0], x.device)
    if tb not in TILE_ROWS:
        raise ValueError(f"{entry}: tile_rows {tb}, want one of {TILE_ROWS}")
    ld = -(-max(mlp.widths[:-1]) // 4) * 4
    smem = 2 * tb * ld * 4
    limit = torch.cuda.get_device_properties(
        x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{entry}: a layer input of width "
                         f"{max(mlp.widths[:-1])} needs {smem} B of shared "
                         f"memory at {tb} rows a block; the card has {limit}")
    if mlp.w.data_ptr() % 16:
        raise ValueError(f"{entry}: packed weights must be 16-byte aligned "
                         "(the kernel loads 4 columns at a time)")
    widths = (ctypes.c_int * len(mlp.widths))(*mlp.widths)
    code = _launch_on(
        x.device, getattr(_build.load(), "cst_" + entry), x.data_ptr(),
        mlp.w.data_ptr(), mlp.b.data_ptr(), out.data_ptr(), widths,
        len(mlp.widths) - 1, x.shape[0], relu_tail, tb)
    _build.check(code, entry)
    return out


# --------------------------------------------------------------------------
# the tensor-core kernel of kernels 2 (bf16 weights) and 3 (int8 weights)
# --------------------------------------------------------------------------
# The plan mirrors csrc/mlp_forward_wgmma.cuh: a cluster of `cluster` CTAs
# owns a row tile of 64 * nwg rows; CTA `rank` owns every layer's output
# chunks j (CHUNK columns each) with j % cluster == rank, at most nb of
# them, and publishes them in its shared memory for the next layer, whose
# K chunks the CTAs read from their owners; weights stream through
# `stages` TMA stages of CHUNK K rows by nb chunks.
MLP_STAGES = 6          # the most weight stages a plan takes
MLP_MAX_NB = 2
MLP_CLUSTERS = (16, 8)  # cluster sizes, largest first


@dataclass(frozen=True)
class MlpPlan:
    """How the tensor-core kernel tiles one (B, widths) call."""
    nwg: int            # 64-row warpgroups a CTA: rows a tile = 64 * nwg
    cluster: int        # CTAs a cluster
    nb: int             # output chunks a CTA owns of the widest layer
    stages: int         # weight stages in flight
    tiles_m: int        # row tiles (clusters)
    smem: int           # dynamic shared memory a CTA, bytes

    @property
    def rows(self) -> int:
        return 64 * self.nwg

    @property
    def grid(self) -> int:
        return self.tiles_m * self.cluster


def _mlp_chunk_bytes(int8: bool, nwg: int) -> int:
    """Bytes of one activation chunk of 64 nwg rows by CHUNK columns: one
    bf16 plane (int8 weights) or three, hi, mid and lo (bf16 weights)."""
    return (1 if int8 else 3) * 64 * nwg * CHUNK * 2


def _mlp_smem(int8: bool, nwg: int, nb: int, stages: int) -> int:
    """``smem_layout(...).total`` of the kernel: the weight ring (int8: the
    raw boxes, then four widened bf16 stages); the activation ring, a chunk
    a stage; the layer table; four barriers a stage (int8: and two a
    widened stage); the base's 1024-byte alignment.  ``chip_smoke.py``
    holds it against the library's own (``cst_mlp_forward_smem``)."""
    box = CHUNK * CHUNK * (1 if int8 else 2)
    conv = 4 * nb * CHUNK * CHUNK * 2 if int8 else 0
    return (stages * nb * box + conv + stages * _mlp_chunk_bytes(int8, nwg)
            + 32 * (MAX_LAYERS + 1) + 32 * stages + (64 if int8 else 0)
            + 1024)


@functools.lru_cache(maxsize=4096)
def plan_mlp_forward(rows: int, widths: tuple, smem_limit: int, n_sm: int,
                     max_cluster: int, int8: bool = False) -> MlpPlan:
    """The tensor-core kernel's plan for x (rows, widths[0]) through the
    MLP of ``widths`` on a card with ``smem_limit`` bytes of shared memory
    a block and ``n_sm`` SMs, where clusters of up to ``max_cluster`` CTAs
    schedule; raises ValueError, with the reason, for a call it cannot
    take.

    The rules the sweep of ``bench_mlp_forward --sweep`` found on an H100:
    while the 64-row tiles fit in the clusters of 16 the SMs hold at once
    (n_sm // 16), clusters of 16 CTAs a 64-row tile, one 64-column chunk a
    CTA of a 1024-wide layer; past that, fewer CTAs a tile, each reading
    every weight for more rows: clusters of 8 over 128-row tiles, or of
    16 where 8 CTAs cannot cover the widest layer (widths past 1024).  Then
    the fewest chunks a CTA that cover the widest layer, and the most
    weight stages, up to MLP_STAGES, that fit.  Rows, tiles and cluster
    change with B and the card; the order in which every output sums its
    K chunks (ascending) does not."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= len(widths) - 1 <= MAX_LAYERS or min(widths) < 1:
        raise ValueError(f"widths {widths}: want 1..{MAX_LAYERS} layers of "
                         "positive widths")
    if rows < 1:
        raise ValueError(f"rows {rows}: want at least 1")
    if max_cluster < MLP_CLUSTERS[-1]:
        raise ValueError(f"the card schedules no cluster of "
                         f"{MLP_CLUSTERS[-1]} CTAs for this kernel "
                         f"(largest {max_cluster})")

    def chunks_a_cta(cluster):
        return max(-(-w // (CHUNK * cluster)) for w in widths)

    one_wave = -(-rows // 64) <= n_sm // 16
    cluster = 16 if max_cluster >= 16 and (
        one_wave or chunks_a_cta(8) > MLP_MAX_NB) else 8
    nwg = 1 if (cluster == 16 and one_wave) or rows <= 64 else 2
    nb = chunks_a_cta(cluster)
    if nb > MLP_MAX_NB:
        raise ValueError(f"a layer of width {max(widths)} needs {nb} chunks "
                         f"of {CHUNK} columns a CTA in a cluster of "
                         f"{cluster}; the kernel takes {MLP_MAX_NB} (widths "
                         f"up to {MLP_MAX_NB * CHUNK * cluster})")
    stages = None
    for n in (nwg, 1):
        fits = [s for s in range(2, MLP_STAGES + 1)
                if _mlp_smem(int8, n, nb, s) <= smem_limit]
        if fits:
            nwg, stages = n, fits[-1]
            break
    if stages is None:
        raise ValueError(f"widths {widths} need "
                         f"{_mlp_smem(int8, 1, nb, 2)} B of shared memory; "
                         f"the card has {smem_limit}")
    return MlpPlan(nwg, cluster, nb, stages, -(-rows // (64 * nwg)),
                   _mlp_smem(int8, nwg, nb, stages))


_ACTIVE_CLUSTERS: dict = {}


def _active_clusters(dev: torch.device, int8: bool, plan: MlpPlan) -> int:
    """Clusters of ``plan``'s shape the card holds at once
    (cudaOccupancyMaxActiveClusters), asked once a device and shape."""
    key = (dev.index, int8, plan.nwg, plan.nb, plan.cluster, plan.smem)
    if key not in _ACTIVE_CLUSTERS:
        lib = _build.load()
        fn = (lib.cst_mlp_forward_clusters_int8 if int8
              else lib.cst_mlp_forward_clusters_bf16)
        with torch.cuda.device(dev):
            n = fn(plan.nwg, plan.nb, plan.cluster, plan.smem)
        if n < 0:
            _build.check(-n, "mlp_forward_clusters")
        _ACTIVE_CLUSTERS[key] = n
    return _ACTIVE_CLUSTERS[key]


def _mlp_plan(rows: int, mlp: PackedMLP, dev: torch.device) -> MlpPlan:
    """The plan on ``dev``: the largest cluster the card schedules for it,
    asked of the card, never found by a failed launch."""
    props = torch.cuda.get_device_properties(dev)
    int8 = mlp.w.dtype == torch.int8
    for max_cluster in MLP_CLUSTERS:
        plan = plan_mlp_forward(rows, mlp.widths,
                                props.shared_memory_per_block_optin,
                                props.multi_processor_count, max_cluster,
                                int8)
        if _active_clusters(dev, int8, plan) > 0:
            return plan
    raise ValueError(f"the card schedules no cluster for widths "
                     f"{mlp.widths} at B={rows}")


def check_mlp_forward(mlp: PackedMLP, device, batches) -> None:
    """Raise, with the reason, where the tensor-core kernel has no plan on
    ``device`` for ``mlp`` at one of ``batches``, so that a server finds
    out when it packs the weights, not at a request.  A plan takes one
    shape for the batches that fill no more than one wave of clusters and
    another past that, so the smallest and the largest batch a caller runs
    check every batch between.  Nothing to check on the CPU or for float32
    weights."""
    device = torch.device(device)
    if device.type != "cuda" or not mlp.padded:
        return
    for b in batches:
        _mlp_plan(b, mlp, device)


def _launch_wgmma(x: torch.Tensor, mlp: PackedMLP, relu_tail: int,
                  passes: int = 3, plan: MlpPlan | None = None
                  ) -> torch.Tensor:
    """The tensor-core kernel on checked CUDA tensors; ``passes`` (bf16
    weights only) is how many of the activations' three bf16 parts enter
    the products: 3 forms kernel 2's float32 products, 1 and 2 exist for the
    card's planted-fault check.  ``plan`` replaces ``_mlp_plan``'s (the
    benchmark's sweep)."""
    out = torch.empty((x.shape[0], mlp.widths[-1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    plan = plan or _mlp_plan(x.shape[0], mlp, x.device)
    int8 = mlp.w.dtype == torch.int8
    # the layers' activations between the CTAs of a cluster, through L2:
    # two buffers of every row tile's chunks
    n_chunks = max(-(-w // CHUNK) for w in mlp.widths[:-1])
    act = torch.empty(2 * plan.tiles_m * n_chunks
                      * _mlp_chunk_bytes(int8, plan.nwg) // 2,
                      dtype=torch.bfloat16, device=x.device)
    widths = (ctypes.c_int * len(mlp.widths))(*mlp.widths)
    lib = _build.load()
    tail = (x.shape[0], relu_tail, plan.nwg, plan.nb, plan.cluster,
            plan.stages)
    if int8:
        code = _launch_on(
            x.device, lib.cst_fused_mlp_forward_int8, x.data_ptr(),
            mlp.w.data_ptr(), mlp.scale.data_ptr(), mlp.b.data_ptr(),
            out.data_ptr(), act.data_ptr(), widths, len(mlp.widths) - 1,
            *tail)
        entry = "fused_mlp_forward_int8"
    else:
        code = _launch_on(
            x.device, lib.cst_fused_mlp_forward_bf16, x.data_ptr(),
            mlp.w.data_ptr(), mlp.b.data_ptr(), out.data_ptr(),
            act.data_ptr(), widths, len(mlp.widths) - 1, *tail, passes)
        entry = "fused_mlp_forward_bf16"
    _build.check(code, entry)
    return out


def _check_mlp(x: torch.Tensor, mlp: PackedMLP, weight_dtypes,
               relu_tail: int) -> None:
    if mlp.w.dtype not in weight_dtypes:
        raise TypeError(f"weights are {mlp.w.dtype}, want one of "
                        f"{weight_dtypes}")
    if not 0 <= relu_tail <= mlp.widths[-1]:
        raise ValueError(f"relu_tail {relu_tail} outside 0..{mlp.widths[-1]}")
    for name, t in (("w", mlp.w), ("b", mlp.b), ("scale", mlp.scale)):
        if t is not None:
            _check(t, name, t.dtype, tuple(None for _ in t.shape), x.device)
    _check(x, "x", torch.float32, (None, mlp.widths[0]), x.device)


def fused_mlp_forward(x: torch.Tensor, mlp: PackedMLP,
                      relu_tail: int = 0) -> torch.Tensor:
    """(B, d_in) float32 -> (B, d_out) float32 through an MLP packed with
    float32 or bf16 weights; relu on the last ``relu_tail`` outputs (the
    ClimSim surface scalars).  bf16 weights run the tensor-core kernel
    (float32 activations split into three bf16 parts, so the products are
    float32's), float32 weights the FMA kernel."""
    _check_mlp(x, mlp, (torch.float32, torch.bfloat16), relu_tail)
    if not _on_cuda(x, "fused_mlp_forward"):
        return fused_mlp_forward_plain(x, mlp, relu_tail)
    if mlp.w.dtype == torch.bfloat16:
        out = _launch_wgmma(x, mlp, relu_tail)
    else:
        out = _launch_mlp("fused_mlp_forward_f32", x, mlp, relu_tail)
    LAUNCHES["fused_mlp_forward"] += 1
    return out


def fused_mlp_forward_int8(x: torch.Tensor, mlp: PackedMLP,
                           relu_tail: int = 0) -> torch.Tensor:
    """``fused_mlp_forward`` for an MLP packed with ``weights_dtype="int8"``."""
    _check_mlp(x, mlp, (torch.int8,), relu_tail)
    if mlp.scale is None:
        raise ValueError("an int8-packed MLP needs its scales")
    if not _on_cuda(x, "fused_mlp_forward_int8"):
        return fused_mlp_forward_int8_plain(x, mlp, relu_tail)
    out = _launch_wgmma(x, mlp, relu_tail)
    LAUNCHES["fused_mlp_forward_int8"] += 1
    return out


def mlp_params_to_matrices(state_dict):
    """Ordered (weights (d_in, d_out), biases) of an OnlineMLP state_dict.

    A state_dict lists the layers in the order the modules were declared
    (trunk layers by index, then the head), so the order is the network's:
    no sort of key strings, which would put ``layers.10`` before
    ``layers.2``.
    """
    ws, bs = [], []
    for key, v in state_dict.items():
        if key.endswith(".weight"):
            ws.append(v.detach().t())   # nn.Linear (out, in) -> (in, out)
        elif key.endswith(".bias"):
            bs.append(v.detach())
    return ws, bs


# --------------------------------------------------------------------------
# int8 weight-only quantization for the fused MLP
# --------------------------------------------------------------------------
def quantize_weights_int8(weights):
    """Per-output-channel symmetric int8 quantization of (d_in, d_out)
    weights.

    Returns (q int8 list, scales float32 list); dequantized weight =
    q * scale[None, :].  Bit-identical to the reference's numpy version:
    the same float32 divisions, and torch.round rounds half to even as
    np.round does.
    """
    qs, scales = [], []
    for w in weights:
        w = _host_f32(w)
        s = w.abs().amax(dim=0) / 127.0
        s = torch.where(s == 0, torch.ones_like(s), s)
        qs.append(torch.clamp(torch.round(w / s), -127, 127).to(torch.int8))
        scales.append(s)
    return qs, scales
