"""GroupNorm -> silu -> conv3, the U-Net half-block, as one CUDA kernel,
and that kernel under a custom VJP for training.

The counterpart of ``climsim_tpu.ops.unet_fused``: the EDM half-block

    GroupNorm(float32 two-pass statistics) -> silu -> bf16 -> Conv1d(k=3,
    bf16 x bf16 products summed in float32) + float32 bias

in one launch (``ops/csrc/fused_gn_silu_conv3.cu``), so the normalized
activations never leave the chip.  Layout is the JAX package's,
channels-last: x (B, L, C), w (3, C, Cout) as flax keeps a conv kernel.

As in ``ops.kernels``: the public function checks its arguments, takes the
plain version for a tensor on the CPU and launches the kernel for a tensor
on a CUDA device (no fallback), and counts each launch in
``kernels.LAUNCHES["fused_gn_silu_conv3"]``.  How the kernel tiles a call
(whole samples a row tile, output channels a block, weight stages) is
planned here, in ``plan_gn_silu_conv3``, from the shape, the batch and
the card; shapes it cannot take are refused with the reason.

``make_trainable_fused_block`` (``climsim_tpu/ops/unet_fused.py:160``) puts
the kernel inside a training step: its forward is the kernel, its backward
autograd of the plain chain ``xla_gn_silu_conv3_plain(f32_accum=False)``
recomputed at the saved inputs, as the JAX backward is ``jax.vjp`` of the
XLA chain (``:194-196``).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..models.unet import _num_groups
from . import _build
from .kernels import (LAUNCHES, OPS_NAMESPACE, _check, _launch_on,
                      _on_cuda)

EPS = 1e-6
MAX_LEVELS = 64   # a sample fits one warpgroup's 64 rows
# the profiler range around the custom VJP's backward (the recompute)
BACKWARD_RANGE = "fused_gn_silu_conv3 backward"


def xla_gn_silu_conv3_plain(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor,
                            compute_dtype: torch.dtype | None = None,
                            f32_accum: bool = True, *,
                            groups: int | None = None,
                            eps: float = EPS) -> torch.Tensor:
    """``xla_gn_silu_conv3`` (``climsim_tpu/ops/unet_fused.py:129-157``) in
    torch: two-pass GroupNorm statistics, affine, silu, rounded to
    ``compute_dtype`` (``w``'s dtype by default), conv3 with ``w`` rounded
    to it, + ``b``; ``groups`` defaults to ``_num_groups(C)``.

    The rounded operands are widened back to ``x``'s dtype and the product
    is taken there (bf16 products are exact in float32).  ``f32_accum=True``
    keeps the float32 sum (the kernel's arithmetic); ``False`` rounds the
    conv's output to ``compute_dtype`` before the bias, as flax's Conv1d
    does, and autograd of it rounds as the XLA VJP does: the incoming
    gradient to bf16 before the conv's transposes, dxn and dw to bf16
    after them."""
    cd = compute_dtype or w.dtype
    bsz, l, c = x.shape
    g = groups or _num_groups(c)
    xg = x.reshape(bsz, l, g, c // g)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    xn = F.silu(xn * gamma + beta).to(cd).to(x.dtype)
    y = F.conv1d(xn.transpose(1, 2), w.to(cd).to(x.dtype).permute(2, 1, 0),
                 padding=1).transpose(1, 2)
    if not f32_accum:
        y = y.to(cd).to(x.dtype)
    return y + b


# The tile plan mirrors ops/csrc/fused_gn_silu_conv3.cu: a block of two
# consumer warpgroups owns 64 * nwg output rows made of whole samples and
# nt boxes of 64 output channels (nwg = 2: a warpgroup a 64-row half; nwg =
# 1: the two split the boxes); the weights stream through `stages` shared
# memory stages of 64 rows (K) by 64 * nt columns.
BOX = 64
STAGES = 3            # weight stages in flight (the sweep's best, H100)
_PAD_BYTES = 16       # slab row padding
# every (nwg, nt) the kernel is built for: the sweep in bench_gn_conv3
_TILES = ((2, 2), (1, 4), (2, 1), (1, 2), (1, 1))


@dataclasses.dataclass(frozen=True)
class GnPlan:
    """How the kernel tiles one (B, L, C, Cout) call."""
    nwg: int            # 64-row halves of the row tile
    nt: int             # 64-column boxes of output channels a block
    stages: int         # weight stages in flight
    samples: int        # S: whole samples a row tile (S * L <= rows)
    tiles_m: int        # row tiles: ceil(B / S)
    tiles_n: int        # column tiles: ceil(Cout / n_tile)
    smem: int           # dynamic shared memory a block, bytes
    # (tap, first channel) of each 64-row weight stage, in the order every
    # output sums them: it depends on C only
    k_order: tuple

    @property
    def rows(self) -> int:
        return 64 * self.nwg

    @property
    def n_tile(self) -> int:
        return BOX * self.nt

    @property
    def grid(self) -> int:
        return self.tiles_m * self.tiles_n


def _smem_bytes(s: int, l: int, c: int, g: int, nt: int, stages: int) -> int:
    """``smem_layout(...).total`` of the kernel: the weight ring; the slab
    (S samples of L + 2 rows, pitch 2C + 16 bytes; the partial sums before
    it in the same bytes); mean and rstd a (sample, group); each row's
    sample; two barriers a stage; and the base's 1024-byte alignment."""
    return (stages * nt * BOX * BOX * 2 + s * (l + 2) * (2 * c + _PAD_BYTES)
            + 8 * s * g + 128 + 16 * stages + 1024)


def _per_sm(smem: int, smem_limit: int) -> int:
    """Blocks of ``smem`` bytes an SM holds (the SM has the block limit
    plus the 1 KB it keeps a block), at most the kernel's 2."""
    return min(2, (smem_limit + 1024) // (smem + 1024))


def _stages(s, l, c, g, nt, smem_limit, least=2,
            most=STAGES) -> int | None:
    """The weight stages (``least`` to ``most``): the most that keep the
    most blocks an SM; None if none fits."""
    fit = [st for st in range(least, most + 1)
           if _smem_bytes(s, l, c, g, nt, st) <= smem_limit]
    return max(fit, key=lambda st: (_per_sm(
        _smem_bytes(s, l, c, g, nt, st), smem_limit), st), default=None)


def _tiling(bsz: int, l: int, c: int, cout: int, smem_limit: int,
            n_sm: int) -> tuple:
    """(nwg, nt, samples) by the rules the sweep on an H100 found (PERF.md):
    where Cout <= 128, 128-row tiles if they fill the SMs two blocks an SM;
    else 64-row tiles with every output channel in the block (nt up to 4),
    the columns split while the grid is under half the SMs, and, where the
    grid leaves SMs idle, fewer samples a tile (down to half the rows), so
    that the grid comes as close to one block an SM as it can."""
    g = _num_groups(c)
    nt = 4 if cout > 128 else 2 if cout > 64 else 1

    def grid(s, nt):
        return -(-bsz // s) * -(-cout // (BOX * nt))

    s = min(128 // l, bsz)
    st = _stages(s, l, c, g, nt, smem_limit) if nt <= 2 else None
    if (st and grid(s, nt) >= n_sm
            and _per_sm(_smem_bytes(s, l, c, g, nt, st), smem_limit) == 2):
        return 2, nt, s
    s = min(64 // l, bsz)
    while nt > 1 and grid(s, nt) < n_sm / 2:
        nt //= 2
    fits = [k for k in range(-(-s // 2), s) if grid(k, nt) <= n_sm]
    if grid(s, nt) < n_sm and fits:
        s = fits[0]
    return 1, nt, s


@functools.lru_cache(maxsize=4096)
def plan_gn_silu_conv3(bsz: int, l: int, c: int, cout: int, smem_limit: int,
                       n_sm: int, tiles: tuple | None = None) -> GnPlan:
    """The kernel's tile plan for x (B, L, C) -> (B, L, Cout) on a card with
    ``smem_limit`` bytes of shared memory a block and ``n_sm`` SMs; raises
    ValueError, with the reason, for a shape the kernel cannot take.

    The tiling is ``_tiling``'s, with ``_stages`` weight stages;
    ``tiles=(nwg, nt[, stages])`` forces one, with the most samples a tile
    holds and, if given, exactly that many stages (the sweep in
    ``bench_gn_conv3``).  The samples a tile, the
    tiles and the stages change with B and the card; the K order does
    not."""
    g = _num_groups(c)
    if (not 1 <= l <= MAX_LEVELS or c % BOX or (c // g) % 4 or cout % 16
            or cout < 16 or bsz < 1):
        raise ValueError(
            f"the kernel takes L <= {MAX_LEVELS}, C a multiple of {BOX} with "
            "C / groups a multiple of 4, Cout a multiple of 16 and B >= 1; "
            f"got B={bsz}, L={l}, C={c}, Cout={cout} (C / groups = "
            f"{c / g:g})")
    if tiles:
        nwg, nt, *forced = tiles
        s = min(64 * nwg // l, bsz)
    else:
        (nwg, nt, s), forced = _tiling(bsz, l, c, cout, smem_limit, n_sm), []
    stages = _stages(s, l, c, g, nt, smem_limit, *forced * 2)
    # where the slab of s samples and two weight stages overflow shared
    # memory, fewer samples a tile, then fewer columns: at one sample and
    # one box this is the plan of B = 1, so a shape planned at B = 1 plans
    # at every B (the K order depends on C alone)
    while stages is None and not forced and (s > 1 or nt > 1):
        s, nt = (s - 1, nt) if s > 1 else (s, nt // 2)
        stages = _stages(s, l, c, g, nt, smem_limit)
    if stages is None:
        need = _smem_bytes(s, l, c, g, nt, forced[0] if forced else 2)
        raise ValueError(f"C={c} at L={l} needs {need} B of shared memory; "
                         f"the card has {smem_limit}")
    plan = GnPlan(nwg, nt, stages, s, -(-bsz // s), -(-cout // (BOX * nt)),
                  _smem_bytes(s, l, c, g, nt, stages),
                  tuple(divmod(q * BOX, c) for q in range(3 * c // BOX)))
    if plan.grid > 2**31 - 1:
        raise ValueError(f"B={bsz} at L={l} needs {plan.grid} blocks")
    return plan


def _device_plan(bsz: int, l: int, c: int, cout: int,
                 dev: torch.device) -> GnPlan:
    props = torch.cuda.get_device_properties(dev)
    return plan_gn_silu_conv3(bsz, l, c, cout,
                              props.shared_memory_per_block_optin,
                              props.multi_processor_count)


def _shape_error(bsz: int, l: int, c: int, cout: int,
                 dev: torch.device) -> str | None:
    """Why the kernel cannot take this shape on ``dev``, or None."""
    try:
        _device_plan(bsz, l, c, cout, dev)
    except ValueError as e:
        return str(e)
    return None


def check_kernel_shapes(chains, device, batch: int = 1) -> None:
    """Raise unless the kernel takes every (L, C, Cout) of ``chains`` (a
    model's ``fused_chains()``) on ``device``, at B = 1 and at ``batch``,
    the largest batch the caller will run: a trainer checks its network
    before the first step, not by a failure in the middle of one."""
    dev = torch.device(device)
    for l, c, cout in chains:
        for b in sorted({1, max(batch, 1)}):
            err = _shape_error(b, l, c, cout, dev)
            if err:
                raise ValueError(f"fused chain (L={l}, C={c}, Cout={cout}) "
                                 f"at B={b}: " + err)


def fused_gn_silu_conv3(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """x (B, L, C) float32, gamma/beta (C,) float32, w (3, C, Cout) bf16,
    b (Cout,) float32 -> (B, L, Cout) float32, with ``_num_groups(C)``
    groups and eps 1e-6.  On the CPU, w may also be float32 (the
    float32-compute path); the kernel takes bf16 only."""
    dev = x.device
    _check(x, "x", torch.float32, (None, None, None), dev)
    bsz, l, c = x.shape
    if w.dim() != 3:
        raise ValueError(f"w: want (3, {c}, Cout), got {tuple(w.shape)}")
    cout = w.shape[2]
    _check(w, "w", w.dtype, (3, c, cout), dev)
    for name, t, n in (("gamma", gamma, c), ("beta", beta, c), ("b", b, cout)):
        _check(t, name, torch.float32, (n,), dev)
    # a dispatch mode (utils.profiling's FLOP counter) sees the kernel's
    # work only as this operator; inside the mode's handler the mode is
    # off, so the operator's implementation (this function) launches
    if torch.compiler.is_compiling() or _get_current_dispatch_mode():
        return _gn_silu_conv3_op(x, gamma, beta, w, b)
    if not _on_cuda(x, "fused_gn_silu_conv3"):
        if w.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"w: want bf16 or float32, got {w.dtype}")
        return xla_gn_silu_conv3_plain(x, gamma, beta, w, b)
    if w.dtype != torch.bfloat16:
        raise TypeError(f"w: the kernel takes bf16 weights, got {w.dtype}")
    plan = _device_plan(max(bsz, 1), l, c, cout, dev)
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (vector loads, "
                         "TMA)")
    out = torch.empty((bsz, l, cout), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    _launch(x, gamma, beta, w, b, out, plan)
    LAUNCHES["fused_gn_silu_conv3"] += 1
    return out


# The kernel as an operator of torch.library, for torch.export: as
# kernels 1 and 4 (ops/kernels.py), the public function calls it while a
# program is traced, and its implementation is the public function.
@torch.library.custom_op(f"{OPS_NAMESPACE}::fused_gn_silu_conv3",
                         mutates_args=())
def _gn_silu_conv3_op(x: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, w: torch.Tensor,
                      b: torch.Tensor) -> torch.Tensor:
    # a program's strides at run time need not be the traced ones
    return fused_gn_silu_conv3(x.contiguous(), gamma, beta, w, b)


@_gn_silu_conv3_op.register_fake
def _(x, gamma, beta, w, b):
    return x.new_empty((*x.shape[:2], w.shape[2]))


def _launch(x, gamma, beta, w, b, out, plan: GnPlan) -> None:
    """The kernel on checked CUDA tensors, tiled by ``plan``."""
    bsz, l, c = x.shape
    code = _launch_on(
        x.device, _build.load().cst_fused_gn_silu_conv3, x.data_ptr(),
        gamma.data_ptr(), beta.data_ptr(), w.data_ptr(), b.data_ptr(),
        out.data_ptr(), bsz, l, c, w.shape[2], _num_groups(c), EPS, plan.nwg,
        plan.nt, plan.stages, plan.samples)
    _build.check(code, "fused_gn_silu_conv3")


class _TrainableBlock(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU) on ``w`` rounded
    to the compute dtype.  Saves the five inputs only; the backward
    recomputes the plain chain at them and differentiates it."""

    @staticmethod
    def forward(ctx, x, gamma, beta, w, b, groups, eps, compute_dtype):
        # activations reach a chain from torch.cat and residual sums; the
        # kernel takes a contiguous x, so it is made so here, once
        x = x.contiguous()
        if groups != _num_groups(x.shape[2]) or eps != EPS:
            raise ValueError(f"the kernel takes {_num_groups(x.shape[2])} "
                             f"groups and eps {EPS}; got {groups}, {eps}")
        if x.device.type == "cuda" and compute_dtype != torch.bfloat16:
            raise TypeError("the kernel takes bf16 weights; "
                            f"compute_dtype {compute_dtype} runs on the CPU")
        ctx.save_for_backward(x, gamma, beta, w, b)
        ctx.cfg = (groups, eps, compute_dtype)
        # the weight changes after every update, so it is cast every call
        return fused_gn_silu_conv3(x, gamma, beta,
                                   w.to(compute_dtype).contiguous(), b)

    @staticmethod
    def backward(ctx, g):
        groups, eps, compute_dtype = ctx.cfg
        # the range lets a profile of a step tell the recompute apart
        with torch.profiler.record_function(BACKWARD_RANGE), \
                torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            y = xla_gn_silu_conv3_plain(*ins, compute_dtype, f32_accum=False,
                                        groups=groups, eps=eps)
            grads = torch.autograd.grad(y, ins, g)
        return (*grads, None, None, None)


def make_trainable_fused_block(groups: int, eps: float = EPS,
                               compute_dtype: torch.dtype = torch.bfloat16):
    """The counterpart of ``make_trainable_fused_block``
    (``climsim_tpu/ops/unet_fused.py:160``): returns ``f(x, gamma, beta, w,
    b) -> (B, L, Cout)`` float32, differentiable in all five, with ``w`` the
    float32 (3, Cin, Cout) kernel in flax's layout (dw is float32).

    Forward: ``fused_gn_silu_conv3`` on ``w`` rounded to ``compute_dtype``,
    the CUDA kernel on the card and its plain version on the CPU.
    Backward: autograd of ``xla_gn_silu_conv3_plain(f32_accum=False)`` at
    the saved inputs; it never calls the kernel.  ``compute_dtype=float32``
    runs both halves in float32 (the CPU parity path; the kernel refuses
    it on the card).  Where the kernel cannot take a shape the forward
    raises: it never takes the plain version on the card."""

    def f(x, gamma, beta, w, b):
        return _TrainableBlock.apply(x, gamma, beta, w, b, groups, eps,
                                     compute_dtype)

    return f
