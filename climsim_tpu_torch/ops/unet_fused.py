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
``fused_gn_silu_conv3_bwd`` (``ops/csrc/fused_gn_silu_conv3_bwd.cu``), the
VJP of the XLA chain that the JAX backward takes with ``jax.vjp``
(``:194-196``), in closed form: the statistics and activations recomputed,
the cotangent rounded to bf16, dgrad and wgrad on the tensor cores, the
silu and GroupNorm backward between them.  Its tile plan is
``plan_gn_silu_conv3_bwd``; on the CPU the backward stays autograd of the
plain chain ``xla_gn_silu_conv3_plain(f32_accum=False)``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..models.unet import _num_groups
from ..utils.profiling import profiler_range
from . import _build
from .kernels import (LAUNCHES, OPS_NAMESPACE, _check, _launch_on,
                      _on_cuda)

EPS = 1e-6
MAX_LEVELS = 64   # a sample fits one warpgroup's 64 rows
# the profiler range around the custom VJP's backward (the kernel)
BACKWARD_RANGE = "fused_gn_silu_conv3 backward"
# the profiler range around the forward's launch (a `cuLaunchKernel` of
# the kernel library: no aten op holds it, so without the range it has no
# host event)
FORWARD_RANGE = "fused_gn_silu_conv3 forward"


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


def fused_gn_silu_conv3_bwd_plain(x: torch.Tensor, gamma: torch.Tensor,
                                  beta: torch.Tensor, w: torch.Tensor,
                                  b: torch.Tensor, g: torch.Tensor,
                                  compute_dtype: torch.dtype = torch.bfloat16,
                                  *, rounded: bool = True,
                                  sum_dtype: torch.dtype | None = None
                                  ) -> tuple:
    """The VJP of ``xla_gn_silu_conv3_plain(f32_accum=False)`` at (x, gamma,
    beta, w, b) and cotangent g, in closed form, step by step as the kernel
    takes it: -> (dx, dgamma, dbeta, dw, db), float32.

    1. mean and rstd a (sample, group; ``_num_groups(C)`` groups, eps
       ``EPS``), two passes; a = x^ gamma + beta,
       xn = silu(a) rounded to ``compute_dtype``;
    2. gb = g rounded to it (the VJP of the conv output's rounding);
    3. dxn[l] = sum_k gb[l + 1 - k] w[k]^T, zeros past the sample's edges,
       rounded;
    4. da = dxn s(a) (1 + a (1 - s(a))); dbeta = sum da, dgamma = sum da x^;
       t = da gamma, dx = rstd (t - mean_g(t) - x^ mean_g(t x^));
    5. dw[k] = sum_l xn[l + k - 1]^T gb[l], rounded, as float32;
    6. db = sum g.

    ``rounded=False`` leaves out the roundings of g, dxn and dw (the
    control); ``sum_dtype=torch.float64`` takes every sum in float64 and
    rounds at the same places (the twin the card's tolerance is read
    from)."""
    sd = sum_dtype or x.dtype
    cd = compute_dtype

    def rnd(t, on=True):
        return t.to(cd).to(sd) if on else t

    bsz, l, c = x.shape
    gr = _num_groups(c)
    xs, g = x.to(sd), g.to(sd)
    xg = xs.reshape(bsz, l, gr, c // gr)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True).clamp_min(0)
    rstd = torch.rsqrt(var + EPS)
    xh = ((xg - mean) * rstd).reshape(x.shape)
    a = xh * gamma.to(sd) + beta.to(sd)
    sig = torch.sigmoid(a)
    xn = rnd(F.silu(a))
    gb = rnd(g, rounded)
    wk = rnd(w.to(sd))
    gp = F.pad(gb, (0, 0, 1, 1))            # a zero row past each edge
    dxn = sum(gp[:, 2 - k:2 - k + l] @ wk[k].T for k in range(3))
    da = rnd(dxn, rounded) * (sig * (1 + a * (1 - sig)))
    dgamma = (da * xh).sum(dim=(0, 1))
    dbeta = da.sum(dim=(0, 1))
    t = (da * gamma.to(sd)).reshape(xg.shape)
    xhg = xh.reshape(xg.shape)
    m1 = t.mean(dim=(1, 3), keepdim=True)
    m2 = (t * xhg).mean(dim=(1, 3), keepdim=True)
    dx = (rstd * (t - m1 - xhg * m2)).reshape(x.shape)
    xp = F.pad(xn, (0, 0, 1, 1))
    rows = gb.reshape(-1, gb.shape[2])
    dw = torch.stack([rnd(xp[:, k:k + l].reshape(-1, c).T @ rows, rounded)
                      for k in range(3)])
    db = g.sum(dim=(0, 1))
    return tuple(v.float() for v in (dx, dgamma, dbeta, dw, db))


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


# The backward's plan mirrors ops/csrc/fused_gn_silu_conv3_bwd.cu, three
# passes.  dgrad: a block of two warpgroups owns S whole samples (S L <= 64
# rows) and every channel of them: the warpgroups take `nb` 64-channel
# boxes of dxn each at a time (one warpgroup where C = 64), the weights
# stream through `stages` stages of (64 channels x 64 Cout) boxes, and
# the GroupNorm backward runs on the block's own dxn in shared memory.
# wgrad: a block of three warpgroups (a tap each) and a producer warp owns
# 64 channels x 64 nbb columns of dw and sums `cps` 64-row chunks of the
# padded rows (a zero row past each edge of a sample, B (L + 2) rows);
# split z of the rows writes partial z.  The partials, and the row tiles'
# dgamma, dbeta and db, are added in a fixed order by the last pass.
BWD_STAGES = 3         # weight stages of dgrad, the most
WGRAD_STAGES = 4       # (3 xn + nbb gb) box stages of wgrad, the most
_BWD_BOX_BYTES = BOX * BOX * 2


@dataclasses.dataclass(frozen=True)
class GnBwdPlan:
    """How the backward tiles one (B, L, C, Cout) call."""
    samples: int        # S: whole samples a dgrad block
    tiles_m: int        # dgrad blocks: ceil(B / S)
    nb: int             # 64-channel boxes a warpgroup takes at a time
    wgs: int            # warpgroups on the products (1 where C = 64)
    stages: int         # weight stages of dgrad
    smem: int           # dgrad's dynamic shared memory, bytes
    blocks: int         # dgrad blocks an SM: 2 at 128 registers a thread
    nbb: int            # 64-column boxes of Cout a wgrad block
    wstages: int        # wgrad stages
    tiles_c: int        # C / 64
    tiles_o: int        # ceil(Cout / (64 nbb))
    chunks: int         # 64-row chunks of the B (L + 2) padded rows
    cps: int            # chunks a split
    splits: int         # wgrad partials
    wsmem: int          # wgrad's dynamic shared memory, bytes

    @property
    def wgrad_grid(self) -> int:
        return self.splits * self.tiles_c * self.tiles_o

    def args(self) -> ctypes.Array:
        v = (self.samples, self.stages, self.nb, self.wgs, self.nbb,
             self.wstages, self.cps, self.splits, self.blocks)
        return (ctypes.c_int * len(v))(*v)


def _bwd_smem(s: int, l: int, c: int, cout: int, g: int, boxes: int,
              stages: int) -> int:
    """``layout_a(...).total`` of the dgrad pass: the weight ring (the row
    groups' sums of the GroupNorm backward later in the same bytes); the
    gb slab (S samples of L + 2 rows, pitch 2 Cout + 16 bytes); dxn (S L
    rows, pitch 2 C + 16); four statistics a (sample, group); each row's
    sample; two barriers a stage; the base's 1024-byte alignment."""
    return (stages * boxes * _BWD_BOX_BYTES
            + s * (l + 2) * (2 * cout + _PAD_BYTES)
            + s * l * (2 * c + _PAD_BYTES) + 16 * s * g + 64 + 16 * stages
            + 1024)


def _wgrad_smem(nbb: int, stages: int) -> int:
    """``wgrad_layout(...).total``: the ring of (3 + nbb) boxes a stage, two
    barriers a stage, the alignment."""
    return stages * (3 + nbb) * _BWD_BOX_BYTES + 16 * stages + 1024


@functools.lru_cache(maxsize=4096)
def plan_gn_silu_conv3_bwd(bsz: int, l: int, c: int, cout: int,
                           smem_limit: int, n_sm: int,
                           force: tuple | None = None) -> GnBwdPlan:
    """The backward's plan for x (B, L, C), cotangent (B, L, Cout) on a card
    with ``smem_limit`` bytes of shared memory a block and ``n_sm`` SMs;
    raises ValueError, with the reason, for a shape it cannot take.

    dgrad: two blocks an SM (one box a warpgroup, two weight stages; Cout
    a multiple of 64) where they fit with the most samples a 64-row tile
    holds or down to half of them; then fewer samples (down to half) where
    the grid would leave block slots idle, as kernel 5's plan; with one
    block an SM, the most weight stages and boxes a warpgroup that fit, and
    where none fits, fewer samples: at one sample this is the plan of B =
    1, so a shape planned at B = 1 plans at every B.  wgrad: as many splits
    of the rows as fill the SMs once, every split at least one chunk.
    ``force=(samples, nb, stages, splits, blocks)`` takes those instead
    (the sweep in ``bench_gn_conv3 --backward --sweep``), and raises where
    they do not fit."""
    g = _num_groups(c)
    nbox = c // BOX
    if (not 1 <= l <= MAX_LEVELS or c % BOX or c < BOX or (c // g) % 4
            or cout % 16 or cout < 16 or bsz < 1
            or (nbox > 1 and nbox % 2)):
        raise ValueError(
            f"the backward takes L <= {MAX_LEVELS}, C a multiple of {BOX} "
            "(one box or an even number) with C / groups a multiple of 4, "
            f"Cout a multiple of 16 and B >= 1; got B={bsz}, L={l}, C={c}, "
            f"Cout={cout} (C / groups = {c / g:g})")
    wgs = 1 if nbox == 1 else 2
    nb0 = 2 if nbox % 4 == 0 else 1

    def fit(s):
        for nb, st in ((nb0, BWD_STAGES), (nb0, 2), (1, BWD_STAGES), (1, 2)):
            if _bwd_smem(s, l, c, cout, g, wgs * nb, st) <= smem_limit:
                return nb, st
        return None

    def two(s):     # two blocks an SM, each keeping 1 KB of it
        return (cout % BOX == 0 and 2 * (_bwd_smem(s, l, c, cout, g, wgs, 2)
                                         + 1024) <= smem_limit + 1024)

    s = min(MAX_LEVELS // l, bsz)
    pair = next((k for k in range(s, -(-s // 2) - 1, -1) if two(k)), None)
    blocks = 2 if pair else 1
    s = pair or s
    spread = [k for k in range(-(-s // 2), s)
              if -(-bsz // k) <= blocks * n_sm]
    if -(-bsz // s) < blocks * n_sm and spread:
        s = spread[0]
    if blocks == 2:
        nb, stages = 1, 2
    else:
        choice = fit(s)
        while choice is None and s > 1:
            s -= 1
            choice = fit(s)
        if choice is None:
            need = _bwd_smem(1, l, c, cout, g, wgs, 2)
            raise ValueError(f"the backward at L={l}, C={c}, Cout={cout} "
                             f"needs {need} B of shared memory; the card "
                             f"has {smem_limit}")
        nb, stages = choice
    if force:
        s, nb, stages = min(force[0], bsz), force[1], force[2]
        blocks = force[4]
        if (s * l > MAX_LEVELS or (c // BOX) % (wgs * nb)
                or (blocks == 2 and (nb, stages) != (1, 2)) or not (
                    blocks == 1 or two(s))
                or _bwd_smem(s, l, c, cout, g, wgs * nb, stages)
                > smem_limit):
            raise ValueError(f"force={force} does not fit L={l}, C={c}, "
                             f"Cout={cout}")
    nbb = 2 if cout > BOX else 1
    wst = next((st for st in range(WGRAD_STAGES, 1, -1)
                if _wgrad_smem(nbb, st) <= smem_limit), None)
    if wst is None:
        raise ValueError(f"the backward's wgrad needs {_wgrad_smem(nbb, 2)} "
                         f"B of shared memory; the card has {smem_limit}")
    tiles_c, tiles_o = c // BOX, -(-cout // (BOX * nbb))
    chunks = -(-bsz * (l + 2) // BOX)
    splits = max(1, min(chunks, n_sm // (tiles_c * tiles_o)))
    if force:
        splits = max(1, min(chunks, force[3]))
    cps = -(-chunks // splits)
    tiles_m = -(-bsz // s)
    if max(tiles_m, bsz * (l + 2)) > 2**31 - 1:
        raise ValueError(f"B={bsz} at L={l} needs {tiles_m} blocks")
    return GnBwdPlan(s, tiles_m, nb, wgs, stages,
                     _bwd_smem(s, l, c, cout, g, wgs * nb, stages), blocks,
                     nbb, wst,
                     tiles_c, tiles_o, chunks, cps, -(-chunks // cps),
                     _wgrad_smem(nbb, wst))


def _bwd_device_plan(bsz: int, l: int, c: int, cout: int,
                     dev: torch.device) -> GnBwdPlan:
    props = torch.cuda.get_device_properties(dev)
    return plan_gn_silu_conv3_bwd(bsz, l, c, cout,
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
    """Raise unless the kernel and its backward take every (L, C, Cout) of
    ``chains`` (a model's ``fused_chains()``) on ``device``, at B = 1 and
    at ``batch``, the largest batch the caller will run: a trainer checks
    its network before the first step, not by a failure in the middle of
    one."""
    dev = torch.device(device)
    for l, c, cout in chains:
        for b in sorted({1, max(batch, 1)}):
            err = _shape_error(b, l, c, cout, dev)
            if err is None:
                try:
                    _bwd_device_plan(b, l, c, cout, dev)
                except ValueError as e:
                    err = str(e)
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
    with profiler_range(FORWARD_RANGE):
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


def fused_gn_silu_conv3_bwd(x: torch.Tensor, gamma: torch.Tensor,
                            beta: torch.Tensor, w: torch.Tensor,
                            b: torch.Tensor, g: torch.Tensor) -> tuple:
    """The backward of ``fused_gn_silu_conv3`` at x (B, L, C) float32,
    gamma/beta (C,) float32, w (3, C, Cout) bf16, b (Cout,) float32 and the
    cotangent g (B, L, Cout) float32 -> (dx, dgamma, dbeta, dw, db), all
    float32, dw (3, C, Cout): the VJP of the plain chain with flax's
    roundings (``fused_gn_silu_conv3_bwd_plain``), ``_num_groups(C)``
    groups, eps 1e-6.  One launch of the kernel's three passes on a CUDA
    tensor, counted in ``LAUNCHES["fused_gn_silu_conv3_bwd"]``; the plain
    version on a CPU tensor."""
    dev = x.device
    _check(x, "x", torch.float32, (None, None, None), dev)
    bsz, l, c = x.shape
    if w.dim() != 3:
        raise ValueError(f"w: want (3, {c}, Cout), got {tuple(w.shape)}")
    cout = w.shape[2]
    _check(w, "w", torch.bfloat16, (3, c, cout), dev)
    for name, t, n in (("gamma", gamma, c), ("beta", beta, c), ("b", b, cout)):
        _check(t, name, torch.float32, (n,), dev)
    _check(g, "g", torch.float32, (bsz, l, cout), dev)
    if not _on_cuda(x, "fused_gn_silu_conv3_bwd"):
        return fused_gn_silu_conv3_bwd_plain(x, gamma, beta, w, b, g)
    plan = _bwd_device_plan(max(bsz, 1), l, c, cout, dev)
    if x.data_ptr() % 16 or w.data_ptr() % 16 or g.data_ptr() % 16:
        raise ValueError("x, w and g must be 16-byte aligned (vector loads, "
                         "TMA)")
    if bsz == 0:
        return (torch.empty_like(x), *(torch.zeros(n, device=dev)
                                       for n in (c, c)),
                torch.zeros((3, c, cout), device=dev),
                torch.zeros(cout, device=dev))
    # every element of each is written by the kernel
    dx = torch.empty_like(x)
    dgamma, dbeta, db = (torch.empty(n, device=dev) for n in (c, c, cout))
    dw = torch.empty((3, c, cout), device=dev)
    _launch_bwd(x, gamma, beta, w, g, (dx, dgamma, dbeta, dw, db), plan)
    LAUNCHES["fused_gn_silu_conv3_bwd"] += 1
    return dx, dgamma, dbeta, dw, db


def _launch_bwd(x, gamma, beta, w, g, outs, plan: GnBwdPlan) -> None:
    """The backward's three passes on checked CUDA tensors, tiled by
    ``plan``, into ``outs`` (dx, dgamma, dbeta, dw, db); the scratch (xn
    and gb on the padded rows, the partials) is allocated here."""
    bsz, l, c = x.shape
    cout, dev = w.shape[2], x.device
    rows = bsz * (l + 2)
    scratch = (torch.empty((rows, c), dtype=torch.bfloat16, device=dev),
               torch.empty((rows, cout), dtype=torch.bfloat16, device=dev),
               torch.empty((plan.splits, 3, c, cout), device=dev),
               torch.empty((plan.tiles_m, 2 * c + cout), device=dev))
    code = _launch_on(
        dev, _build.load().cst_fused_gn_silu_conv3_bwd,
        *(t.data_ptr() for t in (x, gamma, beta, w, g, *outs, *scratch)),
        bsz, l, c, cout, _num_groups(c), EPS, plan.args())
    _build.check(code, "fused_gn_silu_conv3_bwd")


class _TrainableBlock(torch.autograd.Function):
    """Forward: the kernel (its plain version on the CPU) on ``w`` rounded
    to the compute dtype.  Saves the five inputs (on the card the rounded
    weight); the backward is ``fused_gn_silu_conv3_bwd`` on the card, and
    on the CPU autograd of the plain chain recomputed at them."""

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
        # the weight changes after every update, so it is cast every call
        wc = w.to(compute_dtype).contiguous()
        ctx.save_for_backward(x, gamma, beta, wc if x.is_cuda else w, b)
        ctx.cfg = (groups, eps, compute_dtype)
        return fused_gn_silu_conv3(x, gamma, beta, wc, b)

    @staticmethod
    def backward(ctx, g):
        groups, eps, compute_dtype = ctx.cfg
        # unpacked once: under torch.utils.checkpoint a second unpack raises
        saved = ctx.saved_tensors
        # the range lets a profile of a step tell the backward apart
        with torch.profiler.record_function(BACKWARD_RANGE):
            if saved[0].is_cuda:
                grads = fused_gn_silu_conv3_bwd(*saved, g.contiguous())
            else:
                with torch.enable_grad():
                    ins = [t.detach().requires_grad_() for t in saved]
                    y = xla_gn_silu_conv3_plain(
                        *ins, compute_dtype, f32_accum=False, groups=groups,
                        eps=eps)
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
    Backward: ``fused_gn_silu_conv3_bwd`` on the card; on the CPU autograd
    of ``xla_gn_silu_conv3_plain(f32_accum=False)`` at the saved inputs.
    ``compute_dtype=float32`` runs both halves in float32 (the CPU parity
    path; the kernel refuses it on the card).  Where a kernel cannot take a
    shape it raises: neither half takes the plain version on the card."""

    def f(x, gamma, beta, w, b):
        return _TrainableBlock.apply(x, gamma, beta, w, b, groups, eps,
                                     compute_dtype)

    return f
