"""Fused MLP training: a forward and a backward kernel tied together by a
``torch.autograd.Function`` (the counterpart of
``climsim_tpu.ops.fused_mlp_train``, kernel 6).

The network is a relu trunk with a linear last layer (the OnlineMLP / RPN
member shape), ``widths = (d_in, h_1, ..., d_out)``:

  * pack (``csrc/fused_mlp_train_fwd.cu``): one launch rounds every
    layer's float32 weights to bf16 (nearest even) into the tensor-core
    kernel's padded device layout (``kernels.PackedMLP``), biases padded
    in float32; the forward and the backward read the same pack;
  * forward (``csrc/fused_mlp_train_fwd.cu``): kernel 2's tensor-core
    kernel on the pack, float32 activations times bf16 weights with
    float32's products, float32 sums, + b, relu between layers; nothing
    is saved but the input (and the pack);
  * backward (``csrc/fused_mlp_train_bwd.cu``): recomputes the forward
    with the forward's device code and plan (so the relu masks agree bit
    for bit), keeping each hidden h rounded to bf16, then layer by layer
    dW = bf16(h)^T bf16(dh) and db = sum(dh) with float32 sums, and dh <-
    bf16(dh) bf16(W)^T masked by the saved h > 0, on one TMA-fed wgmma
    GEMM (``csrc/mlp_train_wgmma.cuh``).  It returns dW and db, and zeros
    for x (the input is data).

``plan_mlp_train`` gives every launch's tiling and every scratch size; a
call plans before it launches, so a shape the kernels cannot take raises
before a step.  The dW products split the batch into chunks of whole
multiples of ``tile_b`` rows (and of 64), as many as fill the SMs, and
add the chunks' partials in chunk order; db sums row tiles in a fixed
order (32 lanes, each its tiles ascending, then a fixed tree): two runs
give the same bits.

The functions take the plain versions (``*_plain``, the same math in
torch, with the Pallas kernel's bf16 roundings at
climsim_tpu/ops/fused_mlp_train.py:87-106) for tensors on the CPU and
launch the kernels for tensors on a CUDA device, counting each launch in
``kernels.LAUNCHES``.  The plain backward masks by the float32 h > 0; the
kernels by the saved bf16 h > 0, which differs only for 0 < h <= 2**-134
(bf16 rounds it to 0; XLA's CPU flushes such h in the relu itself).  The
JAX module's ``vmem_estimate_bytes`` is a TPU VMEM budget and has no
counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from . import _build
from .kernels import (CHUNK, LAUNCHES, MAX_LAYERS, MLP_CLUSTERS,
                      MLP_MAX_NB, MlpPlan, PackedMLP, _active_clusters,
                      _check, _ctas_an_sm, _device_limits, _launch_on,
                      _mlp_chunk_bytes, _on_cuda, _padded, pack_layers,
                      plan_mlp_forward)


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and widen back: the products of two
    such values are exact in float32."""
    return t.to(torch.bfloat16).float()


def _check_net(x: torch.Tensor, ws, bs) -> tuple[int, ...]:
    """Raise unless x, ws, bs chain as a network on x's device; return its
    widths."""
    if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"want 1..{MAX_LAYERS} layers with one bias each, "
                         f"got {len(ws)} weights and {len(bs)} biases")
    widths = (x.shape[-1],) + tuple(w.shape[-1] for w in ws)
    _check(x, "x", torch.float32, (None, widths[0]), x.device)
    for i, (w, b) in enumerate(zip(ws, bs)):
        _check(w, f"w[{i}]", torch.float32, (widths[i], widths[i + 1]),
               x.device)
        _check(b, f"b[{i}]", torch.float32, (widths[i + 1],), x.device)
    return widths


# --------------------------------------------------------------------------
# plain versions
# --------------------------------------------------------------------------
def _forward_acts(x, ws, bs):
    """[x, h_0, ..., h_{n-2}, y]: each hidden activation after its relu."""
    acts, h = [x], x
    for i, (w, b) in enumerate(zip(ws, bs)):
        h = h @ _bf16(w) + b
        if i < len(ws) - 1:
            h = torch.relu(h)
        acts.append(h)
    return acts


def fused_mlp_train_fwd_plain(x, ws, bs) -> torch.Tensor:
    return _forward_acts(x, ws, bs)[-1]


def fused_mlp_train_bwd_plain(x, dy, ws, bs, rounded: bool = True):
    """(dW list, db list) of the Pallas backward: dW = bf16(h)^T bf16(dh)
    and db = sum(dh) over the whole batch (the Pallas kernel's tiles only
    change the order of the float32 sums); dh <- (bf16(dh) bf16(W)^T)
    masked by h > 0.  ``rounded=False`` keeps h and dh in float32 (the
    bf16 weights stay): the control that the kernel's check must tell
    apart."""
    r = _bf16 if rounded else (lambda t: t)
    acts = _forward_acts(x, ws, bs)
    dws, dbs = [None] * len(ws), [None] * len(ws)
    dh = dy
    for i in range(len(ws) - 1, -1, -1):
        dws[i] = r(acts[i]).t() @ r(dh)
        dbs[i] = dh.sum(dim=0)
        if i > 0:
            dh = r(dh) @ _bf16(ws[i]).t()
            dh = torch.where(acts[i] > 0, dh, torch.zeros_like(dh))
    return dws, dbs


def pack_train_params_plain(ws, bs) -> PackedMLP:
    """The pack kernel's result: every weight rounded to bf16 (nearest
    even) in the padded device layout, the biases padded, float32."""
    return pack_layers([(w.to(torch.bfloat16), b, None)
                        for w, b in zip(ws, bs)])


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
# The backward's GEMM (csrc/mlp_train_wgmma.cuh): 128 x bn output tiles,
# 64 K a stage, `stages` stages of TMA boxes in flight.
GEMM_BM = 128
GEMM_BK = 64
GEMM_BN = (64, 128, 256)   # dW products; dh products up to 128
GEMM_DH_BN = (64, 128)
GEMM_MAX_STAGES = 6
PREP_ROWS = 64            # rows a tile of the pass that rounds x and dy
# the widest layer the forward plan takes (kernels.plan_mlp_forward)
TRAIN_MAX_WIDTH = MLP_MAX_NB * CHUNK * MLP_CLUSTERS[0]
PLAN_HEAD, PLAN_LAYER = 5, 5   # the plan argument's ints (TrainPlan.args)


def _gemm_smem(bn: int, stages: int) -> int:
    """``gemm_layout(bn, stages).total`` of the GEMM: the A ring (two 8 KB
    boxes a stage), the B ring (bn / 64 boxes a stage), the eight warps'
    column sums, two barriers a stage, the base's 1024-byte alignment.
    ``chip_smoke.py`` holds it against the library's own
    (``cst_mlp_train_gemm_smem``)."""
    return stages * (2 + bn // 64) * 8192 + 8 * bn * 4 + 16 * stages + 1024


def _gemm_blocks(dw: bool, bn: int) -> int:
    """Blocks an SM the registers allow (``blocks_an_sm`` of the GEMM):
    two for dW products up to 128 columns and dh products of 64 (a dh
    product keeps a stage's sums beside its own), else one."""
    return 2 if bn <= (128 if dw else 64) else 1


def _gemm_stages(bn: int, smem_limit: int, blocks: int) -> int:
    """The most stages, up to GEMM_MAX_STAGES, that let ``blocks`` blocks
    share an SM with at least three stages; else the most that fit one."""
    for per_sm, low in ((blocks, 3), (1, 3), (1, 2)):
        fits = [s for s in range(low, GEMM_MAX_STAGES + 1)
                if _gemm_smem(bn, s) <= smem_limit
                and _ctas_an_sm(_gemm_smem(bn, s), smem_limit) >= per_sm]
        if fits:
            return fits[-1]
    raise ValueError(f"the backward's GEMM at bn {bn} needs "
                     f"{_gemm_smem(bn, 2)} B of shared memory; the card has "
                     f"{smem_limit}")


@dataclass(frozen=True)
class GemmTile:
    """One product's tiling: 128 x ``bn`` output tiles, ``stages`` stages;
    dW products also ``rows`` batch rows a split-K chunk and ``chunks``
    chunks (0 for dh products)."""
    bn: int
    stages: int
    smem: int
    rows: int = 0
    chunks: int = 0


@dataclass(frozen=True)
class TrainPlan:
    """How kernel 6 runs one (B, widths, tile_b) step."""
    widths: tuple
    batch: int
    tile_b: int
    forward: MlpPlan          # the forward and the recompute (kernel 2)
    dw: tuple                 # GemmTile a layer: dW_l
    dh: tuple                 # GemmTile a layer: dh_{l-1} (None at l = 0)
    prep_rows: int
    # scratch, in elements: kernel 2's activations (bf16), the saved
    # hidden h (bf16), x rounded (bf16), each of two dh buffers (bf16),
    # the dW and db partials (float32)
    act: int
    save: int
    xb: int
    dh_buf: int
    partial: int

    def chunk_bounds(self, layer: int) -> list[tuple[int, int]]:
        """The batch rows [start, end) of layer ``layer``'s dW chunks, in
        the order their partials are added."""
        kc = self.dw[layer].rows
        return [(z * kc, min(self.batch, (z + 1) * kc))
                for z in range(self.dw[layer].chunks)]

    def args(self) -> ctypes.Array:
        """The backward's plan argument (csrc/fused_mlp_train_bwd.cu)."""
        f = self.forward
        vals = [f.nwg, f.nb, f.cluster, f.stages, self.prep_rows]
        for dw, dh in zip(self.dw, self.dh):
            vals += [dw.bn, dw.stages, dw.rows,
                     dh.bn if dh else 0, dh.stages if dh else 0]
        return (ctypes.c_int * len(vals))(*vals)


def check_train_widths(widths) -> tuple[int, ...]:
    """Raise, with the reason, for widths kernel 6 cannot take on any card:
    1..MAX_LAYERS layers, each width 1..TRAIN_MAX_WIDTH (the forward's
    clusters of 16 CTAs own two 64-column chunks each at most; the
    backward's GEMM takes any width)."""
    widths = tuple(int(w) for w in widths)
    if not 1 <= len(widths) - 1 <= MAX_LAYERS:
        raise ValueError(f"widths {widths}: want 1..{MAX_LAYERS} layers")
    if not 1 <= min(widths) or max(widths) > TRAIN_MAX_WIDTH:
        raise ValueError(f"widths {widths}: kernel 6 takes widths "
                         f"1..{TRAIN_MAX_WIDTH}")
    return widths


@functools.lru_cache(maxsize=4096)
def plan_mlp_train(widths: tuple, rows: int, tile_b: int, smem_limit: int,
                   n_sm: int, max_cluster: int = 16) -> TrainPlan:
    """Kernel 6's plan for a batch of ``rows`` through ``widths`` on a card
    with ``smem_limit`` bytes of shared memory a block and ``n_sm`` SMs,
    where clusters of up to ``max_cluster`` CTAs schedule; raises
    ValueError, with the reason, for a shape it cannot take.

    The forward and the recompute: kernel 2's plan
    (``kernels.plan_mlp_forward``) at the full widths.  The backward's
    products: 128 x 256 tiles for dW and 128 x 64 for dh
    (``bench_mlp_train --sweep`` on an H100 found dh at 64 columns, two
    blocks an SM, ~0.2 ms ahead of 128 at v1, B = 32768, and dW at 256
    the fastest by under 0.1 ms), the most stages that let as many blocks
    share an SM as the registers allow (``_gemm_blocks``).  A dW product
    cuts the batch into chunks of whole multiples of lcm(tile_b, 64) rows,
    as many as make its tiles fill the SMs once, at most one a multiple;
    the chunks cover the batch once, ascending, and their partials are
    added in that order.  db sums rows of PREP_ROWS (the last layer's, from dy) and of
    128 (the dh products' tiles), then those tiles in a fixed order."""
    widths = check_train_widths(widths)
    if rows < 1:
        raise ValueError(f"rows {rows}: want at least 1")
    if tile_b < 1:
        raise ValueError(f"tile_b {tile_b}: want >= 1")
    if -(-rows // GEMM_BM) > 65535:
        raise ValueError(f"a batch of {rows}: the dh products take at most "
                         f"{65535 * GEMM_BM} rows")
    fwd = plan_mlp_forward(rows, widths, smem_limit, n_sm, max_cluster)
    n = len(widths) - 1
    unit = math.lcm(tile_b, GEMM_BK)
    units = -(-rows // unit)
    dw, dh = [], []
    partial = 0
    for l in range(n):
        bn = 256
        st = _gemm_stages(bn, smem_limit, _gemm_blocks(True, bn))
        smem = _gemm_smem(bn, st)
        tiles = -(-widths[l] // GEMM_BM) * -(-widths[l + 1] // bn)
        per_sm = min(_ctas_an_sm(smem, smem_limit), _gemm_blocks(True, bn))
        s = max(1, min(units, per_sm * n_sm // tiles))
        kc = -(-units // s) * unit
        s = -(-rows // kc)
        dw.append(GemmTile(bn, st, smem, kc, s))
        partial += s * widths[l] * widths[l + 1]
        if l == n - 1:
            partial += -(-rows // PREP_ROWS) * widths[l + 1]
        else:
            partial += -(-rows // GEMM_BM) * _padded(widths[l + 1])
        if l == 0:
            dh.append(None)
        else:
            bn = 64
            st = _gemm_stages(bn, smem_limit, _gemm_blocks(False, bn))
            dh.append(GemmTile(bn, st, _gemm_smem(bn, st)))
    n_chunks = max(-(-w // CHUNK) for w in widths[:-1])
    return TrainPlan(
        widths, rows, tile_b, fwd, tuple(dw), tuple(dh), PREP_ROWS,
        act=2 * fwd.tiles_m * n_chunks * _mlp_chunk_bytes(False, fwd.nwg)
        // 2,
        save=rows * sum(_padded(w) for w in widths[1:-1]),
        xb=rows * _padded(widths[0]),
        dh_buf=rows * max(_padded(w) for w in widths[1:]),
        partial=partial)


def _train_plan(rows: int, widths: tuple, tile_b: int,
                dev: torch.device) -> TrainPlan:
    """The plan on ``dev``: the largest cluster the card schedules for the
    forward, asked of the card (as kernels._mlp_plan)."""
    limit, n_sm, _ = _device_limits(dev.index)
    for max_cluster in MLP_CLUSTERS:
        plan = plan_mlp_train(widths, rows, tile_b, limit, n_sm, max_cluster)
        if _active_clusters(dev, False, plan.forward) > 0:
            return plan
    raise ValueError(f"the card schedules no cluster for widths {widths} "
                     f"at B={rows}")


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------
def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _c_widths(widths) -> ctypes.Array:
    return (ctypes.c_int * len(widths))(*widths)


def pack_train_params(ws, bs) -> PackedMLP:
    """Float32 weights (d_i, d_{i+1}) and biases -> the bf16 pack the
    forward and backward read (``pack_train_params_plain``'s layout), in
    one launch for a CUDA device."""
    if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
        raise ValueError(f"want 1..{MAX_LAYERS} layers with one bias each, "
                         f"got {len(ws)} weights and {len(bs)} biases")
    widths = (ws[0].shape[0],) + tuple(w.shape[-1] for w in ws)
    dev = ws[0].device
    for i, (w, b) in enumerate(zip(ws, bs)):
        _check(w, f"w[{i}]", torch.float32, (widths[i], widths[i + 1]), dev)
        _check(b, f"b[{i}]", torch.float32, (widths[i + 1],), dev)
    if not _on_cuda(ws[0], "fused_mlp_train_pack"):
        return pack_train_params_plain(ws, bs)
    kp = [_padded(d) for d in widths]
    w = torch.empty(sum(kp[:-1]), max(kp[1:]), dtype=torch.bfloat16,
                    device=dev)
    b = torch.empty(sum(kp[1:]), dtype=torch.float32, device=dev)
    code = _launch_on(dev, _build.load().cst_fused_mlp_train_pack, _ptrs(ws),
                      _ptrs(bs), _c_widths(widths), len(ws), w.data_ptr(),
                      b.data_ptr())
    _build.check(code, "fused_mlp_train_pack")
    LAUNCHES["fused_mlp_train_pack"] += 1
    return PackedMLP(widths, w, b)


def _launch_forward(x: torch.Tensor, pack: PackedMLP, plan: TrainPlan,
                    passes: int = 3) -> torch.Tensor:
    """The forward kernel on checked CUDA tensors; ``passes`` as kernel 2's
    (3 forms float32's products; 1 and 2 exist for the card's planted-fault
    check)."""
    f = plan.forward
    out = torch.empty((x.shape[0], pack.widths[-1]), dtype=torch.float32,
                      device=x.device)
    act = torch.empty(plan.act, dtype=torch.bfloat16, device=x.device)
    code = _launch_on(
        x.device, _build.load().cst_fused_mlp_train_fwd, x.data_ptr(),
        pack.w.data_ptr(), pack.b.data_ptr(), out.data_ptr(), act.data_ptr(),
        _c_widths(pack.widths), len(pack.widths) - 1, x.shape[0], f.nwg,
        f.nb, f.cluster, f.stages, passes)
    _build.check(code, "fused_mlp_train_fwd")
    LAUNCHES["fused_mlp_train_fwd"] += 1
    return out


def _fwd(x: torch.Tensor, ws, bs, tile_b: int = 128):
    """(y, the pack or None): the forward, and on the card the pack it
    read, for the backward."""
    widths = _check_net(x, ws, bs)
    if not _on_cuda(x, "fused_mlp_train_fwd"):
        return fused_mlp_train_fwd_plain(x, ws, bs), None
    if x.shape[0] == 0:
        return torch.empty((0, widths[-1]), device=x.device), None
    plan = _train_plan(x.shape[0], widths, tile_b, x.device)
    pack = pack_train_params(ws, bs)
    return _launch_forward(x, pack, plan), pack


def fused_mlp_train_fwd(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """(B, d_in) float32 -> (B, d_out) float32 through the network of
    float32 weights ``ws`` ((d_i, d_{i+1}) each) and biases ``bs``."""
    return _fwd(x, ws, bs)[0]


def _scratch(plan: TrainPlan, device) -> tuple[torch.Tensor, ...]:
    """The backward's scratch as ``plan`` sizes it: kernel 2's activations,
    the saved hidden h, x rounded, two dh buffers (bf16), the partials
    (float32)."""
    def empty(n, dtype=torch.bfloat16):
        return torch.empty(max(n, 1), dtype=dtype, device=device)

    return (empty(plan.act), empty(plan.save), empty(plan.xb),
            empty(plan.dh_buf), empty(plan.dh_buf),
            empty(plan.partial, torch.float32))


def _launch_backward(x: torch.Tensor, dy: torch.Tensor, pack: PackedMLP,
                     plan: TrainPlan):
    """(dW list, db list): the backward kernel on checked CUDA tensors of
    at least one row, as ``plan`` tiles it."""
    widths = plan.widths
    dws = [torch.empty((i, o), dtype=torch.float32, device=x.device)
           for i, o in zip(widths[:-1], widths[1:])]
    dbs = [torch.empty(o, dtype=torch.float32, device=x.device)
           for o in widths[1:]]
    act, save, xb, dh0, dh1, partial = _scratch(plan, x.device)
    code = _launch_on(
        x.device, _build.load().cst_fused_mlp_train_bwd, x.data_ptr(),
        dy.data_ptr(), pack.w.data_ptr(), pack.b.data_ptr(), _ptrs(dws),
        _ptrs(dbs), _c_widths(widths), len(widths) - 1, x.shape[0],
        plan.args(), act.data_ptr(), save.data_ptr(), xb.data_ptr(),
        dh0.data_ptr(), dh1.data_ptr(), partial.data_ptr(), plan.partial)
    _build.check(code, "fused_mlp_train_bwd")
    LAUNCHES["fused_mlp_train_bwd"] += 1
    return dws, dbs


def fused_mlp_train_bwd(x: torch.Tensor, dy: torch.Tensor, ws, bs,
                        tile_b: int = 128, pack: PackedMLP | None = None):
    """(dW list, db list) for the loss gradient ``dy`` (B, d_out) of
    ``fused_mlp_train_fwd(x, ws, bs)``.  ``pack``: the forward's (else
    packed here)."""
    widths = _check_net(x, ws, bs)
    _check(dy, "dy", torch.float32, (x.shape[0], widths[-1]), x.device)
    rows = x.shape[0]
    if tile_b < 1:
        raise ValueError(f"tile_b {tile_b}: want >= 1")
    if not _on_cuda(x, "fused_mlp_train_bwd"):
        return fused_mlp_train_bwd_plain(x, dy, ws, bs)
    if rows == 0:
        return ([torch.zeros_like(w) for w in ws],
                [torch.zeros_like(b) for b in bs])
    plan = _train_plan(rows, widths, tile_b, x.device)
    return _launch_backward(x, dy, pack or pack_train_params(ws, bs), plan)


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------
def _function(fwd, bwd):
    """The autograd.Function of fwd(x, ws, bs, tile_b) -> (y, state) whose
    backward is bwd(x, dy, ws, bs, tile_b, state) -> (dW list, db list)."""
    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, tile_b, n, *params):
            ws, bs = params[:n], params[n:]
            ctx.save_for_backward(x, *params)
            ctx.tile_b, ctx.n = tile_b, n
            y, ctx.state = fwd(x, ws, bs, tile_b)
            return y

        @staticmethod
        def backward(ctx, dy):
            x, *params = ctx.saved_tensors
            n = ctx.n
            dws, dbs = bwd(x, dy.contiguous(), params[:n], params[n:],
                           ctx.tile_b, ctx.state)
            ctx.state = None
            # no gradient for the input batch (data), as the JAX VJP
            return (torch.zeros_like(x), None, None, *dws, *dbs)

    return Fn


def _kernel_bwd(x, dy, ws, bs, tile_b, pack):
    return fused_mlp_train_bwd(x, dy, ws, bs, tile_b, pack)


def _plain_fwd(x, ws, bs, tile_b):
    return fused_mlp_train_fwd_plain(x, ws, bs), None


def _plain_bwd(rounded, x, dy, ws, bs, tile_b, state):
    del tile_b, state   # the plain backward sums the whole batch at once
    return fused_mlp_train_bwd_plain(x, dy, ws, bs, rounded)


_KERNEL_FN = _function(_fwd, _kernel_bwd)
_PLAIN_FN = {r: _function(_plain_fwd, functools.partial(_plain_bwd, r))
             for r in (True, False)}


def _make(fn, widths, tile_b: int = 128):
    widths = tuple(int(w) for w in widths)

    def apply(x, ws, bs):
        if (x.shape[-1],) + tuple(w.shape[-1] for w in ws) != widths:
            raise ValueError(f"parameters do not match widths {widths}")
        return fn.apply(x, tile_b, len(ws), *ws, *bs)

    return apply


def make_fused_mlp_train(widths, tile_b: int = 128):
    """fn(x, weights, biases) -> (B, d_out), differentiable in the weights
    and biases through the fused backward (dx is zero).  On the card both
    directions are the kernels; on the CPU their plain versions.  Widths
    the kernels cannot take raise here (``check_train_widths``), and on
    the card every call plans for its batch before it launches
    (``plan_mlp_train``), so a batch the card cannot take raises before
    the step."""
    if tile_b < 1:
        raise ValueError(f"tile_b {tile_b}: want >= 1")
    return _make(_KERNEL_FN, check_train_widths(widths), tile_b)


def make_fused_mlp_train_plain(widths, rounded: bool = True):
    """The same function through the plain versions on any device: the
    reference the kernels are held to.  ``rounded=False`` takes the
    float32 control backward (fused_mlp_train_bwd_plain)."""
    return _make(_PLAIN_FN[rounded], widths)
