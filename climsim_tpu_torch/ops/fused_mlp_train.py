"""Fused MLP training: a forward and a backward kernel tied together by a
``torch.autograd.Function`` (the counterpart of
``climsim_tpu.ops.fused_mlp_train``, kernel 6).

The network is a relu trunk with a linear last layer (the OnlineMLP / RPN
member shape), ``widths = (d_in, h_1, ..., d_out)``:

  * forward (``csrc/fused_mlp_train_fwd.cu``): the whole network in one
    launch, float32 activations times the float32 weights rounded to bf16
    inside the kernel, float32 sums; nothing is saved but the input;
  * backward (``csrc/fused_mlp_train_bwd.cu``): recomputes the forward
    with the forward's own device code (so the relu masks agree bit for
    bit), then layer by layer dW = bf16(h)^T bf16(dh) and db = sum(dh)
    with float32 sums, and dh <- bf16(dh) bf16(W)^T masked by h > 0.  It
    returns dW and db, and zeros for x (the input is data).

On the card the recomputed activations go to a scratch in device memory
(``torch.empty``, sized here) instead of staying on chip as in VMEM; each
block of a dW product sums ``tile_b`` batch rows and the partials are
added in a fixed order, so two runs give the same bits.  ``tile_b`` is the
batch rows a block of the backward takes, as in the Pallas kernel.

The functions take the plain versions (``*_plain``, the same math in
torch, with the Pallas kernel's bf16 roundings at
climsim_tpu/ops/fused_mlp_train.py:87-106) for tensors on the CPU and
launch the kernels for tensors on a CUDA device, counting each launch in
``kernels.LAUNCHES``.  The JAX module's ``vmem_estimate_bytes`` is a TPU
VMEM budget and has no counterpart here.
"""

from __future__ import annotations

import ctypes
from functools import partial

import torch

from . import _build
from .kernels import LAUNCHES, MAX_LAYERS, _check, _on_cuda, _stream, \
    _tile_rows


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


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------
def _ptrs(ts) -> ctypes.Array:
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def fused_mlp_train_fwd(x: torch.Tensor, ws, bs) -> torch.Tensor:
    """(B, d_in) float32 -> (B, d_out) float32 through the network of
    float32 weights ``ws`` ((d_i, d_{i+1}) each) and biases ``bs``."""
    widths = _check_net(x, ws, bs)
    if not _on_cuda(x, "fused_mlp_train_fwd"):
        return fused_mlp_train_fwd_plain(x, ws, bs)
    out = torch.empty((x.shape[0], widths[-1]), dtype=torch.float32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.cst_fused_mlp_train_fwd(
            x.data_ptr(), _ptrs(ws), _ptrs(bs), out.data_ptr(),
            (ctypes.c_int * len(widths))(*widths), len(ws), x.shape[0],
            _tile_rows(x.shape[0], x.device), _stream(x.device))
    _build.check(code, "fused_mlp_train_fwd")
    LAUNCHES["fused_mlp_train_fwd"] += 1
    return out


def fused_mlp_train_bwd(x: torch.Tensor, dy: torch.Tensor, ws, bs,
                        tile_b: int = 128):
    """(dW list, db list) for the loss gradient ``dy`` (B, d_out) of
    ``fused_mlp_train_fwd(x, ws, bs)``."""
    widths = _check_net(x, ws, bs)
    _check(dy, "dy", torch.float32, (x.shape[0], widths[-1]), x.device)
    rows = x.shape[0]
    if not 1 <= tile_b or -(-rows // tile_b) > 65535:
        raise ValueError(f"tile_b {tile_b}: want >= 1 and at most 65535 "
                         f"tiles of the batch of {rows}")
    if not _on_cuda(x, "fused_mlp_train_bwd"):
        return fused_mlp_train_bwd_plain(x, dy, ws, bs)
    dws = [torch.empty_like(w) for w in ws]
    dbs = [torch.empty_like(b) for b in bs]
    if rows == 0:
        return [d.zero_() for d in dws], [d.zero_() for d in dbs]
    hidden = widths[1:-1]
    chunks = -(-rows // tile_b)
    max_w = max(i * o for i, o in zip(widths[:-1], widths[1:]))

    def scratch(n):
        return torch.empty(max(n, 1), dtype=torch.float32, device=x.device)

    h = scratch(rows * sum(hidden))
    dh = scratch(2 * rows * max(hidden, default=0))
    partial = scratch(chunks * (max_w + max(widths[1:])) if chunks > 1 else 0)
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.cst_fused_mlp_train_bwd(
            x.data_ptr(), dy.data_ptr(), _ptrs(ws), _ptrs(bs), _ptrs(dws),
            _ptrs(dbs), (ctypes.c_int * len(widths))(*widths), len(ws), rows,
            tile_b, _tile_rows(rows, x.device), h.data_ptr(), dh.data_ptr(),
            partial.data_ptr(), _stream(x.device))
    _build.check(code, "fused_mlp_train_bwd")
    LAUNCHES["fused_mlp_train_bwd"] += 1
    return dws, dbs


# --------------------------------------------------------------------------
# autograd
# --------------------------------------------------------------------------
def _function(fwd, bwd):
    """The autograd.Function of fwd(x, ws, bs) whose backward is
    bwd(x, dy, ws, bs, tile_b) -> (dW list, db list)."""
    class Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, tile_b, n, *params):
            ws, bs = params[:n], params[n:]
            ctx.save_for_backward(x, *params)
            ctx.tile_b, ctx.n = tile_b, n
            return fwd(x, ws, bs)

        @staticmethod
        def backward(ctx, dy):
            x, *params = ctx.saved_tensors
            n = ctx.n
            dws, dbs = bwd(x, dy.contiguous(), params[:n], params[n:],
                           ctx.tile_b)
            # no gradient for the input batch (data), as the JAX VJP
            return (torch.zeros_like(x), None, None, *dws, *dbs)

    return Fn


def _plain_bwd(rounded, x, dy, ws, bs, tile_b):
    del tile_b   # the plain backward sums the whole batch at once
    return fused_mlp_train_bwd_plain(x, dy, ws, bs, rounded)


_KERNEL_FN = _function(fused_mlp_train_fwd, fused_mlp_train_bwd)
_PLAIN_FN = {r: _function(fused_mlp_train_fwd_plain, partial(_plain_bwd, r))
             for r in (True, False)}


def _make(fn, widths, tile_b: int | None = None):
    widths = tuple(int(w) for w in widths)

    def apply(x, ws, bs):
        if (x.shape[-1],) + tuple(w.shape[-1] for w in ws) != widths:
            raise ValueError(f"parameters do not match widths {widths}")
        return fn.apply(x, tile_b, len(ws), *ws, *bs)

    return apply


def make_fused_mlp_train(widths, tile_b: int = 128):
    """fn(x, weights, biases) -> (B, d_out), differentiable in the weights
    and biases through the fused backward (dx is zero).  On the card both
    directions are the kernels; on the CPU their plain versions."""
    if tile_b < 1:
        raise ValueError(f"tile_b {tile_b}: want >= 1")
    return _make(_KERNEL_FN, widths, tile_b)


def make_fused_mlp_train_plain(widths, rounded: bool = True):
    """The same function through the plain versions on any device: the
    reference the kernels are held to.  ``rounded=False`` takes the
    float32 control backward (fused_mlp_train_bwd_plain)."""
    return _make(_PLAIN_FN[rounded], widths)
