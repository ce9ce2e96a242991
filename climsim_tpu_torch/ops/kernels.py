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
MLP-training kernel's forward and backward are in ``ops/fused_mlp_train.py``;
they count their launches here too.

Each public function checks its arguments, then takes the plain version
for a tensor on the CPU and launches its kernel for a tensor on a CUDA
device; there is no fallback from the kernel to the plain version.  Each
launch adds one to ``LAUNCHES[<name>]``, so a run can show that it went
through the kernels.  The ``*_plain`` functions hold the same math in
PyTorch: the CPU path, and the reference the kernels are checked against
on the card.

No lane padding: the kernels mask their own ragged edges.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from .. import physics
from ..varspec import NUM_LEVELS
from . import _build

LAUNCHES = {"fused_input_transform": 0, "fused_mlp_forward": 0,
            "fused_mlp_forward_int8": 0, "fused_constraint_head": 0,
            "fused_gn_silu_conv3": 0, "fused_mlp_train_fwd": 0,
            "fused_mlp_train_bwd": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (None matches any size) on ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: want a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: want {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
            want is not None and got != want
            for got, want in zip(t.shape, shape)):
        raise ValueError(f"{name}: want shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, want {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _on_cuda(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (take the plain version); raise for any other device."""
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"{what}: no kernel or plain path for {x.device}")


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


# --------------------------------------------------------------------------
# fused input transform
# --------------------------------------------------------------------------
TRANSFORM_ROWS = ("sub", "divinv", "mask", "lo", "hi", "lbd", "is_cloud")


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
    return torch.clamp(x, lo, hi)


def fused_input_transform(x: torch.Tensor,
                          consts: torch.Tensor) -> torch.Tensor:
    """Raw (B, D) float32 -> normalized (B, D) float32; ``consts`` from
    ``transform_consts``."""
    _check(consts, "consts", torch.float32, (len(TRANSFORM_ROWS), None),
           consts.device)
    _check(x, "x", torch.float32, (None, consts.shape[1]), consts.device)
    if not _on_cuda(x, "fused_input_transform"):
        return fused_input_transform_plain(x, consts)
    out = torch.empty_like(x)
    if x.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = lib.cst_fused_input_transform(
            x.data_ptr(), consts.data_ptr(), out.data_ptr(), x.shape[0],
            x.shape[1], _stream(x.device))
    _build.check(code, "fused_input_transform")
    LAUNCHES["fused_input_transform"] += 1
    return out


# --------------------------------------------------------------------------
# fused constraint head (the U-Net v5 wrapper's postprocess)
# --------------------------------------------------------------------------
V5_OUT = 308        # t, q1, qn, u, v (60 each), 8 scalars
CONTRACT_OUT = 368  # t, q1, qc, qi, u, v (60 each), 8 scalars


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


def fused_constraint_head(y_norm: torch.Tensor, t: torch.Tensor,
                          qc: torch.Tensor, qi: torch.Tensor,
                          consts: torch.Tensor, dt: float) -> torch.Tensor:
    """Normalized v5 output (B, 308) and t, qc, qi before the step (B, 60),
    all float32 -> the raw (B, 368) coupling contract; ``consts`` from
    ``constraint_head_consts``, ``dt`` the coupling step in seconds."""
    _check(consts, "consts", torch.float32, (2, V5_OUT), consts.device)
    _check(y_norm, "y_norm", torch.float32, (None, V5_OUT), consts.device)
    for name, a in (("t", t), ("qc", qc), ("qi", qi)):
        _check(a, name, torch.float32, (y_norm.shape[0], NUM_LEVELS),
               consts.device)
    if not dt > 0:
        raise ValueError(f"dt {dt}: want a positive step")
    if not _on_cuda(y_norm, "fused_constraint_head"):
        return fused_constraint_head_plain(y_norm, t, qc, qi, consts, dt)
    out = torch.empty((y_norm.shape[0], CONTRACT_OUT), dtype=torch.float32,
                      device=y_norm.device)
    if y_norm.shape[0] == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(y_norm.device):
        code = lib.cst_fused_constraint_head(
            y_norm.data_ptr(), t.data_ptr(), qc.data_ptr(), qi.data_ptr(),
            consts.data_ptr(), out.data_ptr(), y_norm.shape[0], dt,
            _stream(y_norm.device))
    _build.check(code, "fused_constraint_head")
    LAUNCHES["fused_constraint_head"] += 1
    return out


# --------------------------------------------------------------------------
# fused MLP forward
# --------------------------------------------------------------------------
def _host_f32(a) -> torch.Tensor:
    """A numpy array or tensor as a contiguous float32 CPU tensor."""
    return torch.as_tensor(a).detach().to(
        device="cpu", dtype=torch.float32).contiguous()


MAX_LAYERS = 16  # kMaxLayers in csrc/common.cuh


@dataclass(frozen=True)
class PackedMLP:
    """A relu MLP's parameters in the layout of the fused-MLP kernels.

    ``w`` holds every layer's (d_in, d_out) row-major weights, one layer
    after the other, as float32, bfloat16 or int8; ``b`` every layer's
    float32 bias; ``scale`` every layer's float32 per-output-channel scale
    (int8 only).  ``widths`` is (d_in, h_1, ..., d_out).
    """

    widths: tuple[int, ...]
    w: torch.Tensor
    b: torch.Tensor
    scale: torch.Tensor | None = None

    def __post_init__(self):
        n_w = sum(i * o for i, o in zip(self.widths[:-1], self.widths[1:]))
        n_b = sum(self.widths[1:])
        if (self.w.numel() != n_w or self.b.numel() != n_b
                or (self.scale is not None and self.scale.numel() != n_b)):
            raise ValueError(f"buffers do not match widths {self.widths}")

    def layers(self):
        """Yield (w (d_in, d_out), b, scale or None) views per layer."""
        wo = bo = 0
        for din, dout in zip(self.widths[:-1], self.widths[1:]):
            s = None if self.scale is None else self.scale[bo:bo + dout]
            yield (self.w[wo:wo + din * dout].view(din, dout),
                   self.b[bo:bo + dout], s)
            wo += din * dout
            bo += dout


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
    scale = None
    if weights_dtype == "int8":
        qs, scales = quantize_weights_int8(ws)
        w = torch.cat([q.reshape(-1) for q in qs])
        scale = torch.cat(scales).to(device)
    elif weights_dtype in (torch.float32, torch.bfloat16):
        w = torch.cat([w.to(weights_dtype).reshape(-1) for w in ws])
    else:
        raise ValueError(f"weights_dtype {weights_dtype!r}: want "
                         "torch.float32, torch.bfloat16 or 'int8'")
    return PackedMLP(widths, w.to(device), torch.cat(bs).to(device), scale)


def _relu_tail(h: torch.Tensor, relu_tail: int) -> torch.Tensor:
    if relu_tail <= 0:
        return h
    d = h.shape[1]
    return torch.cat([h[:, :d - relu_tail], torch.relu(h[:, d - relu_tail:])],
                     dim=1)


def fused_mlp_forward_plain(x: torch.Tensor, mlp: PackedMLP,
                            relu_tail: int = 0) -> torch.Tensor:
    layers = list(mlp.layers())
    h = x
    for i, (w, b, _) in enumerate(layers):
        h = h @ w.float() + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return _relu_tail(h, relu_tail)


def fused_mlp_forward_int8_plain(x: torch.Tensor, mlp: PackedMLP,
                                 relu_tail: int = 0) -> torch.Tensor:
    layers = list(mlp.layers())
    h = x
    for i, (q, b, s) in enumerate(layers):
        # bf16 x bf16 products are exact in float32: the float32 product of
        # the rounded operands is the bf16 dot with float32 accumulation
        h = (h.to(torch.bfloat16).float() @ q.float()) * s + b
        if i < len(layers) - 1:
            h = torch.relu(h)
    return _relu_tail(h, relu_tail)


TILE_ROWS = (4, 16)  # the tile heights the kernels are built for


def _tile_rows(rows: int, device: torch.device) -> int:
    """Rows a block: 16 once every SM gets a block of 16 (fewer re-reads
    of the weights from L2), else 4, so B = 384 (one ne4 chunk) runs as 96
    blocks.  ``chip_smoke.py --profile`` times both heights; PERF.md keeps
    the readings."""
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    return 16 if rows >= 16 * n_sm else 4


def _launch_mlp(entry: str, x: torch.Tensor, mlp: PackedMLP,
                relu_tail: int, tile_rows: int | None = None) -> torch.Tensor:
    """Launch one fused-MLP entry; ``tile_rows`` (one of TILE_ROWS) fixes
    the tile height, which ``_tile_rows`` picks otherwise."""
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
    ptrs = [x.data_ptr(), mlp.w.data_ptr()]
    if mlp.scale is not None:
        ptrs.append(mlp.scale.data_ptr())
    ptrs += [mlp.b.data_ptr(), out.data_ptr()]
    lib = _build.load()
    with torch.cuda.device(x.device):
        code = getattr(lib, "cst_" + entry)(
            *ptrs, widths, len(mlp.widths) - 1, x.shape[0], relu_tail, tb,
            _stream(x.device))
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
            _check(t, name, t.dtype, (None,), x.device)
    _check(x, "x", torch.float32, (None, mlp.widths[0]), x.device)


def fused_mlp_forward(x: torch.Tensor, mlp: PackedMLP,
                      relu_tail: int = 0) -> torch.Tensor:
    """(B, d_in) float32 -> (B, d_out) float32 through an MLP packed with
    float32 or bf16 weights; relu on the last ``relu_tail`` outputs (the
    ClimSim surface scalars)."""
    _check_mlp(x, mlp, (torch.float32, torch.bfloat16), relu_tail)
    if not _on_cuda(x, "fused_mlp_forward"):
        return fused_mlp_forward_plain(x, mlp, relu_tail)
    entry = ("fused_mlp_forward_bf16" if mlp.w.dtype == torch.bfloat16
             else "fused_mlp_forward_f32")
    out = _launch_mlp(entry, x, mlp, relu_tail)
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
    out = _launch_mlp("fused_mlp_forward_int8", x, mlp, relu_tail)
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
