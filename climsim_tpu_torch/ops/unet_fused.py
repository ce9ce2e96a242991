"""GroupNorm -> silu -> conv3, the U-Net half-block, as one CUDA kernel.

The counterpart of ``climsim_tpu.ops.unet_fused``: the EDM half-block

    GroupNorm(float32 two-pass statistics) -> silu -> bf16 -> Conv1d(k=3,
    bf16 x bf16 products summed in float32) + float32 bias

in one launch (``ops/csrc/fused_gn_silu_conv3.cu``), so the normalized
activations never leave the chip.  Layout is the JAX package's,
channels-last: x (B, L, C), w (3, C, Cout) as flax keeps a conv kernel.

As in ``ops.kernels``: the public function checks its arguments, takes the
plain version for a tensor on the CPU and launches the kernel for a tensor
on a CUDA device (no fallback), and counts each launch in
``kernels.LAUNCHES["fused_gn_silu_conv3"]``.  The custom VJP of the JAX
module (``make_trainable_fused_block``) comes with U-Net training.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models.unet import _num_groups
from . import _build
from .kernels import LAUNCHES, _check, _on_cuda, _stream

EPS = 1e-6
MAX_LEVELS = 64   # kMaxRowTiles * 16 in the kernel


def fused_gn_silu_conv3_plain(x: torch.Tensor, gamma: torch.Tensor,
                              beta: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor) -> torch.Tensor:
    """``xla_gn_silu_conv3(f32_accum=True)`` in torch; the products are
    taken in ``w``'s dtype (bf16, or float32 for the float32-compute
    models), widened to float32, where bf16 products are exact."""
    bsz, l, c = x.shape
    groups = _num_groups(c)
    xg = x.reshape(bsz, l, groups, c // groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + EPS)).reshape(x.shape)
    xn = F.silu(xn * gamma + beta).to(w.dtype).to(x.dtype)
    y = F.conv1d(xn.transpose(1, 2), w.to(x.dtype).permute(2, 1, 0),
                 padding=1).transpose(1, 2)
    return y + b


def fused_gn_silu_conv3(x: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, w: torch.Tensor,
                        b: torch.Tensor) -> torch.Tensor:
    """x (B, L, C) float32, gamma/beta (C,) float32, w (3, C, Cout) bf16
    (cast once, when the weights are prepared), b (Cout,) float32 ->
    (B, L, Cout) float32, with ``_num_groups(C)`` groups and eps 1e-6.  On
    the CPU, w may also be float32 (the float32-compute path); the kernel
    takes bf16 only."""
    dev = x.device
    _check(x, "x", torch.float32, (None, None, None), dev)
    bsz, l, c = x.shape
    if w.dim() != 3:
        raise ValueError(f"w: want (3, {c}, Cout), got {tuple(w.shape)}")
    cout = w.shape[2]
    _check(w, "w", w.dtype, (3, c, cout), dev)
    for name, t, n in (("gamma", gamma, c), ("beta", beta, c), ("b", b, cout)):
        _check(t, name, torch.float32, (n,), dev)
    if not _on_cuda(x, "fused_gn_silu_conv3"):
        if w.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"w: want bf16 or float32, got {w.dtype}")
        return fused_gn_silu_conv3_plain(x, gamma, beta, w, b)
    if w.dtype != torch.bfloat16:
        raise TypeError(f"w: the kernel takes bf16 weights, got {w.dtype}")
    groups = _num_groups(c)
    if (not 1 <= l <= MAX_LEVELS or c % 64 or (c // groups) % 4
            or cout % 16 or bsz > 65535):
        raise ValueError(f"the kernel takes L <= {MAX_LEVELS}, C a multiple "
                         "of 64 with C / groups a multiple of 4, Cout a "
                         f"multiple of 16 and B <= 65535; got B={bsz}, "
                         f"L={l}, C={c}, Cout={cout}")
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (vector loads)")
    rows = -(-l // 16) * 16
    smem = ((rows + 2) * (c + 16) * 2 + max(3 * 64 * 136 * 2, rows * 128 * 4)
            + 8 * groups)
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"C={c} at L={l} needs {smem} B of shared memory; "
                         f"the card has {limit}")
    out = torch.empty((bsz, l, cout), dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(dev):
        code = lib.cst_fused_gn_silu_conv3(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), bsz, l, c, cout, groups, EPS,
            _stream(dev))
    _build.check(code, "fused_gn_silu_conv3")
    LAUNCHES["fused_gn_silu_conv3"] += 1
    return out
