"""Work of the U-Net's fused GroupNorm -> silu -> conv3 chains (kernel 5
and the backward of 5'), counted from shapes.

``chain_census`` counts the chains of one forward from the configuration
(the rule of ``ClimSimUNet.fused_chains`` in
``climsim_tpu_torch/models/unet.py`` at commit ad9d7d2: chain 0 of every
block that does not resample, chain 1 of every block, when the batch is a
multiple of 16); ``chain_bound_ms`` and ``chain_bwd_bound_ms`` are frozen
copies of those in ``climsim_tpu_torch/bench_gn_conv3.py`` at ad9d7d2.
"""

from __future__ import annotations

import re

from .peaks import BF16_FLOPS, HBM_BYTES_S


def chain_census(cfg: dict) -> dict:
    """{(L, C, Cout): chains in one forward} of the configuration."""
    from ..reference.unet_v5 import Block, Model
    import torch

    with torch.device("meta"):
        model = Model(cfg)
    out: dict = {}
    for name, m in model.named_children():
        if not isinstance(m, Block):
            continue
        res = int(re.match(r"(?:enc|dec)(\d+)_", name).group(1))
        cin = m.conv0.weight.shape[1]
        cout = m.conv0.weight.shape[0]
        keys = [(res, cout, cout)]
        if not (m.up or m.down):
            keys.append((res, cin, cout))
        for k in keys:
            out[k] = out.get(k, 0) + 1
    return out


def chain_bound_ms(b: int, l: int, c: int, cout: int) -> tuple:
    """(least time in ms, "bytes" or "operations") of one chain call: x in
    and y out (float32), gamma, beta and bias, the bf16 weights, each once;
    its products at the bf16 peak."""
    nbytes = 4 * b * l * (c + cout) + 4 * (2 * c + cout) + 2 * 3 * c * cout
    ops = 2 * b * l * 3 * c * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def chain_bwd_bound_ms(b: int, l: int, c: int, cout: int) -> tuple:
    """(least time in ms, "bytes" or "operations") of one chain's backward:
    x and g read and dx written (float32), gamma and beta read, dgamma,
    dbeta and db written, the bf16 weights read and the float32 dw written,
    each once; dgrad's and wgrad's products at the bf16 peak."""
    nbytes = (4 * b * l * (2 * c + cout) + 4 * (4 * c + cout)
              + (2 + 4) * 3 * c * cout)
    ops = 2 * 2 * b * l * 3 * c * cout
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def forward_bound_ms(census: dict, b: int) -> float:
    """The least time of one forward's chains at batch ``b``."""
    return sum(n * chain_bound_ms(b, *k)[0] for k, n in census.items())


def backward_bound_ms(census: dict, b: int) -> float:
    """The least time of one backward's chains at batch ``b``."""
    return sum(n * chain_bwd_bound_ms(b, *k)[0] for k, n in census.items())
