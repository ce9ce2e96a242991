"""Coupling wrappers: raw host state in -> raw (B, 368) tendencies out.

The counterpart of the v2_rh-family wrappers of
``climsim_tpu.online.wrapper``.  The reference wraps its trained torch model
with all pre/post-processing in the graph (online_testing/
model_postprocessing/v2_nn_wrapper.ipynb; coupling contract in
online_testing/README.md section 3.1).  Here a wrapper is a closure over
tensors on ``device``: fn(x_raw (B, 557)) -> (B, 368).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from climsim_tpu.norms import NormStats
from climsim_tpu.varspec import VarSpec, get_varspec

from ..data import transforms as T
from ..ops import kernels as K

# Output-zeroing depths the reference's v4/v2 coupling wrappers hardcode
# for the 368-wide layout (v4_nn_wrapper.ipynb / v2_nn_wrapper.ipynb
# postprocessing: x[:,60:75], x[:,120:148], x[:,180:195], x[:,240:255],
# x[:,300:315] -- note liquid cloud is zeroed 28 deep, matching the
# strato_lev_qc=28 those models train with).
V4_OUT_ZERO = {"ptend_q0001": 15, "ptend_q0002": 28, "ptend_q0003": 15,
               "ptend_u": 15, "ptend_v": 15}


def _out_zero_mask(spec: VarSpec, depths: dict | None,
                   device) -> torch.Tensor:
    mask = np.ones(spec.output_len, np.float64)
    for v, n in (depths or {}).items():
        s = spec.output_slices[v].start
        mask[s: s + n] = 0.0
    return torch.as_tensor(mask, dtype=torch.float32, device=device)


def _out_scale_inv(stats: NormStats, device) -> torch.Tensor:
    return torch.as_tensor(1.0 / stats.out_scale, dtype=torch.float32,
                           device=device)


def make_v2rh_wrapper(model: Callable, stats: NormStats,
                      spec: VarSpec | None = None,
                      tcfg: T.TransformConfig | None = None,
                      out_zero: dict | None = None,
                      device="cpu") -> Callable:
    """Wrapper for v2_rh-family online models (MLP_v2rh): normalize in,
    un-scale out; ``model`` maps normalized (B, 557) to the (B, 368)
    contract layout (v2_nn_wrapper.ipynb is the same flow without cloud
    repartitioning).

    The defaults keep the repo's online models' contract (clip-only: they
    train without the qc/qi exponential transform).  The reference's
    published v2 wrapper behavior is ``tcfg`` with the qc/qi rates and
    cloud-input pruning plus ``out_zero=V4_OUT_ZERO``."""
    spec = spec or get_varspec("v2_rh")
    tcfg = tcfg or T.TransformConfig(input_clip=True, input_clip_rhonly=True)
    in_t = T.make_input_transform(spec, stats, tcfg, device)
    zero = _out_zero_mask(spec, out_zero, device)
    out_scale_inv = _out_scale_inv(stats, device)

    def wrapper(x_raw: torch.Tensor) -> torch.Tensor:
        return model(in_t(x_raw)) * zero * out_scale_inv

    return wrapper


def make_fast_mlp_wrapper(model, stats: NormStats,
                          spec: VarSpec | None = None,
                          weights_dtype=torch.bfloat16,
                          device="cpu") -> Callable:
    """Latency-oriented v2_rh wrapper: the input transform kernel, then the
    whole ``OnlineMLP`` in one fused-MLP kernel launch.

    ``weights_dtype`` is torch.float32, torch.bfloat16 or ``"int8"``
    (weight-only, per-output-channel scales); the weights are read from
    ``model`` and packed once, here.  Returns fn(x_raw) -> (B, 368).

    As in the reference, this path does not apply ``OnlineMLP``'s
    ``output_prune``: it serves the plain network.
    """
    spec = spec or get_varspec("v2_rh")
    in_t = T.make_input_transform(spec, stats, T.TransformConfig(
        input_clip=True, input_clip_rhonly=True), device)
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    mlp = K.pack_mlp(ws, bs, weights_dtype, device)
    forward = (K.fused_mlp_forward_int8 if weights_dtype == "int8"
               else K.fused_mlp_forward)
    n_relu = len(spec.output_scalar_vars)
    out_scale_inv = _out_scale_inv(stats, device)

    def wrapper(x_raw: torch.Tensor) -> torch.Tensor:
        return forward(in_t(x_raw), mlp, n_relu) * out_scale_inv

    return wrapper
