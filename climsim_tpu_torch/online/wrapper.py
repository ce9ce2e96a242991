"""Coupling wrappers: raw host state in -> raw (B, 368) tendencies out.

The counterpart of ``climsim_tpu.online.wrapper``: the v5 wrapper of the
U-Net coupling (``make_wrapper``) and the v2_rh-family wrappers.  The
reference wraps its trained torch model with all pre/post-processing in
the graph (online_testing/model_postprocessing/v5_nn_wrapper.ipynb and
v2_nn_wrapper.ipynb; coupling contract in online_testing/README.md
section 3.1).  Here a wrapper is a closure over tensors on ``device``:
fn(x_raw (B, n_raw)) -> (B, 368).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import physics
from ..data import transforms as T
from ..norms import NormStats
from ..ops import kernels as K
from ..varspec import VarSpec, get_varspec


def convert_v4_to_v5(x: torch.Tensor) -> torch.Tensor:
    """v4 (B, 1525) raw features -> v5 (B, 1405).

    Index map from v5_nn_wrapper.ipynb `preprocessing` (qn = qc + qi,
    liq_partition from the T ramp, prvphy/tm blocks re-packed):
      [0:120)    t, rh                  <- v4 [0:120)
      [120:180)  qn                     <- v4 q2 + q3
      [180:240)  liq_partition          <- ramp(v4 t)
      [240:840)  u..q1_prvphy (10 prof) <- v4 [240:840)
      [840:900)  qn_prvphy              <- v4 q2_prv + q3_prv
      [900:1080) u_prv, tm_t_prv, tm_q1_prv <- v4 [960:1140)
      [1080:1140) tm_qn_prv             <- v4 tm_q2_prv + tm_q3_prv
      [1140:1405) tail                  <- v4 [1260:1525)
    """
    return torch.cat([
        x[:, 0:120],
        x[:, 120:180] + x[:, 180:240],
        physics.liquid_fraction(x[:, 0:60]),
        x[:, 240:840],
        x[:, 840:900] + x[:, 900:960],
        x[:, 960:1140],
        x[:, 1140:1200] + x[:, 1200:1260],
        x[:, 1260:1525],
    ], dim=1)


@dataclass
class WrapperConfig:
    input_version: str = "v4"       # what the host sends: 'v4' | 'v5'
    strato_lev_out: int = 15        # postprocess zeroing depth
    qn_prune_lev: int = 15          # qn input prune depth
    dt_seconds: float = physics.DT_TIMESTEP
    # float64 is the oracle-parity path: the plain versions on the CPU
    dtype: torch.dtype = torch.float32


def make_wrapper(model_apply: Callable, stats: NormStats,
                 cfg: WrapperConfig | None = None,
                 device="cuda") -> Callable:
    """Build fn(x_raw) -> (B, 368) raw tendencies for a v5 model.

    ``model_apply(x_norm)`` maps normalized v5 (B, 1405) columns to the
    normalized (B, 308) v5 output, e.g. ``partial(unet_apply_fused,
    model)``.  The input transform (cloud rate on ``state_qn``, its
    stratosphere pruned, RH clipped) runs on the ``fused_input_transform``
    kernel and the postprocess on the ``fused_constraint_head`` kernel;
    ``cfg.dtype=torch.float64`` runs both as their plain versions, on the
    CPU only.
    """
    cfg = cfg or WrapperConfig()
    dev = torch.device(device)
    if cfg.input_version not in ("v4", "v5"):
        raise ValueError(f"input_version {cfg.input_version!r}: want 'v4' "
                         "or 'v5'")
    if cfg.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {cfg.dtype}: want float32 or float64")
    oracle = cfg.dtype == torch.float64
    if oracle and dev.type != "cpu":
        raise ValueError("the float64 wrapper is the plain CPU path; the "
                         f"kernels on {dev} take float32")
    spec5 = get_varspec("v5")
    tcfg = T.TransformConfig(
        qn_transform=True, qinput_prune=True, strato_lev=cfg.qn_prune_lev,
        input_clip=True, input_clip_rhonly=True)
    head_consts = K.constraint_head_consts(stats.out_scale,
                                           cfg.strato_lev_out, cfg.dtype, dev)
    if oracle:
        in_consts = T.input_transform_consts(spec5, stats, tcfg, dev,
                                             torch.float64)
        in_t = lambda x: K.fused_input_transform_plain(x, in_consts)
        head = K.fused_constraint_head_plain
    else:
        in_t = T.make_input_transform(spec5, stats, tcfg, dev)
        head = K.fused_constraint_head
    qn_sl = spec5.input_slices["state_qn"]
    liq_sl = spec5.input_slices["liq_partition"]

    def wrapper(x_raw: torch.Tensor) -> torch.Tensor:
        x_raw = x_raw.to(device=dev, dtype=cfg.dtype)
        t_before = x_raw[:, 0:60].contiguous()
        if cfg.input_version == "v4":
            qc_before = x_raw[:, 120:180].contiguous()
            qi_before = x_raw[:, 180:240].contiguous()
            x5 = convert_v4_to_v5(x_raw)
        else:  # host already sends v5 features; clouds arrive combined
            qn, liq = x_raw[:, qn_sl], x_raw[:, liq_sl]
            qc_before, qi_before = liq * qn, (1 - liq) * qn
            x5 = x_raw
        y = model_apply(in_t(x5)).to(cfg.dtype).contiguous()  # (B, 308)
        return head(y, t_before, qc_before, qi_before, head_consts,
                    cfg.dt_seconds)

    return wrapper

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
                      device="cuda") -> Callable:
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
                          device="cuda") -> Callable:
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
