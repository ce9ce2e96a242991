"""Coupling wrappers: raw host state in -> raw (B, 368) tendencies out.

The counterpart of ``climsim_tpu.online.wrapper``: the v5 wrapper of the
U-Net coupling (``make_wrapper``), the v4 wrapper (``make_v4_wrapper``)
and the v2_rh-family wrappers.  The reference wraps its trained torch
model with all pre/post-processing in the graph
(online_testing/model_postprocessing/v5_nn_wrapper.ipynb,
v4_nn_wrapper.ipynb and v2_nn_wrapper.ipynb; coupling contract in
online_testing/README.md section 3.1).  Here a wrapper is a closure over
tensors on ``device``: fn(x_raw (B, n_raw)) -> (B, 368).

``export_aot`` saves a wrapper as a ``torch.export`` program with its
weights, at one fixed batch, and ``load_aot`` loads it: the counterpart of
the JAX package's StableHLO artifact, and of the TorchScript wrapper the
reference hands E3SM.
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
    oracle = _oracle(cfg.dtype, dev)
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
        x_raw = x_raw.to(device=dev, dtype=cfg.dtype).contiguous()
        # views of the raw row: the head reads them in place
        t_before = x_raw[:, 0:60]
        if cfg.input_version == "v4":
            qc_before = x_raw[:, 120:180]
            qi_before = x_raw[:, 180:240]
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


def _oracle(dtype: torch.dtype, dev: torch.device) -> bool:
    """True for the float64 wrapper (the plain versions, on the CPU only),
    False for float32; raise for anything else."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype {dtype}: want float32 or float64")
    if dtype == torch.float64 and dev.type != "cpu":
        raise ValueError("the float64 wrapper is the plain CPU path; the "
                         f"kernels on {dev} take float32")
    return dtype == torch.float64


def _out_zero_mask(spec: VarSpec, depths: dict | None, device,
                   dtype=torch.float32) -> torch.Tensor:
    mask = np.ones(spec.output_len, np.float64)
    for v, n in (depths or {}).items():
        s = spec.output_slices[v].start
        mask[s: s + n] = 0.0
    return torch.as_tensor(mask, dtype=dtype, device=device)


def _out_scale_inv(stats: NormStats, device,
                   dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(1.0 / stats.out_scale, dtype=dtype,
                           device=device)


def _raw_wrapper(model_apply: Callable, stats: NormStats, spec: VarSpec,
                 tcfg: T.TransformConfig, out_zero: dict | None, device,
                 dtype: torch.dtype) -> Callable:
    """fn(x_raw) -> model_apply(transform(x_raw)) * zero * 1 / out_scale:
    the v4- and v2_rh-family wrappers.  float32 runs the input transform
    kernel; float64 its plain version (the CPU's oracle-parity path, as
    the JAX wrappers' ``dtype``)."""
    dev = torch.device(device)
    if _oracle(dtype, dev):
        consts = T.input_transform_consts(spec, stats, tcfg, dev, dtype)
        in_t = lambda x: K.fused_input_transform_plain(  # noqa: E731
            x.to(device=dev, dtype=dtype), consts)
    else:
        in_t = T.make_input_transform(spec, stats, tcfg, dev)
    zero = _out_zero_mask(spec, out_zero, dev, dtype)
    out_scale_inv = _out_scale_inv(stats, dev, dtype)

    def wrapper(x_raw: torch.Tensor) -> torch.Tensor:
        return model_apply(in_t(x_raw)) * zero * out_scale_inv

    return wrapper


def make_v4_wrapper(model_apply: Callable, stats: NormStats,
                    spec: VarSpec | None = None,
                    tcfg: T.TransformConfig | None = None,
                    out_zero: dict | None = None,
                    device="cuda", dtype=torch.float32) -> Callable:
    """v4-family coupling wrapper: the host sends the raw v4 (B, 1525)
    feature vector, the model takes it natively (no v5 conversion) and the
    host receives the raw 368-wide tendencies with no cloud repartition
    (v4_nn_wrapper.ipynb NewModel: qc/qi exponential transform ->
    normalize -> nan/inf -> 0 -> cloud-input prune -> RH clip -> model ->
    stratosphere zeroing -> un-scale).

    ``model_apply(x_norm)`` maps normalized (B, 1525) columns to the
    normalized (B, 368) output, e.g. ``partial(unet_apply_fused, model)``
    for the ``unet_v4`` preset.  The input transform is the
    ``fused_input_transform`` kernel, with the qc/qi rates where ``tcfg``
    asks for them (the default does); ``dtype=torch.float64`` runs its
    plain version, on the CPU only (``climsim_tpu/online/wrapper.py:147``'s
    ``dtype``)."""
    spec = spec or get_varspec("v4")
    tcfg = tcfg or T.TransformConfig(
        qn_transform=True, qinput_prune=True, strato_lev=15,
        input_clip=True, input_clip_rhonly=True)
    return _raw_wrapper(model_apply, stats, spec, tcfg,
                        V4_OUT_ZERO if out_zero is None else out_zero,
                        device, dtype)


def make_v2rh_wrapper(model: Callable, stats: NormStats,
                      spec: VarSpec | None = None,
                      tcfg: T.TransformConfig | None = None,
                      out_zero: dict | None = None,
                      device="cuda", dtype=torch.float32) -> Callable:
    """Wrapper for v2_rh-family online models (MLP_v2rh): normalize in,
    un-scale out; ``model`` maps normalized (B, 557) to the (B, 368)
    contract layout (v2_nn_wrapper.ipynb is the same flow without cloud
    repartitioning).

    The defaults keep the repo's online models' contract (clip-only: they
    train without the qc/qi exponential transform).  The reference's
    published v2 wrapper behavior is ``tcfg`` with the qc/qi rates and
    cloud-input pruning plus ``out_zero=V4_OUT_ZERO``.  ``dtype`` as in
    ``make_v4_wrapper`` (``climsim_tpu/online/wrapper.py:174``)."""
    spec = spec or get_varspec("v2_rh")
    tcfg = tcfg or T.TransformConfig(input_clip=True, input_clip_rhonly=True)
    return _raw_wrapper(model, stats, spec, tcfg, out_zero, device, dtype)


def make_fast_mlp_wrapper(model, stats: NormStats,
                          spec: VarSpec | None = None,
                          weights_dtype=torch.bfloat16,
                          device="cuda", max_batch: int = 6144) -> Callable:
    """Latency-oriented v2_rh wrapper: the input transform kernel, then the
    whole ``OnlineMLP`` in one fused-MLP kernel launch.

    ``weights_dtype`` is torch.float32, torch.bfloat16 or ``"int8"``
    (weight-only, per-output-channel scales); the weights are read from
    ``model`` and packed once, here, where the kernel's plan is checked at
    one row and at ``max_batch`` rows (the server's): a network the kernel
    cannot take raises now, not at a request.  Returns fn(x_raw) -> (B,
    368).

    As in the reference, this path does not apply ``OnlineMLP``'s
    ``output_prune``: it serves the plain network.
    """
    spec = spec or get_varspec("v2_rh")
    in_t = T.make_input_transform(spec, stats, T.TransformConfig(
        input_clip=True, input_clip_rhonly=True), device)
    ws, bs = K.mlp_params_to_matrices(model.state_dict())
    mlp = K.pack_mlp(ws, bs, weights_dtype, device)
    K.check_mlp_forward(mlp, device, (1, max_batch))
    forward = (K.fused_mlp_forward_int8 if weights_dtype == "int8"
               else K.fused_mlp_forward)
    n_relu = len(spec.output_scalar_vars)
    out_scale_inv = _out_scale_inv(stats, device)

    def wrapper(x_raw: torch.Tensor) -> torch.Tensor:
        return forward(in_t(x_raw), mlp, n_relu) * out_scale_inv

    return wrapper


class _Program(torch.nn.Module):
    """The module ``torch.export`` traces: ``fn`` as its forward."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


def export_aot(wrapper: Callable, batch: int, n_features: int, path: str,
               device="cuda") -> torch.export.ExportedProgram:
    """Save ``wrapper`` as a ``torch.export`` program at ``path`` (``.pt2``)
    for (batch, n_features) float32 inputs on ``device``, and return it.

    The counterpart of ``climsim_tpu/online/wrapper.py:201`` (a StableHLO
    artifact; here a program ``torch.export.load`` reads): one fixed
    batch, the weights embedded, no model source needed to run it.

    The wrapper runs once on zeros first: that prepares the U-Net engine's
    weights (the program holds the prepared bf16 kernels, not the module's
    float32 parameters) and builds the kernels.  Then it is traced: the
    kernels (input transform, constraint head, GroupNorm -> silu -> conv3)
    enter the program as operators of torch.library (``ops``), so the
    loaded program launches them on a CUDA device, as the live wrapper
    does, and takes their plain versions on the CPU.  The program keeps
    ``device``: one exported on the card loads and runs only there.
    """
    x = torch.zeros((batch, n_features), dtype=torch.float32, device=device)
    with torch.inference_mode(False), torch.no_grad():
        wrapper(x)
        program = torch.export.export(_Program(wrapper), (x,))
    program.example_inputs = None   # else saved with it: (batch, n) zeros
    torch.export.save(program, path)
    return program


def load_aot(path: str) -> Callable:
    """A program saved by ``export_aot`` -> fn(x (batch, n_features)) ->
    (batch, 368), on the device it was exported on.  Importing ``ops``
    registers the kernels' operators; the kernels build at their first
    CUDA launch."""
    from .. import ops  # noqa: F401  (registers the kernels' operators)

    return torch.export.load(path).module()
