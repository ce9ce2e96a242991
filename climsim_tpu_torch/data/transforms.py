"""Input/output feature transforms on tensors.

The counterpart of ``climsim_tpu.data.transforms``.  The input transform is
one kernel (``ops.kernels.fused_input_transform``): every switch of
``TransformConfig`` resolves here, at build time, into seven per-feature
constant vectors, and the kernel applies them in one pass.

Semantics mirrored (with citations):
  * qn exponential transform       climsim_datapip.py:102
  * (x - sub) / div, nan/inf -> 0  climsim_datapip.py:103-106
  * y * out_scale                  climsim_datapip.py:108
  * decouple_cloud                 climsim_datapip.py:109-112
  * aggressive_pruning             climsim_datapip.py:114-135
  * qinput_prune / tinput prune    climsim_datapip.py:136-143
  * input_clip (rh / dyn / phy)    climsim_datapip.py:145-151
  * output_prune                   climsim_datapip.py:154-158
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..norms import NormStats
from ..varspec import NUM_LEVELS, VarSpec

from ..ops import kernels as K

# variable groups used by pruning/clipping rules
_DYN_VARS = ("state_t_dyn", "state_q0_dyn", "state_u_dyn",
             "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn")
_PHY_VARS = ("state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
             "state_q0003_prvphy", "state_qn_prvphy", "state_u_prvphy",
             "tm_state_t_prvphy", "tm_state_q0001_prvphy",
             "tm_state_q0002_prvphy", "tm_state_q0003_prvphy",
             "tm_state_qn_prvphy", "tm_state_u_prvphy")
_Q_LIKE = ("state_rh", "state_qn", "state_q0001_prvphy", "state_qn_prvphy",
           "tm_state_q0001_prvphy", "tm_state_qn_prvphy",
           "state_q0002_prvphy", "state_q0003_prvphy",
           "tm_state_q0002_prvphy", "tm_state_q0003_prvphy")


@dataclass(frozen=True)
class TransformConfig:
    """Static switches, resolved into constant vectors at build time."""

    qn_transform: bool = False        # cloud exponential transform
    qinput_prune: bool = False
    output_prune: bool = False
    strato_lev: int = 15
    strato_lev_out: int = 12
    strato_lev_qinput: int = -1       # <0 -> use strato_lev
    strato_lev_tinput: int = 0
    decouple_cloud: bool = False
    aggressive_pruning: bool = False
    input_clip: bool = False
    input_clip_rhonly: bool = False
    # which level-resolved outputs get their stratosphere zeroed
    output_prune_vars: tuple[str, ...] = (
        "ptend_q0001", "ptend_qn", "ptend_q0002", "ptend_q0003",
        "ptend_u", "ptend_v")


def v5_online_config() -> TransformConfig:
    """The switches the shipped v5 online model was trained with
    (Unet_v5/training/conf/config_single.yaml + v5_nn_wrapper.ipynb)."""
    return TransformConfig(
        qn_transform=True, qinput_prune=True, output_prune=True,
        strato_lev=15, strato_lev_out=15, input_clip=True,
        input_clip_rhonly=True,
        output_prune_vars=("ptend_q0001", "ptend_qn", "ptend_u", "ptend_v"),
    )


def _zero_mask(spec: VarSpec, cfg: TransformConfig) -> np.ndarray:
    """Precompute a static 0/1 mask implementing all input pruning rules."""
    mask = np.ones(spec.input_len, dtype=np.float32)
    sl = spec.input_slices
    s_q = cfg.strato_lev_qinput if cfg.strato_lev_qinput >= 0 else cfg.strato_lev

    def zero(name, n):
        if name in sl and n > 0:
            mask[sl[name].start: sl[name].start + n] = 0.0

    if cfg.decouple_cloud:
        for v in ("state_qn", "state_qn_prvphy", "tm_state_qn_prvphy"):
            zero(v, NUM_LEVELS)
    if cfg.aggressive_pruning:
        # every state/dyn/prvphy profile except temperature and
        # liq_partition loses its stratosphere; q-like blocks use the
        # (deeper) q prune depth.  Trace gases are deliberately NOT pruned
        # -- their signal lives in the stratosphere
        # (climsim_datapip.py:114-135 stops at tm_state_u_prvphy).
        for v in spec.input_profile_vars:
            if v in ("state_t", "liq_partition", "pbuf_ozone", "pbuf_CH4",
                     "pbuf_N2O"):
                continue
            zero(v, s_q if v in _Q_LIKE else cfg.strato_lev)
        if "cam_in_SNOWHICE" in sl:
            mask[sl["cam_in_SNOWHICE"]] = 0.0
    elif cfg.qinput_prune:
        zero("state_qn", cfg.strato_lev)        # v5 datapip:139
        # v4/v2 family prunes the separate cloud species instead
        # (Unet_v4/training/climsim_datapip.py:121-123)
        zero("state_q0002", cfg.strato_lev)
        zero("state_q0003", cfg.strato_lev)
        zero("state_q0001", 0)  # water vapour is never input-pruned
    if cfg.strato_lev_tinput > 0:
        zero("state_t", cfg.strato_lev_tinput)
    return mask


def _clip_bounds(spec: VarSpec, cfg: TransformConfig):
    """Static per-feature clip bounds (lo, hi) as numpy vectors."""
    lo = np.full(spec.input_len, -np.inf, dtype=np.float64)
    hi = np.full(spec.input_len, np.inf, dtype=np.float64)
    sl = spec.input_slices
    if "state_rh" in sl:
        lo[sl["state_rh"]], hi[sl["state_rh"]] = 0.0, 1.2
    if not cfg.input_clip_rhonly:
        for v in _DYN_VARS:
            if v in sl:
                lo[sl[v]], hi[sl[v]] = -0.5, 0.5
        for v in _PHY_VARS:
            if v in sl:
                lo[sl[v]], hi[sl[v]] = -3.0, 3.0
    return lo, hi


def input_transform_consts(spec: VarSpec, stats: NormStats,
                           cfg: TransformConfig | None = None,
                           device="cuda", dtype=torch.float32) -> torch.Tensor:
    """Resolve ``cfg`` into the fused input transform's (7, D) constants.

    ``qn_transform`` covers BOTH cloud layouts: the combined-qn rate on v5
    specs (climsim_datapip.py:102) and the separate qc/qi rates on
    v4/v2-family specs (Unet_v4/training/climsim_datapip.py:80-81),
    whichever the spec/stats provide.  Without ``input_clip`` the bounds
    are +/-inf, which makes the kernel's clip a no-op.
    """
    cfg = cfg or TransformConfig()
    d = spec.input_len
    lo, hi = _clip_bounds(spec, cfg)
    if not cfg.input_clip:
        lo, hi = np.full(d, -np.inf), np.full(d, np.inf)
    lbd = np.zeros(d)
    is_cloud = np.zeros(d)
    if cfg.qn_transform:
        for name, rate in (("state_qn", stats.lbd_qn),
                           ("state_q0002", stats.lbd_qc),
                           ("state_q0003", stats.lbd_qi)):
            sl = spec.input_slices.get(name)
            if sl is None:
                continue
            if rate is None:
                # fail loud: silently skipping the transform would deploy
                # preprocessing the model was never trained on (the exact
                # failure mode the coupling parity tests exist to prevent)
                raise ValueError(
                    f"qn_transform requested but stats carry no lambda for "
                    f"{name!r} (spec {spec.name!r}); supply NormStats with "
                    "the trained lbd vector or turn the transform off")
            lbd[sl] = rate
            is_cloud[sl] = 1.0
    return K.transform_consts(
        sub=stats.inp_sub, divinv=1.0 / stats.inp_div,
        mask=_zero_mask(spec, cfg), lo=lo, hi=hi, lbd=lbd, is_cloud=is_cloud,
        device=device, dtype=dtype)


def make_input_transform(spec: VarSpec, stats: NormStats,
                         cfg: TransformConfig | None = None,
                         device="cuda"):
    """Build fn raw (B, D_in) -> normalized (B, D_in) float32 on ``device``:
    the fused input transform over ``input_transform_consts``."""
    consts = input_transform_consts(spec, stats, cfg, device)

    def transform(x: torch.Tensor) -> torch.Tensor:
        return K.fused_input_transform(
            x.to(device=device, dtype=torch.float32).contiguous(), consts)

    return transform


def make_target_transform(spec: VarSpec, stats: NormStats,
                          cfg: TransformConfig | None = None, device="cuda"):
    """raw targets (B, D_out) -> normalized training targets."""
    cfg = cfg or TransformConfig()
    scale = torch.as_tensor(stats.out_scale, dtype=torch.float32,
                            device=device)
    mask = np.ones(spec.output_len, dtype=np.float32)
    if cfg.output_prune:
        for v in cfg.output_prune_vars:
            if v in spec.output_slices:
                s = spec.output_slices[v].start
                mask[s: s + cfg.strato_lev_out] = 0.0
    mask_t = torch.as_tensor(mask, device=device)

    def transform(y: torch.Tensor) -> torch.Tensor:
        y = y.to(device=device, dtype=torch.float32) * scale
        y = torch.where(torch.isfinite(y), y, torch.zeros_like(y))
        return y * mask_t

    return transform
