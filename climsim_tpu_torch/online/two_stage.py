"""Two-stage v5 scheme: a 3-class cloud classifier gates the qn tendency.

The counterpart of ``climsim_tpu.online.two_stage``.  The reference trains
a classifier U-Net that predicts a condensate regime a level beside the
regression U-Net (climsim_unet_classifier.py,
train_unet_h5loader_classifier.py:306-311; label thresholds 1e-9 / 1e-11,
conf/config_single.yaml:63-64, climsim_datapip_classifier_h5.py:118-122):

  class 0: the qn tendency is zero          -> emit exactly 0
  class 1: the cloud fully evaporates       -> emit dqn = -qn / 1200
           (drives qn to exactly zero over the coupling step)
  class 2: regular condensate evolution     -> emit the regressor's dqn

Both networks run on the same normalized input and the gate acts on the
normalized qn block, before the wrapper's postprocess: the composition is
``online.wrapper.make_wrapper``'s ``model_apply``, so the whole scheme is
one served function and one exported program.  The class-1 tendency
needs the raw qn, recovered in the graph by inverting the exponential
transform and the normalization (stats required).  The gate is an argmax
and two selects on a (B, 60) block: the JAX package computes it in XLA,
outside any Pallas kernel, and here it is plain torch.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..norms import NormStats
from ..varspec import get_varspec


def make_two_stage_apply(regressor_apply: Callable,
                         classifier_apply: Callable,
                         stats: NormStats | None = None, dt: float = 1200.0,
                         device="cuda") -> Callable:
    """Compose fn(x_norm (B, 1405)) -> gated normalized (B, 308).

    ``regressor_apply(x_norm)`` -> (B, 308) and ``classifier_apply(x_norm)``
    -> (B, 60, 3) class logits, e.g. ``partial(unet_apply_fused, model)``
    for each network.  With ``stats`` (v5 NormStats carrying ``lbd_qn``),
    class 1 emits the exact-evaporation tendency; without, class 1 emits
    0 (class 0's answer), as in the JAX package -- fine for tests, wrong
    for coupling.  The stats' vectors live on ``device``.
    """
    spec5 = get_varspec("v5")
    sl_out = spec5.output_slices["ptend_qn"]
    sl_in = spec5.input_slices["state_qn"]

    if stats is not None:
        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=device)

        qn_sub, qn_div = f32(stats.inp_sub[sl_in]), f32(stats.inp_div[sl_in])
        lbd = torch.clamp(f32(stats.lbd_qn), min=1e-12)
        out_scale_qn = f32(stats.out_scale[sl_out])

    def apply(x_norm: torch.Tensor) -> torch.Tensor:
        y = regressor_apply(x_norm)
        cls = classifier_apply(x_norm).argmax(dim=-1)   # (B, 60) in {0, 1, 2}
        dqn = y[:, sl_out]
        if stats is not None:
            # invert normalize + exponential transform: qn_raw =
            # -ln(1 - (x * div + sub)) / lbd (pruned levels read 0 -> 0);
            # log, not log1p: the JAX package's float32 arithmetic
            xq = x_norm[:, sl_in] * qn_div + qn_sub
            qn_raw = -torch.log(torch.clamp(1.0 - xq, 1e-12, 1.0)) / lbd
            evap = (-qn_raw / dt) * out_scale_qn    # normalized tendency
        else:
            evap = torch.zeros_like(dqn)
        gated = torch.where(cls == 2, dqn,
                            torch.where(cls == 1, evap, torch.zeros_like(dqn)))
        return torch.cat([y[:, :sl_out.start], gated, y[:, sl_out.stop:]],
                         dim=1)

    return apply
