"""ClimSim feature layouts (v1, v4, v5) as the generator and the reference
need them.

Frozen copy of the registry in ``climsim_tpu_torch/varspec.py`` at commit
ad9d7d2 (the layouts of climsim_utils/data_utils.py:558-617): a flattened
sample concatenates each variable's block, 60 entries for a level-resolved
variable and 1 for a scalar, in registry order.
"""

from __future__ import annotations

NUM_LEVELS = 60

PROFILE_VARS = frozenset({
    "state_t", "state_rh", "state_q0001", "state_q0002", "state_q0003",
    "state_qn", "liq_partition", "state_u", "state_v",
    "state_t_dyn", "state_q0_dyn", "state_u_dyn", "state_v_dyn",
    "state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
    "state_q0003_prvphy", "state_qn_prvphy", "state_u_prvphy",
    "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
    "tm_state_t_prvphy", "tm_state_q0001_prvphy", "tm_state_q0002_prvphy",
    "tm_state_q0003_prvphy", "tm_state_qn_prvphy", "tm_state_u_prvphy",
    "pbuf_ozone", "pbuf_CH4", "pbuf_N2O",
    "ptend_t", "ptend_q0001", "ptend_q0002", "ptend_q0003", "ptend_qn",
    "ptend_u", "ptend_v",
})

_SURFACE = ["cam_in_ALDIF", "cam_in_ALDIR", "cam_in_ASDIF", "cam_in_ASDIR",
            "cam_in_LWUP", "cam_in_ICEFRAC", "cam_in_LANDFRAC",
            "cam_in_OCNFRAC", "cam_in_SNOWHICE", "cam_in_SNOWHLAND"]
_TAIL = (["pbuf_ozone", "pbuf_CH4", "pbuf_N2O", "state_ps", "pbuf_SOLIN",
          "pbuf_LHFLX", "pbuf_SHFLX", "pbuf_TAUX", "pbuf_TAUY",
          "pbuf_COSZRS"] + _SURFACE
         + ["tm_state_ps", "tm_pbuf_SOLIN", "tm_pbuf_LHFLX", "tm_pbuf_SHFLX",
            "tm_pbuf_COSZRS", "clat", "slat", "icol"])
_V2_OUT = ["ptend_t", "ptend_q0001", "ptend_q0002", "ptend_q0003",
           "ptend_u", "ptend_v", "cam_out_NETSW", "cam_out_FLWDS",
           "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL",
           "cam_out_SOLSD", "cam_out_SOLLD"]

LAYOUTS = {
    "v1": (["state_t", "state_q0001", "state_ps", "pbuf_SOLIN", "pbuf_LHFLX",
            "pbuf_SHFLX"],
           ["ptend_t", "ptend_q0001", "cam_out_NETSW", "cam_out_FLWDS",
            "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS",
            "cam_out_SOLL", "cam_out_SOLSD", "cam_out_SOLLD"]),
    "v4": (["state_t", "state_rh", "state_q0002", "state_q0003", "state_u",
            "state_v", "state_t_dyn", "state_q0_dyn", "state_u_dyn",
            "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
            "state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
            "state_q0003_prvphy", "state_u_prvphy", "tm_state_t_prvphy",
            "tm_state_q0001_prvphy", "tm_state_q0002_prvphy",
            "tm_state_q0003_prvphy", "tm_state_u_prvphy"] + _TAIL,
           _V2_OUT),
    "v5": (["state_t", "state_rh", "state_qn", "liq_partition", "state_u",
            "state_v", "state_t_dyn", "state_q0_dyn", "state_u_dyn",
            "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
            "state_t_prvphy", "state_q0001_prvphy", "state_qn_prvphy",
            "state_u_prvphy", "tm_state_t_prvphy", "tm_state_q0001_prvphy",
            "tm_state_qn_prvphy", "tm_state_u_prvphy"] + _TAIL,
           ["ptend_t", "ptend_q0001", "ptend_qn", "ptend_u", "ptend_v",
            "cam_out_NETSW", "cam_out_FLWDS", "cam_out_PRECSC",
            "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL", "cam_out_SOLSD",
            "cam_out_SOLLD"]),
}


def var_len(name: str) -> int:
    return NUM_LEVELS if name in PROFILE_VARS else 1


class Layout:
    """One feature layout: names, lengths and slices."""

    def __init__(self, name: str):
        self.name = name
        inputs, outputs = LAYOUTS[name]
        self.inputs, self.outputs = tuple(inputs), tuple(outputs)
        self.input_slices = _offsets(self.inputs)
        self.output_slices = _offsets(self.outputs)
        self.input_len = sum(var_len(v) for v in self.inputs)
        self.output_len = sum(var_len(v) for v in self.outputs)

    def profiles(self, names) -> tuple:
        return tuple(v for v in names if var_len(v) == NUM_LEVELS)

    def scalars(self, names) -> tuple:
        return tuple(v for v in names if var_len(v) == 1)


def _offsets(names) -> dict:
    out, off = {}, 0
    for v in names:
        out[v] = slice(off, off + var_len(v))
        off += var_len(v)
    return out
