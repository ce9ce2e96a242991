"""Variable registries for the ClimSim feature layouts (v1/v2/v2_rh/v4/v5).

The port's own copy of ``climsim_tpu/varspec.py`` (the registry as data,
``VarSpec`` and ``get_varspec``), so that the port imports nothing of the
JAX package; ``tests/test_torch_package.py`` holds every registered spec
to the JAX package's, field by field.

A flattened sample is the concatenation of each variable's block: 60
entries for level-resolved ("profile") variables, 1 for scalars, in
registry order (climsim_utils/data_utils.py:172-467,558-617).

Feature lengths:
  v1:   in 124  out 128   (data_utils.py:558-568)
  v2:   in 557  out 368   (data_utils.py:570-580)
  v2_rh:in 557  out 368   (data_utils.py:582-592)
  v4:   in 1525 out 368   (data_utils.py:594-604)
  v5:   in 1405 out 308   (data_utils.py:606-617)
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

NUM_LEVELS = 60

# Every level-resolved variable name (all others are scalars).
_PROFILE_VARS = {
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
}


def var_len(name: str) -> int:
    return NUM_LEVELS if name in _PROFILE_VARS else 1


_SURFACE_SCALARS = [
    "cam_in_ALDIF", "cam_in_ALDIR", "cam_in_ASDIF", "cam_in_ASDIR",
    "cam_in_LWUP", "cam_in_ICEFRAC", "cam_in_LANDFRAC", "cam_in_OCNFRAC",
    "cam_in_SNOWHICE", "cam_in_SNOWHLAND",
]

V1_INPUTS = ["state_t", "state_q0001", "state_ps", "pbuf_SOLIN",
             "pbuf_LHFLX", "pbuf_SHFLX"]

V1_OUTPUTS = ["ptend_t", "ptend_q0001", "cam_out_NETSW", "cam_out_FLWDS",
              "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS",
              "cam_out_SOLL", "cam_out_SOLSD", "cam_out_SOLLD"]

V2_INPUTS = (
    ["state_t", "state_q0001", "state_q0002", "state_q0003", "state_u",
     "state_v", "state_ps", "pbuf_SOLIN", "pbuf_LHFLX", "pbuf_SHFLX",
     "pbuf_TAUX", "pbuf_TAUY", "pbuf_COSZRS"]
    + _SURFACE_SCALARS
    + ["pbuf_ozone", "pbuf_CH4", "pbuf_N2O"]
)

V2_RH_INPUTS = (
    ["state_t", "state_rh", "state_q0002", "state_q0003", "state_u",
     "state_v", "pbuf_ozone", "pbuf_CH4", "pbuf_N2O", "state_ps",
     "pbuf_SOLIN", "pbuf_LHFLX", "pbuf_SHFLX", "pbuf_TAUX", "pbuf_TAUY",
     "pbuf_COSZRS"]
    + _SURFACE_SCALARS
)

V2_OUTPUTS = ["ptend_t", "ptend_q0001", "ptend_q0002", "ptend_q0003",
              "ptend_u", "ptend_v", "cam_out_NETSW", "cam_out_FLWDS",
              "cam_out_PRECSC", "cam_out_PRECC", "cam_out_SOLS",
              "cam_out_SOLL", "cam_out_SOLSD", "cam_out_SOLLD"]

_EXPANDED_TAIL = (
    ["pbuf_ozone", "pbuf_CH4", "pbuf_N2O", "state_ps", "pbuf_SOLIN",
     "pbuf_LHFLX", "pbuf_SHFLX", "pbuf_TAUX", "pbuf_TAUY", "pbuf_COSZRS"]
    + _SURFACE_SCALARS
    + ["tm_state_ps", "tm_pbuf_SOLIN", "tm_pbuf_LHFLX", "tm_pbuf_SHFLX",
       "tm_pbuf_COSZRS", "clat", "slat", "icol"]
)

V4_INPUTS = (
    ["state_t", "state_rh", "state_q0002", "state_q0003", "state_u",
     "state_v", "state_t_dyn", "state_q0_dyn", "state_u_dyn",
     "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
     "state_t_prvphy", "state_q0001_prvphy", "state_q0002_prvphy",
     "state_q0003_prvphy", "state_u_prvphy", "tm_state_t_prvphy",
     "tm_state_q0001_prvphy", "tm_state_q0002_prvphy",
     "tm_state_q0003_prvphy", "tm_state_u_prvphy"]
    + _EXPANDED_TAIL
)

V5_INPUTS = (
    ["state_t", "state_rh", "state_qn", "liq_partition", "state_u",
     "state_v", "state_t_dyn", "state_q0_dyn", "state_u_dyn",
     "tm_state_t_dyn", "tm_state_q0_dyn", "tm_state_u_dyn",
     "state_t_prvphy", "state_q0001_prvphy", "state_qn_prvphy",
     "state_u_prvphy", "tm_state_t_prvphy", "tm_state_q0001_prvphy",
     "tm_state_qn_prvphy", "tm_state_u_prvphy"]
    + _EXPANDED_TAIL
)

V5_OUTPUTS = ["ptend_t", "ptend_q0001", "ptend_qn", "ptend_u", "ptend_v",
              "cam_out_NETSW", "cam_out_FLWDS", "cam_out_PRECSC",
              "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL",
              "cam_out_SOLSD", "cam_out_SOLLD"]


@dataclass(frozen=True)
class VarSpec:
    """Immutable description of one feature layout version."""

    name: str
    inputs: tuple[str, ...]
    outputs: tuple[str, ...]

    @property
    def input_len(self) -> int:
        return sum(var_len(v) for v in self.inputs)

    @property
    def output_len(self) -> int:
        return sum(var_len(v) for v in self.outputs)

    def _offsets(self, names) -> dict[str, slice]:
        out, off = {}, 0
        for v in names:
            n = var_len(v)
            out[v] = slice(off, off + n)
            off += n
        return out

    @property
    def input_slices(self) -> dict[str, slice]:
        return self._offsets(self.inputs)

    @property
    def output_slices(self) -> dict[str, slice]:
        return self._offsets(self.outputs)

    @property
    def ps_index(self) -> int:
        return self.input_slices["state_ps"].start

    @property
    def input_profile_vars(self) -> tuple[str, ...]:
        return tuple(v for v in self.inputs if var_len(v) == NUM_LEVELS)

    @property
    def input_scalar_vars(self) -> tuple[str, ...]:
        return tuple(v for v in self.inputs if var_len(v) == 1)

    @property
    def output_profile_vars(self) -> tuple[str, ...]:
        return tuple(v for v in self.outputs if var_len(v) == NUM_LEVELS)

    @property
    def output_scalar_vars(self) -> tuple[str, ...]:
        return tuple(v for v in self.outputs if var_len(v) == 1)


_REGISTRY = {
    "v1": VarSpec("v1", tuple(V1_INPUTS), tuple(V1_OUTPUTS)),
    "v2": VarSpec("v2", tuple(V2_INPUTS), tuple(V2_OUTPUTS)),
    "v2_rh": VarSpec("v2_rh", tuple(V2_RH_INPUTS), tuple(V2_OUTPUTS)),
    "v4": VarSpec("v4", tuple(V4_INPUTS), tuple(V2_OUTPUTS)),
    "v5": VarSpec("v5", tuple(V5_INPUTS), tuple(V5_OUTPUTS)),
}


@lru_cache(maxsize=None)
def get_varspec(name: str) -> VarSpec:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown varspec {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> list[str]:
    return sorted(_REGISTRY)
