"""Normalization statistics, flattened to the feature layout of a VarSpec.

The port's own copy of what it uses of ``climsim_tpu/norms.py``:
``NormStats`` (read from the packaged npz files) and ``load_asset_norms``,
which reads the port's copies of the assets
(``climsim_tpu_torch/assets/norms_<version>.npz``, bit-equal to the JAX
package's; ``tests/test_torch_package.py`` checks it).

The training-space transform is
    x_norm = (x - inp_sub) / inp_div          (input)
    y_norm = y * out_scale                    (target)
with inp_sub = per-feature mean and inp_div = max - min, as the reference
(climsim_utils/data_utils.py:807-809, save_norm :954-988).  The v5
pipeline applies the cloud exponential transform with per-level rate
``lbd_qn`` before normalizing (climsim_datapip.py:102).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class NormStats:
    inp_sub: np.ndarray    # (input_len,)
    inp_div: np.ndarray    # (input_len,)
    out_scale: np.ndarray  # (output_len,)
    lbd_qn: np.ndarray | None = None  # (60,) cloud exp-transform rate (v5)
    # v4/v2-family separate-cloud rates (climsim_datapip.py:80-81)
    lbd_qc: np.ndarray | None = None  # (60,)
    lbd_qi: np.ndarray | None = None  # (60,)

    def __post_init__(self):
        # zero-range (constant) inputs: a divisor of 1 instead of the
        # reference's inf/nan -> 0 after dividing (data_utils.py:895-897),
        # numerically the same downstream
        div = np.where(self.inp_div == 0.0, 1.0, self.inp_div)
        object.__setattr__(self, "inp_div", div)

    @classmethod
    def from_npz(cls, path: str) -> "NormStats":
        z = np.load(path)

        def opt(k):
            return z[k] if k in z.files else None

        return cls(inp_sub=z["inp_sub"], inp_div=z["inp_div"],
                   out_scale=z["out_scale"], lbd_qn=opt("lbd_qn"),
                   lbd_qc=opt("lbd_qc"), lbd_qi=opt("lbd_qi"))


def load_asset_norms(version: str) -> NormStats:
    """Load the packaged normalization vectors for a varspec version."""
    import importlib.resources as res

    with res.as_file(
        res.files("climsim_tpu_torch") / "assets" / f"norms_{version}.npz"
    ) as p:
        return NormStats.from_npz(str(p))
