"""The E3SM ne4 column grid, as the port's own copy of what it uses of
``climsim_tpu/grid.py``: ``Grid`` (with the column count, area weights
and latitude bookkeeping that evaluation reads) and ``load_default_grid``,
which reads the port's copy of the asset (``climsim_tpu_torch/assets/grid_ne4.npz``,
bit-equal to the JAX package's; ``tests/test_torch_package.py`` checks
it).  The netCDF reader is not copied: the port reads the npz only.

Mirrors the reference's use of grid_info/ClimSim_low-res_grid-info.nc
(climsim_utils/data_utils.py:67-74,128-130): ncol areas, lat/lon, hybrid
sigma coefficients hyai/hybi (interfaces, L+1) and hyam/hybm (mid-levels,
L).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Grid:
    lat: np.ndarray       # (ncol,) degrees
    lon: np.ndarray       # (ncol,) degrees
    area: np.ndarray      # (ncol,) steradian-ish cell weights
    hyai: np.ndarray      # (L+1,)
    hybi: np.ndarray      # (L+1,)
    hyam: np.ndarray      # (L,)
    hybm: np.ndarray      # (L,)
    p0: float = 1.0e5

    @property
    def ncol(self) -> int:
        return int(self.lat.shape[0])

    @property
    def num_levels(self) -> int:
        return int(self.hyam.shape[0])

    @property
    def area_wgt(self) -> np.ndarray:
        """Area weights normalized to mean 1 (data_utils.py:73-74)."""
        return self.area / self.area.mean()

    # -- lat bookkeeping for zonal-mean plots / daily R2 maps -------------
    @property
    def unique_lats(self) -> np.ndarray:
        return np.unique(self.lat)

    def lat_indices(self) -> list[np.ndarray]:
        """Column indices grouped by unique latitude, ascending lat."""
        return [np.nonzero(self.lat == la)[0] for la in self.unique_lats]

    def replace(self, **kw) -> "Grid":
        return dataclasses.replace(self, **kw)

    @classmethod
    def from_npz(cls, path: str) -> "Grid":
        z = np.load(path)
        return cls(lat=z["lat"], lon=z["lon"], area=z["area"],
                   hyai=z["hyai"], hybi=z["hybi"], hyam=z["hyam"],
                   hybm=z["hybm"], p0=float(z["p0"]))


def load_default_grid() -> Grid:
    """The ne4 grid shipped as a package asset."""
    import importlib.resources as res

    with res.as_file(
        res.files("climsim_tpu_torch") / "assets" / "grid_ne4.npz"
    ) as p:
        return Grid.from_npz(str(p))
