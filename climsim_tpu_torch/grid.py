"""The E3SM column grids, as the port's own copy of ``climsim_tpu/grid.py``:
``Grid`` (with the column count, area weights and latitude bookkeeping
that evaluation reads, read from a grid-info netCDF or an npz and written
to an npz), ``synthetic_grid`` for tests and benchmarks, and
``load_default_grid``, which reads the port's copy of the ne4 asset
(``climsim_tpu_torch/assets/grid_ne4.npz``, bit-equal to the JAX
package's; ``tests/test_torch_package.py`` checks it).

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
    def from_netcdf(cls, path: str) -> "Grid":
        """A grid-info netCDF (ClimSim_low-res_grid-info.nc), read by the
        port's numpy netCDF reader; P0 defaults to 1e5 where absent."""
        from .utils.ncread import read_netcdf

        nc = read_netcdf(path)
        g = {k: np.asarray(nc[k], dtype=np.float64) for k in
             ("lat", "lon", "area", "hyai", "hybi", "hyam", "hybm")}
        p0 = float(np.asarray(nc["P0"])) if "P0" in nc.variables else 1.0e5
        return cls(p0=p0, **g)

    @classmethod
    def from_npz(cls, path: str) -> "Grid":
        z = np.load(path)
        return cls(lat=z["lat"], lon=z["lon"], area=z["area"],
                   hyai=z["hyai"], hybi=z["hybi"], hyam=z["hyam"],
                   hybm=z["hybm"], p0=float(z["p0"]))

    def save_npz(self, path: str) -> None:
        np.savez_compressed(
            path, lat=self.lat, lon=self.lon, area=self.area,
            hyai=self.hyai, hybi=self.hybi, hyam=self.hyam, hybm=self.hybm,
            p0=np.float64(self.p0))


def synthetic_grid(ncol: int = 384, num_levels: int = 60,
                   seed: int = 0) -> Grid:
    """A physically plausible stand-in grid for tests and benchmarks:
    Fibonacci-sphere latitudes and longitudes, areas near 1, and a monotone
    hybrid coordinate (pure pressure at the top, terrain-following at the
    bottom)."""
    rng = np.random.default_rng(seed)
    i = np.arange(ncol)
    lat = np.degrees(np.arcsin(1 - 2 * (i + 0.5) / ncol))
    lon = (i * 137.508) % 360.0
    area = np.abs(1.0 + 0.3 * np.cos(np.radians(lat))
                  + 0.02 * rng.standard_normal(ncol))
    li = np.linspace(0.0, 1.0, num_levels + 1)
    # interface pressures from ~20 Pa to ps, split into hyai and hybi
    p_top, p_match = 20.0, 1.0e4
    eta = p_top / 1e5 + (1 - p_top / 1e5) * li**1.8
    hybi = np.clip((eta - p_match / 1e5) / (1 - p_match / 1e5), 0, None) ** 1.2
    hyai = eta - hybi
    hyam = 0.5 * (hyai[1:] + hyai[:-1])
    hybm = 0.5 * (hybi[1:] + hybi[:-1])
    return Grid(lat=lat, lon=lon, area=area, hyai=hyai, hybi=hybi,
                hyam=hyam, hybm=hybm, p0=1.0e5)


def load_default_grid() -> Grid:
    """The ne4 grid shipped as a package asset."""
    import importlib.resources as res

    with res.as_file(
        res.files("climsim_tpu_torch") / "assets" / "grid_ne4.npz"
    ) as p:
        return Grid.from_npz(str(p))
