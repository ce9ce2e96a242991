"""Shared synthetic E3SM-MMF netCDF tree builder for tests.

Writes classic CDF-1 files via scipy with the reference's mli/mlo naming
and (lev, ncol) layout, with plausible physics so derived quantities
(RH, liq_partition) land in sane ranges.
"""

from __future__ import annotations

import numpy as np

NCOL = 24
LEV = 60


def write_nc(path, vars2d, vars1d, lev=LEV, ncol=NCOL):
    """Write an E3SM-like netCDF (CDF-1 via scipy) with (lev, ncol) dims."""
    from scipy.io import netcdf_file

    f = netcdf_file(path, "w")
    f.createDimension("lev", lev)
    f.createDimension("ncol", ncol)
    for name, arr in vars2d.items():
        v = f.createVariable(name, "f8", ("lev", "ncol"))
        v[:] = arr
    for name, arr in vars1d.items():
        v = f.createVariable(name, "f8", ("ncol",))
        v[:] = arr
    f.flush()
    f.close()


def make_tree(root, grid, nsteps=6, seed=0, ncol=None):
    """Create `nsteps` mli/mlo pairs under root (a YYYY-MM subdir)."""
    NCOL = ncol or globals()["NCOL"]
    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    lev_frac = (np.arange(LEV) + 0.5) / LEV
    for t in range(nsteps):
        t2d = {
            "state_t": 300 - 90 * (1 - lev_frac)[:, None]
            + 2 * rng.standard_normal((LEV, NCOL)),
            "state_q0001": np.abs(1e-2 * lev_frac[:, None]**3
                                  + 1e-5 * rng.random((LEV, NCOL))),
            "state_q0002": np.abs(1e-5 * rng.random((LEV, NCOL))),
            "state_q0003": np.abs(1e-5 * rng.random((LEV, NCOL))),
            "state_u": 10 * rng.standard_normal((LEV, NCOL)),
            "state_v": 10 * rng.standard_normal((LEV, NCOL)),
            "state_pmid": 1e5 * lev_frac[:, None] ** 1.2
            * np.ones((LEV, NCOL)),
            "pbuf_ozone": np.abs(1e-6 * rng.random((LEV, NCOL))),
            "pbuf_CH4": np.abs(1e-6 * rng.random((LEV, NCOL))),
            "pbuf_N2O": np.abs(1e-6 * rng.random((LEV, NCOL))),
        }
        t1d = {
            "state_ps": 9e4 + 1e4 * rng.random(NCOL),
            "pbuf_SOLIN": 1000 * rng.random(NCOL),
            "pbuf_LHFLX": 100 * rng.random(NCOL),
            "pbuf_SHFLX": 30 * rng.random(NCOL),
            "pbuf_TAUX": 0.1 * rng.standard_normal(NCOL),
            "pbuf_TAUY": 0.1 * rng.standard_normal(NCOL),
            "pbuf_COSZRS": rng.random(NCOL),
            "cam_in_ALDIF": rng.random(NCOL),
            "cam_in_ALDIR": rng.random(NCOL),
            "cam_in_ASDIF": rng.random(NCOL),
            "cam_in_ASDIR": rng.random(NCOL),
            "cam_in_LWUP": 300 + 50 * rng.random(NCOL),
            "cam_in_ICEFRAC": rng.random(NCOL),
            "cam_in_LANDFRAC": rng.random(NCOL),
            "cam_in_OCNFRAC": rng.random(NCOL),
            "cam_in_SNOWHICE": 0.1 * rng.random(NCOL),
            "cam_in_SNOWHLAND": 0.1 * rng.random(NCOL),
            "lat": grid.lat[:NCOL],
            "lon": grid.lon[:NCOL],
        }
        stamp = f"0001-02-01-{t * 1200:05d}"
        write_nc(str(root / f"E3SM-MMF.mli.{stamp}.nc"), t2d, t1d,
                 ncol=NCOL)
        o2d = {k: v + (1e-3 * np.abs(v) if k.startswith("state") else 0)
               for k, v in t2d.items()}
        out1d = {
            "cam_out_NETSW": 200 * np.random.default_rng(t).random(NCOL),
            "cam_out_FLWDS": 300 * np.random.default_rng(t + 1).random(NCOL),
            "cam_out_PRECSC": 1e-8 * np.random.default_rng(t + 2).random(NCOL),
            "cam_out_PRECC": 1e-7 * np.random.default_rng(t + 3).random(NCOL),
            "cam_out_SOLS": 100 * np.random.default_rng(t + 4).random(NCOL),
            "cam_out_SOLL": 100 * np.random.default_rng(t + 5).random(NCOL),
            "cam_out_SOLSD": 50 * np.random.default_rng(t + 6).random(NCOL),
            "cam_out_SOLLD": 50 * np.random.default_rng(t + 7).random(NCOL),
            "lat": grid.lat[:NCOL], "lon": grid.lon[:NCOL],
        }
        write_nc(str(root / f"E3SM-MMF.mlo.{stamp}.nc"), o2d, out1d,
                 ncol=NCOL)
    return str(root.parent)
