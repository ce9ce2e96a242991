"""The port's ingest path and its numpy helpers against the JAX package,
on the CPU: build_split (netCDF tree -> .npy / .h5 shards) byte-equal to
climsim_tpu.data.ingest.build_split on tests/synthnc.py trees, plain,
normalized, windowed (v5, with emit_stride), over a process pool and
with h5; Grid.from_netcdf, Grid.save_npz, synthetic_grid, identity_norms
and NormStats.from_var_datasets equal to JAX's."""

import os

import numpy as np
import pytest

from climsim_tpu import grid as JG
from climsim_tpu import norms as JN
from climsim_tpu.data import ingest as JI
from climsim_tpu.varspec import get_varspec as jax_varspec
from climsim_tpu_torch import grid as PG
from climsim_tpu_torch import norms as PN
from climsim_tpu_torch.data import ingest as PI
from climsim_tpu_torch.varspec import get_varspec

from synthnc import NCOL, make_tree


@pytest.fixture(scope="module")
def ncdir(tmp_path_factory):
    root = tmp_path_factory.mktemp("ncdata") / "0001-02"
    return make_tree(root, JG.synthetic_grid(ncol=NCOL), nsteps=6, seed=1)


def _bytes(out):
    return {k: open(p, "rb").read() for k, p in out.items()}


def _both(tmp_path, fl, version, **kw):
    """(port's files' bytes, JAX's files' bytes) of one build_split."""
    ours = PI.build_split(fl, get_varspec(version), str(tmp_path / "port"),
                          "train", **kw)
    jkw = dict(kw)
    if kw.get("grid") is not None:
        jkw["grid"] = JG.load_default_grid()
    if kw.get("stats") is not None:
        jkw["stats"] = JN.load_asset_norms(version)
    ref = JI.build_split(fl, jax_varspec(version), str(tmp_path / "jax"),
                         "train", **jkw)
    assert sorted(ours) == sorted(ref)
    return _bytes(ours), _bytes(ref)


@pytest.mark.parametrize("case", ["plain", "normalized", "strided"])
def test_build_split_equals_jax(ncdir, tmp_path, case):
    fl = PI.build_filelist(ncdir, ["E3SM-MMF.mli.*.nc"], stride=1)
    assert fl == JI.build_filelist(ncdir, ["E3SM-MMF.mli.*.nc"], stride=1)
    kw = {"plain": {}, "normalized": dict(
        stats=PN.load_asset_norms("v1"), grid=PG.load_default_grid()),
          "strided": dict(emit_stride=2)}[case]
    ours, ref = _both(tmp_path, fl, "v1", **kw)
    assert ours == ref
    x = np.load(os.path.join(tmp_path, "port", "train_input.npy"))
    assert x.shape == ((6 if case != "strided" else 3) * NCOL, 124)


def test_build_split_windowed_equals_jax(ncdir, tmp_path):
    """v5's expanded features from the two adjacent files, every third
    file emitted."""
    fl = PI.build_filelist(ncdir, ["E3SM-MMF.mli.*.nc"], stride=1)
    ours, ref = _both(tmp_path, fl, "v5", window=True, emit_stride=3)
    assert ours == ref
    x = np.load(os.path.join(tmp_path, "port", "train_input.npy"))
    assert x.shape == (2 * NCOL, 1405)


def test_build_split_parallel_and_h5_equal_jax(ncdir, tmp_path):
    """workers=2 (a spawn pool) against JAX's serial build, with the h5
    shards as well; the port's H5ShardDataset reads them back."""
    from climsim_tpu_torch.data.h5dataset import H5ShardDataset

    fl = PI.build_filelist(ncdir, ["E3SM-MMF.mli.*.nc"], stride=2)
    ours = PI.build_split(fl, get_varspec("v1"), str(tmp_path / "p" / "c0"),
                          "train", save_h5=True, workers=2)
    ref = JI.build_split(fl, jax_varspec("v1"), str(tmp_path / "j" / "c0"),
                         "train", save_h5=True)
    for k in ("input", "target"):
        assert open(ours[k], "rb").read() == open(ref[k], "rb").read()
    import h5py

    for k in ("input_h5", "target_h5"):
        with h5py.File(ours[k]) as a, h5py.File(ref[k]) as b:
            np.testing.assert_array_equal(a["data"][:], b["data"][:])
    ds = H5ShardDataset(str(tmp_path / "p"))
    xs, ys = ds.gather([5, 0, 40])
    x = np.load(ours["input"])
    np.testing.assert_array_equal(xs, x[[5, 0, 40]])
    assert ys.shape == (3, 128)


def test_index_to_latlontime_equals_jax(ncdir):
    fl = PI.build_filelist(ncdir, ["E3SM-MMF.mli.*.nc"], stride=3)
    assert PI.index_to_latlontime(fl, PG.synthetic_grid(ncol=NCOL)) == \
        JI.index_to_latlontime(fl, JG.synthetic_grid(ncol=NCOL))


def _grid_fields(g):
    return {k: getattr(g, k) for k in ("lat", "lon", "area", "hyai", "hybi",
                                       "hyam", "hybm", "p0")}


def _assert_grids_equal(a, b):
    fa, fb = _grid_fields(a), _grid_fields(b)
    for k in fa:
        assert np.asarray(fa[k]).dtype == np.asarray(fb[k]).dtype, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("ncol,levels,seed", [(384, 60, 0), (16, 60, 3),
                                              (7, 12, 1)])
def test_synthetic_grid_equals_jax(ncol, levels, seed):
    _assert_grids_equal(PG.synthetic_grid(ncol, levels, seed),
                        JG.synthetic_grid(ncol, levels, seed))


@pytest.mark.parametrize("p0", [None, 1.0e5 - 3.0])
def test_grid_from_netcdf_equals_jax(tmp_path, p0):
    """A grid-info file (ncol and ilev/lev dimensions), with and without
    P0."""
    from scipy.io import netcdf_file

    g = JG.synthetic_grid(ncol=20, num_levels=10, seed=2)
    path = str(tmp_path / "grid_info.nc")
    f = netcdf_file(path, "w")
    f.createDimension("ncol", 20)
    f.createDimension("lev", 10)
    f.createDimension("ilev", 11)
    for k, dim in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                   ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                   ("hybm", "lev")):
        f.createVariable(k, "f8", (dim,))[:] = getattr(g, k)
    if p0 is not None:
        f.createVariable("P0", "f8", ())[...] = p0
    f.flush()
    f.close()
    ours, ref = PG.Grid.from_netcdf(path), JG.Grid.from_netcdf(path)
    _assert_grids_equal(ours, ref)
    assert ours.p0 == (1.0e5 if p0 is None else p0)


def test_grid_save_npz_round_trips_through_jax(tmp_path):
    g = PG.synthetic_grid(ncol=30, seed=4).replace(p0=99000.0)
    g.save_npz(str(tmp_path / "port.npz"))
    JG.synthetic_grid(ncol=30, seed=4).replace(p0=99000.0).save_npz(
        str(tmp_path / "jax.npz"))
    _assert_grids_equal(JG.Grid.from_npz(str(tmp_path / "port.npz")),
                        PG.Grid.from_npz(str(tmp_path / "jax.npz")))
    with np.load(tmp_path / "port.npz") as a, \
            np.load(tmp_path / "jax.npz") as b:
        assert a.files == b.files


@pytest.mark.parametrize("version", ["v1", "v2_rh", "v4", "v5"])
def test_identity_norms_equal_jax(version):
    a = PN.identity_norms(get_varspec(version))
    b = JN.identity_norms(jax_varspec(version))
    for k in ("inp_sub", "inp_div", "out_scale", "lbd_qn", "lbd_qc",
              "lbd_qi"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("version", ["v1", "v5"])
def test_from_var_datasets_equals_jax(version):
    """Scalars for the profile variables' maxima (broadcast over levels),
    (60,) arrays elsewhere, and a zero range (div -> 1)."""
    spec = get_varspec(version)
    rng = np.random.default_rng(5)

    def table(names, scalar=False):
        from climsim_tpu_torch.varspec import var_len

        return {v: (rng.normal() if scalar or var_len(v) == 1
                    else rng.normal(size=var_len(v))) for v in names}

    mean, minn = table(spec.inputs), table(spec.inputs)
    maxx = table(spec.inputs, scalar=True)
    maxx[spec.inputs[0]] = minn[spec.inputs[0]]
    scale = table(spec.outputs)
    lbd = rng.random(60) if version == "v5" else None
    a = PN.NormStats.from_var_datasets(spec, mean, maxx, minn, scale, lbd)
    b = JN.NormStats.from_var_datasets(jax_varspec(version), mean, maxx,
                                       minn, scale, lbd)
    for k in ("inp_sub", "inp_div", "out_scale", "lbd_qn"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)
    bad = dict(scale)
    bad[spec.outputs[0]] = np.zeros(7)
    with pytest.raises(ValueError):
        PN.NormStats.from_var_datasets(spec, mean, maxx, minn, bad)
