"""Minimal, dependency-free netCDF reader.

The ClimSim asset files come in two flavors:

* classic CDF (versions 1, 2 and 5 a.k.a. CDF-5) -- e.g. the ne4 grid file
  (reference: grid_info/ClimSim_low-res_grid-info.nc, a CDF-5 file), and
* netCDF-4 (HDF5 container) -- e.g. preprocessing/normalizations/*.nc.

The runtime image has neither ``netCDF4`` nor ``xarray``, so we parse classic
CDF with pure numpy and delegate HDF5 containers to ``h5py``.  Only reading is
supported -- the framework stores its own assets as ``.npz``.

Reference for the classic file layout: the NetCDF Classic Format Specification
(magic ``CDF\\x01|\\x02|\\x05``; header = numrecs, dim_list, gatt_list,
var_list; data = fixed-size block per non-record var + interleaved records).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy dtype, size in bytes)
_NC_TYPES = {
    1: (np.dtype(">i1"), 1),   # NC_BYTE
    2: (np.dtype("S1"), 1),    # NC_CHAR
    3: (np.dtype(">i2"), 2),   # NC_SHORT
    4: (np.dtype(">i4"), 4),   # NC_INT
    5: (np.dtype(">f4"), 4),   # NC_FLOAT
    6: (np.dtype(">f8"), 8),   # NC_DOUBLE
    # CDF-5 extensions
    7: (np.dtype(">u1"), 1),   # NC_UBYTE
    8: (np.dtype(">u2"), 2),   # NC_USHORT
    9: (np.dtype(">u4"), 4),   # NC_UINT
    10: (np.dtype(">i8"), 8),  # NC_INT64
    11: (np.dtype(">u8"), 8),  # NC_UINT64
}


@dataclass
class NcVar:
    name: str
    dims: tuple[str, ...]
    shape: tuple[int, ...]
    data: np.ndarray
    attrs: dict = field(default_factory=dict)


@dataclass
class NcFile:
    dims: dict
    attrs: dict
    variables: dict

    def __getitem__(self, name: str) -> np.ndarray:
        return self.variables[name].data


class _Cursor:
    """Sequential big-endian reader over the classic-CDF header bytes."""

    def __init__(self, buf: bytes, version: int):
        self.buf = buf
        self.pos = 0
        self.version = version
        # CDF-5 widens every count/size field to 64 bits.
        self.wide = version == 5

    def _unpack(self, fmt: str):
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, self.buf, self.pos)
        self.pos += size
        return vals[0]

    def i4(self) -> int:
        return self._unpack(">i")

    def count(self) -> int:
        """A NON_NEG count: 32-bit in CDF-1/2, 64-bit in CDF-5."""
        return self._unpack(">q") if self.wide else self._unpack(">i")

    def offset(self) -> int:
        """A file offset: 32-bit in CDF-1, 64-bit in CDF-2/5."""
        return self._unpack(">i") if self.version == 1 else self._unpack(">q")

    def name(self) -> str:
        n = self.count()
        raw = self.buf[self.pos : self.pos + n]
        self.pos += _pad4(n)
        return raw.decode("utf-8")

    def values(self, nc_type: int, n: int) -> np.ndarray:
        dt, size = _NC_TYPES[nc_type]
        nbytes = n * size
        arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=self.pos)
        self.pos += _pad4(nbytes)
        if nc_type == 2:
            return arr.tobytes().decode("utf-8", errors="replace")
        return arr

    def tagged_count(self, tag: int) -> int:
        got_tag = self.i4()
        n = self.count()
        if got_tag == 0 and n == 0:
            return 0  # ABSENT
        if got_tag != tag:
            raise ValueError(f"bad netCDF tag {got_tag:#x}, expected {tag:#x}")
        return n

    def att_list(self) -> dict:
        out = {}
        for _ in range(self.tagged_count(_NC_ATTRIBUTE)):
            name = self.name()
            nc_type = self.i4()
            n = self.count()
            out[name] = self.values(nc_type, n)
        return out


def _pad4(n: int) -> int:
    return (n + 3) & ~3


def read_classic(path: str) -> NcFile:
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:3] != b"CDF":
        raise ValueError(f"{path}: not a classic netCDF file")
    version = buf[3]
    if version not in (1, 2, 5):
        raise ValueError(f"{path}: unsupported CDF version {version}")
    cur = _Cursor(buf, version)
    cur.pos = 4
    numrecs = cur.count()  # STREAMING (-1) not supported; fine for assets

    # dim_list
    dim_names, dim_sizes = [], []
    for _ in range(cur.tagged_count(_NC_DIMENSION)):
        dim_names.append(cur.name())
        dim_sizes.append(cur.count())
    rec_dim = dim_sizes.index(0) if 0 in dim_sizes else -1

    gatts = cur.att_list()

    # var_list
    headers = []
    for _ in range(cur.tagged_count(_NC_VARIABLE)):
        name = cur.name()
        ndims = cur.count()
        dimids = [cur.count() for _ in range(ndims)]
        vatts = cur.att_list()
        nc_type = cur.i4()
        _vsize = cur.count()
        begin = cur.offset()
        headers.append((name, dimids, vatts, nc_type, begin))

    variables: dict[str, NcVar] = {}
    rec_vars = [h for h in headers if h[1] and h[1][0] == rec_dim]
    # recsize = sum of padded per-record slabs (unless a single record var,
    # which is unpadded per the spec)
    recsize = 0
    for _, dimids, _, nc_type, _ in rec_vars:
        dt, size = _NC_TYPES[nc_type]
        n = int(np.prod([dim_sizes[d] for d in dimids[1:]], dtype=np.int64))
        recsize += _pad4(n * size) if len(rec_vars) > 1 else n * size

    for name, dimids, vatts, nc_type, begin in headers:
        dt, _size = _NC_TYPES[nc_type]
        dims = tuple(dim_names[d] for d in dimids)
        is_rec = bool(dimids) and dimids[0] == rec_dim
        if not is_rec:
            shape = tuple(dim_sizes[d] for d in dimids)
            n = int(np.prod(shape, dtype=np.int64))
            data = np.frombuffer(buf, dtype=dt, count=n, offset=begin).reshape(shape)
        else:
            slab_shape = tuple(dim_sizes[d] for d in dimids[1:])
            n = int(np.prod(slab_shape, dtype=np.int64))
            recs = []
            for r in range(numrecs):
                off = begin + r * recsize
                recs.append(np.frombuffer(buf, dtype=dt, count=n, offset=off))
            data = (
                np.stack(recs).reshape((numrecs,) + slab_shape)
                if recs
                else np.empty((0,) + slab_shape, dtype=dt)
            )
            shape = (numrecs,) + slab_shape
        data = data.astype(data.dtype.newbyteorder("="))
        variables[name] = NcVar(name, dims, shape, data, vatts)

    dims = {n: (numrecs if s == 0 else s) for n, s in zip(dim_names, dim_sizes)}
    return NcFile(dims=dims, attrs=gatts, variables=variables)


def read_hdf5(path: str) -> NcFile:
    import h5py

    variables = {}
    dims = {}
    with h5py.File(path, "r") as f:
        attrs = {k: v for k, v in f.attrs.items() if not k.startswith("_")}

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                data = obj[()]
                dimnames = tuple(
                    (d.label or f"dim{i}") for i, d in enumerate(obj.dims)
                )
                variables[name] = NcVar(
                    name,
                    dimnames,
                    tuple(np.shape(data)),
                    np.asarray(data),
                    {k: v for k, v in obj.attrs.items() if not k.startswith("_")},
                )

        f.visititems(visit)
    for v in variables.values():
        for dn, s in zip(v.dims, v.shape):
            dims.setdefault(dn, s)
    return NcFile(dims=dims, attrs=attrs, variables=variables)


def read_netcdf(path: str) -> NcFile:
    """Read any .nc file (classic CDF 1/2/5 or netCDF-4/HDF5) into numpy."""
    with open(path, "rb") as f:
        magic = f.read(8)
    if magic[:3] == b"CDF":
        return read_classic(path)
    if magic[:8] == b"\x89HDF\r\n\x1a\n":
        return read_hdf5(path)
    raise ValueError(f"{path}: unrecognized netCDF container")
