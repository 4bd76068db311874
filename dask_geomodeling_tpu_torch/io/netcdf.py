"""netCDF rasters, and the CF conventions shared by the gridded-container
readers.

Counterpart of dask_geomodeling_tpu/io/netcdf.py, copied.  netCDF
classic files (CDF-1, 32-bit offsets; CDF-2, 64-bit offsets) are parsed
on the stdlib: the header (dimensions, attributes, variables), big-endian
fixed and record data (several record variables interleave record by
record; the STREAMING record count derives from the file's length), the
unlimited (time) dimension as the band axis.  netCDF-4 (HDF5-based) files
go through ``h5py`` where it is importable, imported at call time; without
it they raise NotImplementedError.

Both funnel into the CF assembly that the Zarr reader (io/zarr.py) shares:
``_crs_from_atts`` (the CRS from ``grid_mapping``/``spatial_ref``/
``crs_wkt``/``epsg_code`` attributes) and ``_assemble_raster``
(orientation, geotransform from cell centres, ``scale_factor``/
``add_offset`` unpacking to float32, the fill).

``read_netcdf`` returns the RasterData payload the GeoTIFF codec gives;
``read_netcdf_window`` one north-up pixel window (a classic file's is a
slice of the whole decode, which it takes from the read cache;
an HDF5 file's slices the dataset); ``read_netcdf_info`` the header (a
classic file decodes whole, an HDF5 file reads its metadata and
coordinates only); ``write_netcdf`` a minimal CF CDF-1 file.
"""
import struct

import numpy as np

__all__ = ["read_netcdf", "read_netcdf_window", "read_netcdf_info", "write_netcdf"]

_ABSENT = 0
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_HDF5_MAGIC = b"\x89HDF"

#: nc_type -> (numpy dtype, size)
_TYPES = {
    1: (np.dtype(">i1"), 1),  # NC_BYTE
    2: (np.dtype("S1"), 1),  # NC_CHAR
    3: (np.dtype(">i2"), 2),  # NC_SHORT
    4: (np.dtype(">i4"), 4),  # NC_INT
    5: (np.dtype(">f4"), 4),  # NC_FLOAT
    6: (np.dtype(">f8"), 8),  # NC_DOUBLE
}


class _Reader:
    """Big-endian header primitives over the file's bytes."""

    def __init__(self, raw):
        self.raw = raw
        self.pos = 0

    def u4(self):
        (v,) = struct.unpack_from(">I", self.raw, self.pos)
        self.pos += 4
        return v

    def i8(self):
        (v,) = struct.unpack_from(">Q", self.raw, self.pos)
        self.pos += 8
        return v

    def name(self):
        n = self.u4()
        value = self.raw[self.pos : self.pos + n].decode("utf-8")
        self.pos += n + ((4 - n % 4) % 4)  # padded to 4
        return value

    def values(self, nc_type, count):
        dtype, size = _TYPES[nc_type]
        data = np.frombuffer(self.raw, dtype, count, self.pos)
        self.pos += size * count + ((4 - (size * count) % 4) % 4)
        if nc_type == 2:
            return data.tobytes().decode("utf-8", "replace")
        return data

    def att_list(self):
        tag = self.u4()
        count = self.u4()
        atts = {}
        if tag == _ABSENT and count == 0:
            return atts
        for _ in range(count):
            name = self.name()
            nc_type = self.u4()
            n = self.u4()
            atts[name] = self.values(nc_type, n)
        return atts


def _parse_header(raw):
    """(numrecs, [(dim name, length)], global atts, [variable dicts]) of a
    classic file's bytes."""
    reader = _Reader(raw)
    if raw[:3] != b"CDF":
        if raw[:4] == _HDF5_MAGIC:
            raise NotImplementedError(
                "netCDF-4 (HDF5-based) files are not supported; "
                "convert to netCDF classic (nccopy -k classic)"
            )
        raise IOError("Not a netCDF classic file")
    version = raw[3]
    if version not in (1, 2):
        raise NotImplementedError(
            "netCDF-4 (HDF5-based) files are not supported; "
            "convert to netCDF classic (nccopy -k classic)"
        )
    offsize = 8 if version == 2 else 4
    reader.pos = 4
    numrecs = reader.u4()

    tag = reader.u4()
    count = reader.u4()
    dims = []
    if tag == _NC_DIMENSION:
        for _ in range(count):
            dims.append((reader.name(), reader.u4()))
    gatts = reader.att_list()

    tag = reader.u4()
    count = reader.u4()
    variables = []
    if tag == _NC_VARIABLE:
        for _ in range(count):
            name = reader.name()
            ndims = reader.u4()
            dimids = [reader.u4() for _ in range(ndims)]
            atts = reader.att_list()
            nc_type = reader.u4()
            vsize = reader.u4()
            begin = reader.i8() if offsize == 8 else reader.u4()
            variables.append({"name": name, "dimids": dimids, "atts": atts, "type": nc_type,
                              "vsize": vsize, "begin": begin})
    return numrecs, dims, gatts, variables


def _read_var(raw, var, dims, numrecs):
    """One variable's array; a record variable gets the unlimited first
    axis, its slabs ``var["_slab_stride"]`` bytes apart."""
    dtype, size = _TYPES[var["type"]]
    shape = [dims[d][1] for d in var["dimids"]]
    is_record = bool(shape) and shape[0] == 0
    if not is_record:
        count = int(np.prod(shape)) if shape else 1
        data = np.frombuffer(raw, dtype, count, var["begin"])
        return data.reshape(shape) if shape else data[0]
    per_record = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    records = []
    pos = var["begin"]
    for _ in range(numrecs):
        records.append(np.frombuffer(raw, dtype, per_record, pos))
        pos += var["_slab_stride"]
    if not records:
        return np.empty([0] + shape[1:], dtype)
    return np.stack(records).reshape([numrecs] + shape[1:])


def _crs_from_atts(gatts, variables, data_var):
    """CF georeferencing: explicit WKT beats grid_mapping translation."""
    mapping = None
    name = data_var["atts"].get("grid_mapping")
    if isinstance(name, str):
        for var in variables:
            if var["name"] == name.strip():
                mapping = var["atts"]
                break
    for source in (mapping or {}, gatts):
        for key in ("spatial_ref", "crs_wkt"):
            wkt = source.get(key)
            if isinstance(wkt, str) and wkt.strip():
                return wkt.strip()
    if mapping is not None:
        epsg = mapping.get("epsg_code")
        if isinstance(epsg, str) and epsg.strip():
            return (
                epsg.strip()
                if epsg.strip().upper().startswith("EPSG")
                else "EPSG:" + epsg.strip()
            )
        gm = mapping.get("grid_mapping_name")
        if isinstance(gm, str) and gm.strip() == "latitude_longitude":
            return "EPSG:4326"
    return "EPSG:4326"


def _h5_att(value):
    """An h5py attribute in the classic parser's convention (text as str,
    numbers as arrays or scalars)."""
    if isinstance(value, bytes):
        return value.decode("utf-8", "replace")
    if isinstance(value, np.ndarray) and value.dtype.kind in ("S", "O"):
        parts = [v.decode("utf-8", "replace") if isinstance(v, bytes) else str(v)
                 for v in value.ravel()]
        return "".join(parts) if len(parts) == 1 else parts
    return value


def _h5_scan(handle, path, variable):
    """(gatts, variables, data_var) of an open h5py file: every dataset of
    every group, and the data variable (``variable``, else the largest
    numeric one of two or more dimensions that is no dimension scale)."""
    import h5py

    datasets = []
    handle.visititems(
        lambda name, obj: datasets.append((name, obj)) if isinstance(obj, h5py.Dataset) else None
    )
    gatts = {k: _h5_att(v) for k, v in handle.attrs.items()}
    variables = []
    for name, ds in datasets:
        atts = {k: _h5_att(v) for k, v in ds.attrs.items()}
        variables.append({"name": name.split("/")[-1], "atts": atts, "_ds": ds, "_path": name})

    candidates = [v for v in variables
                  if v["_ds"].ndim >= 2 and not _is_dim_scale(v) and v["_ds"].dtype.kind in "iuf"]
    if variable is not None:
        candidates = [v for v in candidates if v["name"] == variable or v["_path"] == variable]
    if not candidates:
        raise IOError("No 2-D data variable in '%s'" % path)
    data_var = max(candidates, key=lambda v: v["_ds"].size)
    return gatts, variables, data_var


def _is_dim_scale(var):
    return var["atts"].get("CLASS") == "DIMENSION_SCALE"


_AXIS_NAMES = {
    "x": ("x", "lon", "longitude", "easting"),
    "y": ("y", "lat", "latitude", "northing"),
}


def _h5_centers(variables, data_var, axis, length, role):
    """Cell centres along one axis: a dimension scale attached to the axis,
    else a 1-D dimension scale matched by name (a length alone is
    ambiguous on a square grid), else the one of that length, else pixel
    indices."""
    ds = data_var["_ds"]
    try:
        scales = [s for s in ds.dims[axis].values() if s.size]
    except Exception:
        scales = []
    for scale in scales:
        if scale.ndim == 1 and len(scale) == length:
            return np.asarray(scale, dtype=float)
    loose = [v for v in variables
             if v["_ds"].ndim == 1 and len(v["_ds"]) == length and _is_dim_scale(v)]
    named = [v for v in loose
             if v["name"].lower() in _AXIS_NAMES[role]
             or str(v["atts"].get("axis", "")).upper() == role.upper()]
    if len(named) == 1:
        return np.asarray(named[0]["_ds"], dtype=float)
    if len(loose) == 1:
        return np.asarray(loose[0]["_ds"], dtype=float)
    return np.arange(length, dtype=float)


def _h5py_or_raise():
    try:
        import h5py
    except ImportError:
        raise NotImplementedError(
            "netCDF-4 (HDF5-based) files need h5py, which is not "
            "available; convert to netCDF classic (nccopy -k classic)"
        )
    return h5py


def _read_netcdf4(path, variable=None, window=None):
    """A netCDF-4 (HDF5) file through h5py, into the shared CF assembly.
    ``window`` (north-up ``(row0, row1, col0, col1)``, clamped) slices the
    dataset, so h5py reads only the chunks it touches; its rows flip for
    ascending ``y``, and the full grid's spacing survives a 1-pixel
    slice."""
    h5py = _h5py_or_raise()

    with h5py.File(path, "r") as handle:
        gatts, variables, data_var = _h5_scan(handle, path, variable)
        ds = data_var["_ds"]
        height, width = ds.shape[-2:]
        xs = _h5_centers(variables, data_var, ds.ndim - 1, width, "x")
        ys = _h5_centers(variables, data_var, ds.ndim - 2, height, "y")
        spacing = None
        if window is None:
            array = np.asarray(ds)
        else:
            row0, row1, col0, col1 = window
            row0 = max(0, min(int(row0), height - 1))
            row1 = max(row0 + 1, min(int(row1), height))
            col0 = max(0, min(int(col0), width - 1))
            col1 = max(col0 + 1, min(int(col1), width))
            ascending = len(ys) > 1 and ys[1] > ys[0]
            if ascending:  # south-up storage: flip the window rows
                s0, s1 = height - row1, height - row0
            else:
                s0, s1 = row0, row1
            spacing = (
                float(xs[1] - xs[0]) if len(xs) > 1 else 1.0,
                float(ys[1] - ys[0]) if len(ys) > 1 else -1.0,
            )
            array = np.asarray(ds[..., s0:s1, col0:col1])
            xs = xs[col0:col1]
            ys = ys[s0:s1]
        return _assemble_raster(gatts, variables, data_var, array, xs, ys, spacing=spacing)


def _is_hdf5(path):
    with open(path, "rb") as f:
        return f.read(8)[:4] == _HDF5_MAGIC


def read_netcdf(path, variable=None):
    """Read a CF-georeferenced netCDF file into RasterData.

    Classic (CDF-1/CDF-2) files are parsed natively; netCDF-4
    (HDF5-based) files go through ``h5py`` when available.
    ``variable`` selects the data variable by name; by default the
    largest non-coordinate variable with >= 2 dimensions wins (the first
    of equal-sized ones).
    """
    if _is_hdf5(path):
        return _read_netcdf4(path, variable)

    with open(path, "rb") as stream:
        raw = stream.read()
    numrecs, dims, gatts, variables = _parse_header(raw)

    # the record-slab stride: the sum of every record variable's vsize
    # (they interleave record by record), the bare slab when one records
    record_vars = [v for v in variables if v["dimids"] and dims[v["dimids"][0]][1] == 0]
    stride = sum(v["vsize"] for v in record_vars)
    for var in record_vars:
        _, size = _TYPES[var["type"]]
        per = int(np.prod([dims[d][1] for d in var["dimids"][1:]] or [1]))
        var["_slab_stride"] = stride if len(record_vars) > 1 else per * size
    if numrecs == 0xFFFFFFFF:
        # the STREAMING sentinel: the count derives from the file's length
        if record_vars:
            begin = min(v["begin"] for v in record_vars)
            slab = stride if len(record_vars) > 1 else record_vars[0]["_slab_stride"]
            numrecs = max((len(raw) - begin) // max(slab, 1), 0)
        else:
            numrecs = 0

    dim_names = [d[0] for d in dims]
    coord_vars = {v["name"]: v for v in variables
                  if len(v["dimids"]) == 1 and v["name"] in dim_names}
    candidates = [v for v in variables
                  if len(v["dimids"]) >= 2 and v["name"] not in coord_vars]
    if variable is not None:
        candidates = [v for v in candidates if v["name"] == variable]
    if not candidates:
        raise IOError("No 2-D data variable in '%s'" % path)
    data_var = max(candidates,
                   key=lambda v: int(np.prod([dims[d][1] or numrecs for d in v["dimids"]])))

    array = _read_var(raw, data_var, dims, numrecs)

    # the grid: the coordinate variables of the last two dimensions hold
    # the cell centres (CF projections are regular)
    y_dim = dim_names[data_var["dimids"][-2]]
    x_dim = dim_names[data_var["dimids"][-1]]

    def centers(dim_name, length):
        var = coord_vars.get(dim_name)
        if var is None:
            return np.arange(length, dtype=float)
        return np.asarray(_read_var(raw, var, dims, numrecs), dtype=float)

    height, width = array.shape[-2:]
    return _assemble_raster(gatts, variables, data_var, array,
                            centers(x_dim, width), centers(y_dim, height))


def read_netcdf_window(path, row0, row1, col0, col1, variable=None):
    """One north-up pixel window (clamped to the grid): an HDF5-based file
    slices the dataset; a classic file, a whole-file byte read anyway,
    slices its whole decode, which it takes from the read cache under
    ``(path, variable)`` (the JAX package's does so for ``variable`` None
    only and decodes anew otherwise: the same values)."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData
    from dask_geomodeling_tpu_torch.runtime.pipeline import read_geotiff_cached

    if _is_hdf5(path):
        return _read_netcdf4(path, variable, window=(int(row0), int(row1), int(col0), int(col1)))
    data = read_geotiff_cached(path, variable)
    _, height, width = data.array.shape
    row0 = max(0, min(int(row0), height - 1))
    row1 = max(row0 + 1, min(int(row1), height))
    col0 = max(0, min(int(col0), width - 1))
    col1 = max(col0 + 1, min(int(col1), width))
    gt = data.geo_transform
    return RasterData(
        array=np.ascontiguousarray(data.array[:, row0:row1, col0:col1]),
        projection=data.projection,
        geo_transform=(gt[0] + col0 * gt[1], gt[1], gt[2], gt[3] + row0 * gt[5], gt[4], gt[5]),
        no_data_value=data.no_data_value,
        metadata=data.metadata,
    )


def read_netcdf_info(path, variable=None):
    """The header as a GeoTIFFInfo.  A classic file decodes whole, through
    the read cache under ``(path, variable)`` (the JAX package's decodes
    it uncached: the same values); an HDF5-based file gives its grid,
    dtype, CRS and fill from the metadata and the small coordinate arrays,
    reading no data chunk."""
    from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max
    from dask_geomodeling_tpu_torch.io.geotiff import GeoTIFFInfo
    from dask_geomodeling_tpu_torch.runtime.pipeline import read_geotiff_cached

    if not _is_hdf5(path):
        data = read_geotiff_cached(path, variable)
        bands, height, width = data.array.shape
        return GeoTIFFInfo(
            width=width, height=height, bands=bands, dtype=str(data.array.dtype),
            projection=data.projection, geo_transform=data.geo_transform,
            no_data_value=data.no_data_value, metadata=data.metadata,
        )
    h5py = _h5py_or_raise()
    with h5py.File(path, "r") as handle:
        gatts, variables, data_var = _h5_scan(handle, path, variable)
        ds = data_var["_ds"]
        shape = ds.shape
        height, width = shape[-2:]
        bands = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
        xs = _h5_centers(variables, data_var, ds.ndim - 1, width, "x")
        ys = _h5_centers(variables, data_var, ds.ndim - 2, height, "y")
        atts = data_var["atts"]
        # _assemble_raster's grid, packing and fill rules
        dx = float(xs[1] - xs[0]) if len(xs) > 1 else 1.0
        dy = float(ys[1] - ys[0]) if len(ys) > 1 else -1.0
        y_top = float(ys[-1]) if dy > 0 else float(ys[0])
        dy = -abs(dy)
        dtype = np.dtype(ds.dtype).newbyteorder("=")

        def scalar(name):
            value = atts.get(name)
            if value is None:
                return None
            arr = np.asarray(value)
            return float(arr.ravel()[0]) if arr.size else None

        fill = scalar("_FillValue")
        if fill is None:
            fill = scalar("missing_value")
        if "scale_factor" in atts or "add_offset" in atts:
            dtype = np.dtype(np.float32)
            if fill is not None:
                fill = float(np.finfo(np.float32).max)
        if fill is None:
            fill = float(get_dtype_max(dtype))
        label = atts.get("long_name") or atts.get("units") or data_var["name"]
        return GeoTIFFInfo(
            width=width, height=height, bands=bands, dtype=str(dtype),
            projection=_crs_from_atts(gatts, variables, data_var),
            geo_transform=(float(xs[0]) - dx / 2, dx, 0.0, y_top - dy / 2, 0.0, dy),
            no_data_value=float(fill),
            metadata=[str(label)] * bands,
        )


def _assemble_raster(gatts, variables, data_var, array, xs, ys, spacing=None):
    """Shared CF assembly: orientation, geotransform, packing, CRS.

    ``variables`` is the attribute-bearing variable list (dicts with
    "name" and "atts"); ``xs``/``ys`` are cell-center coordinates along
    the last two axes.  ``spacing`` supplies (dx, dy) in storage order for
    windowed callers whose coordinate slice may be a single element (a
    1-px window must not fabricate a 1.0-unit cell size).
    """
    from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    if array.ndim == 2:
        array = array[None]
    elif array.ndim > 3:
        array = array.reshape((-1,) + array.shape[-2:])

    default_dx, default_dy = spacing if spacing is not None else (1.0, -1.0)
    dx = float(xs[1] - xs[0]) if len(xs) > 1 else float(default_dx)
    dy = float(ys[1] - ys[0]) if len(ys) > 1 else float(default_dy)
    if dy > 0:  # south-up storage: flip rows into the north-up contract
        array = array[:, ::-1, :]
        ys = ys[::-1]
        dy = -dy
    geo_transform = (
        float(xs[0]) - dx / 2,
        dx,
        0.0,
        float(ys[0]) - dy / 2,
        0.0,
        dy,
    )

    atts = data_var["atts"]

    def scalar(name):
        value = atts.get(name)
        if value is None:
            return None
        arr = np.asarray(value)
        return float(arr.ravel()[0]) if arr.size else None

    fill = scalar("_FillValue")
    if fill is None:
        fill = scalar("missing_value")
    scale = scalar("scale_factor")
    offset = scalar("add_offset")
    array = np.ascontiguousarray(array)
    if scale is not None or offset is not None:
        unpacked = array.astype(np.float32) * (
            1.0 if scale is None else scale
        ) + (0.0 if offset is None else offset)
        if fill is not None:
            mask = array == np.asarray(fill, array.dtype)
            fill = float(np.finfo(np.float32).max)
            unpacked[mask] = fill
        array = unpacked
    else:
        # a native-endian copy: torch takes no big-endian buffer
        array = array.astype(array.dtype.newbyteorder("="))

    if fill is None:
        fill = float(get_dtype_max(array.dtype))

    label = atts.get("long_name") or atts.get("units") or data_var["name"]
    return RasterData(
        array=array,
        projection=_crs_from_atts(gatts, variables, data_var),
        geo_transform=geo_transform,
        no_data_value=float(fill),
        metadata=[str(label)] * array.shape[0],
    )


def write_netcdf(path, values, geo_transform, projection=None, no_data_value=None,
                 variable="data", scale_factor=None, add_offset=None):
    """Write (bands, h, w) data as a minimal CF netCDF classic file (CDF-1:
    a ``band``, ``y`` and ``x`` dimension, ``x``/``y`` float64 cell
    centres, one data variable, the CRS as a ``spatial_ref`` global WKT
    attribute), byte for byte as the JAX package's writer.
    ``scale_factor``/``add_offset`` attach CF packing attributes (the
    values are stored as given; readers unpack).  The file is written in
    one buffered write."""
    values = np.asarray(values)
    if values.ndim == 2:
        values = values[None]
    bands, height, width = values.shape
    p, a, b, q, c, d = geo_transform
    xs = p + a * (np.arange(width) + 0.5)
    ys = q + d * (np.arange(height) + 0.5)

    nc_type = {"i1": 1, "i2": 3, "i4": 4, "f4": 5, "f8": 6}.get(
        values.dtype.newbyteorder("=").str[1:])
    if nc_type is None:
        values = values.astype(np.float32)
        nc_type = 5
    dtype, size = _TYPES[nc_type]

    def pad4(b_):
        return b_ + b"\x00" * ((4 - len(b_) % 4) % 4)

    def name(s):
        e = s.encode()
        return struct.pack(">I", len(e)) + pad4(e)

    def att(key, nc_t, payload):
        return name(key) + struct.pack(">II", nc_t, len(payload)) + pad4(
            np.asarray(payload, _TYPES[nc_t][0]).tobytes())

    def att_text(key, text):
        e = text.encode()
        return name(key) + struct.pack(">II", 2, len(e)) + pad4(e)

    header = b"CDF\x01" + struct.pack(">I", 0)
    header += struct.pack(">II", _NC_DIMENSION, 3)
    header += name("band") + struct.pack(">I", bands)
    header += name("y") + struct.pack(">I", height)
    header += name("x") + struct.pack(">I", width)
    gatts = [att_text("Conventions", "CF-1.6")]
    if projection is not None:
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        gatts.append(att_text("spatial_ref", get_sr(projection).ExportToWkt()))
    header += struct.pack(">II", _NC_ATTRIBUTE, len(gatts)) + b"".join(gatts)

    def var_header(vname, dimids, atts_blob, n_atts, nc_t, vsize, begin):
        blob = name(vname)
        blob += struct.pack(">I", len(dimids))
        for dimid in dimids:
            blob += struct.pack(">I", dimid)
        if n_atts:
            blob += struct.pack(">II", _NC_ATTRIBUTE, n_atts) + atts_blob
        else:
            blob += struct.pack(">II", _ABSENT, 0)
        blob += struct.pack(">III", nc_t, vsize, begin)
        return blob

    x_size = width * 8
    y_size = height * 8
    data_size = bands * height * width * size
    data_atts = []
    if no_data_value is not None:
        data_atts.append(att("_FillValue", nc_type, [no_data_value]))
    if scale_factor is not None:
        data_atts.append(att("scale_factor", 6, [scale_factor]))
    if add_offset is not None:
        data_atts.append(att("add_offset", 6, [add_offset]))

    # the header's length, found by iterating: the begin offsets are in it
    begin_guess = 0
    for _ in range(3):
        x_begin = begin_guess
        y_begin = x_begin + ((x_size + 3) // 4) * 4
        d_begin = y_begin + ((y_size + 3) // 4) * 4
        vars_blob = struct.pack(">II", _NC_VARIABLE, 3)
        vars_blob += var_header("x", [2], b"", 0, 6, x_size, x_begin)
        vars_blob += var_header("y", [1], b"", 0, 6, y_size, y_begin)
        vars_blob += var_header(variable, [0, 1, 2], b"".join(data_atts), len(data_atts),
                                nc_type, data_size, d_begin)
        begin_guess = len(header) + len(vars_blob)
    with open(path, "wb") as f:
        f.write(b"".join([header, vars_blob, pad4(xs.astype(">f8").tobytes()),
                          pad4(ys.astype(">f8").tobytes()), pad4(values.astype(dtype).tobytes())]))
