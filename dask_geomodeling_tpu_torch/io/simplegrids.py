"""Simple scientific grid formats: Surfer, SAGA, Idrisi.

Counterpart of dask_geomodeling_tpu/io/simplegrids.py, copied: the same
RasterData payloads as the JAX readers, and the JAX writers' bytes.
Each format is a small header plus a flat array:

- **Surfer 6 ASCII** (``DSAA``): node-registered text grid, rows run
  south to north; blanks are values >= 1.70141e38
- **Surfer 6 binary** (``DSBB``): int16 nx/ny + double extents +
  float32 rows south to north
- **Surfer 7 binary** (``DSRB``): tagged sections (header/grid/data),
  cell-centre origin, per-file blank value, double data
- **SAGA** (``.sgrd`` ASCII header + ``.sdat`` flat binary): cell-centre
  POSITION_XMIN/YMIN, TOPTOBOTTOM flag, either byte order
- **Idrisi** (``.rst`` flat binary + ``.rdc`` ASCII metadata): byte/
  integer/real types, rows top to bottom, flag value as nodata

Surfer grids are node-registered (values sit at grid nodes, both edges
included): pixel-is-point is exposed as pixel-is-area via the usual
half-sample shift, matching GDAL and the SRTM reader (io/dem.py).  The
CRS of every format but Idrisi's ``ref. system`` comes from a sidecar
(io/asciigrid.py:_sidecar_projection).
"""
import os
import struct

import numpy as np

from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max
from dask_geomodeling_tpu_torch.io.asciigrid import _sidecar_projection

__all__ = [
    "read_surfer", "write_surfer", "read_saga", "write_saga", "read_idrisi",
]

#: Surfer's blank sentinel (anything >= this is a blank node)
_SURFER_BLANK = 1.70141e38


def _raster_data(array, geo_transform, no_data, projection):
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    return RasterData(
        array=array,
        projection=projection,
        geo_transform=tuple(geo_transform),
        no_data_value=no_data,
        metadata=[""] * array.shape[0],
    )


def _node_registered_gt(xlo, xhi, ylo, yhi, nx, ny):
    dx = (xhi - xlo) / (nx - 1) if nx > 1 else 1.0
    dy = (yhi - ylo) / (ny - 1) if ny > 1 else 1.0
    return (xlo - dx / 2.0, dx, 0.0, yhi + dy / 2.0, 0.0, -dy)


def read_surfer(path):
    """Read a Surfer grid (``DSAA`` text, ``DSBB`` or ``DSRB`` binary)."""
    with open(path, "rb") as f:
        raw = f.read()
    magic = raw[:4]
    if magic == b"DSAA":
        return _read_surfer_ascii(raw, path)
    if magic == b"DSBB":
        return _read_surfer6(raw, path)
    if magic == b"DSRB":
        return _read_surfer7(raw, path)
    raise IOError("Not a Surfer grid (no DSAA/DSBB/DSRB magic): '%s'" % path)


def _read_surfer_ascii(raw, path):
    fields = raw.decode("ascii", "replace").split()
    if len(fields) < 9:
        raise IOError("Truncated Surfer ASCII grid: '%s'" % path)
    nx, ny = int(fields[1]), int(fields[2])
    xlo, xhi, ylo, yhi = (float(v) for v in fields[3:7])
    values = np.array(fields[9 : 9 + nx * ny], dtype=np.float64)
    if values.size != nx * ny:
        raise IOError(
            "Surfer ASCII grid holds %d of %d values: '%s'"
            % (values.size, nx * ny, path)
        )
    grid = values.reshape(ny, nx)[::-1]  # rows run south->north in file
    return _finish_surfer(grid, xlo, xhi, ylo, yhi, nx, ny, path)


def _read_surfer6(raw, path):
    if len(raw) < 56:
        raise IOError("Truncated Surfer 6 grid: '%s'" % path)
    nx, ny = struct.unpack("<hh", raw[4:8])
    xlo, xhi, ylo, yhi = struct.unpack("<4d", raw[8:40])
    values = np.frombuffer(raw[56:], dtype="<f4", count=nx * ny)
    grid = values.astype(np.float64).reshape(ny, nx)[::-1]
    return _finish_surfer(grid, xlo, xhi, ylo, yhi, nx, ny, path)


def _read_surfer7(raw, path):
    pos = 0
    grid_header = None
    data = None
    while pos + 8 <= len(raw):
        tag, size = struct.unpack("<II", raw[pos : pos + 8])
        body = raw[pos + 8 : pos + 8 + size]
        pos += 8 + size
        if tag == 0x42525344:  # 'DSRB' header section
            continue
        if tag == 0x44495247:  # 'GRID'
            grid_header = body
        elif tag == 0x41544144:  # 'DATA'
            data = body
    if grid_header is None or data is None:
        raise IOError("Surfer 7 grid missing GRID/DATA sections: '%s'" % path)
    ny, nx = struct.unpack("<II", grid_header[0:8])
    xll, yll, dx, dy, zmin, zmax, rotation, blank = struct.unpack(
        "<8d", grid_header[8:72]
    )
    if rotation not in (0, 0.0):
        raise NotImplementedError("Rotated Surfer 7 grids are not supported")
    values = np.frombuffer(data, dtype="<f8", count=nx * ny)
    grid = values.reshape(ny, nx)[::-1].copy()
    fill = float(np.finfo("f4").max)
    grid[grid >= blank] = fill
    yhi = yll + dy * (ny - 1)
    geo_transform = (xll - dx / 2.0, dx, 0.0, yhi + dy / 2.0, 0.0, -dy)
    return _raster_data(
        grid[np.newaxis], geo_transform, fill, _sidecar_projection(path)
    )


def _finish_surfer(grid, xlo, xhi, ylo, yhi, nx, ny, path):
    grid = grid.copy()
    fill = float(np.finfo("f4").max)
    grid[grid >= _SURFER_BLANK] = fill
    return _raster_data(
        grid[np.newaxis], _node_registered_gt(xlo, xhi, ylo, yhi, nx, ny),
        fill, _sidecar_projection(path),
    )


def write_surfer(path, array, geo_transform, no_data_value=None,
                 fmt="binary"):
    """Write a single-band Surfer 6 grid (``binary`` DSBB or ``ascii``
    DSAA); nodata cells become Surfer blanks."""
    array = np.asarray(array, dtype=np.float64)
    if array.ndim == 3:
        if array.shape[0] != 1:
            raise ValueError("Surfer grids are single-band")
        array = array[0]
    ny, nx = array.shape
    ox, dx, _, oy, _, dy = (float(v) for v in geo_transform)
    xlo, xhi = ox + dx / 2.0, ox + dx / 2.0 + dx * (nx - 1)
    yhi = oy + dy / 2.0  # dy < 0: first row centre
    ylo = yhi + dy * (ny - 1)
    out = array[::-1].copy()  # rows run south->north in the file
    if no_data_value is not None:
        out[np.isclose(array[::-1], no_data_value)] = 1.70141e38
    finite = out[out < _SURFER_BLANK]
    zlo = float(finite.min()) if finite.size else 0.0
    zhi = float(finite.max()) if finite.size else 0.0
    if fmt == "binary":
        with open(path, "wb") as f:
            f.write(b"DSBB")
            f.write(struct.pack("<hh", nx, ny))
            f.write(struct.pack("<6d", xlo, xhi, ylo, yhi, zlo, zhi))
            f.write(out.astype("<f4").tobytes())
    elif fmt == "ascii":
        with open(path, "w") as f:
            f.write("DSAA\n%d %d\n" % (nx, ny))
            f.write("%.10g %.10g\n%.10g %.10g\n%.10g %.10g\n"
                    % (xlo, xhi, ylo, yhi, zlo, zhi))
            for row in out:
                f.write(" ".join("%.10g" % v for v in row) + "\n")
    else:
        raise ValueError("fmt must be 'binary' or 'ascii': %r" % fmt)


_SAGA_DTYPES = {
    "BIT": "u1", "BYTE_UNSIGNED": "u1", "BYTE": "i1",
    "SHORTINT_UNSIGNED": "u2", "SHORTINT": "i2",
    "INTEGER_UNSIGNED": "u4", "INTEGER": "i4",
    "FLOAT": "f4", "DOUBLE": "f8",
}


def read_saga(path):
    """Read a SAGA grid (``.sgrd`` header + ``.sdat`` data)."""
    base, ext = os.path.splitext(path)
    header_path = base + (".sgrd" if ext.lower() != ".sgrd" else ext)
    if ext.lower() == ".sgrd":
        header_path = path
    elif not os.path.exists(header_path):
        header_path = base + ".SGRD"
    fields = {}
    with open(header_path) as f:
        for line in f:
            if "=" in line:
                key, _, value = line.partition("=")
                fields[key.strip().upper()] = value.strip()
    nx = int(fields["CELLCOUNT_X"])
    ny = int(fields["CELLCOUNT_Y"])
    dx = float(fields["CELLSIZE"])
    xmin = float(fields["POSITION_XMIN"])  # cell centre
    ymin = float(fields["POSITION_YMIN"])
    nodata = float(fields.get("NODATA_VALUE", "-99999").split(";")[0])
    fmt = fields.get("DATAFORMAT", "FLOAT").upper()
    if fmt not in _SAGA_DTYPES:
        raise NotImplementedError("SAGA data format %r" % fmt)
    bo = ">" if fields.get("BYTEORDER_BIG", "FALSE").upper() == "TRUE" else "<"
    dtype = np.dtype(bo + _SAGA_DTYPES[fmt])
    offset = int(fields.get("DATAFILE_OFFSET", "0"))
    data_path = os.path.splitext(header_path)[0] + ".sdat"
    if not os.path.exists(data_path):
        data_path = os.path.splitext(header_path)[0] + ".SDAT"
    with open(data_path, "rb") as f:
        f.seek(offset)
        values = np.frombuffer(f.read(), dtype=dtype, count=nx * ny)
    grid = values.reshape(ny, nx)
    if fields.get("TOPTOBOTTOM", "FALSE").upper() != "TRUE":
        grid = grid[::-1]  # default: rows run south->north on disk
    geo_transform = (
        xmin - dx / 2.0, dx, 0.0, ymin + dx * (ny - 1) + dx / 2.0, 0.0, -dx,
    )
    return _raster_data(
        np.ascontiguousarray(grid)[np.newaxis].astype(grid.dtype.newbyteorder("=")),
        geo_transform, float(nodata), _sidecar_projection(header_path),
    )


def write_saga(path, array, geo_transform, no_data_value=None):
    """Write a single-band SAGA grid pair (``.sgrd`` + ``.sdat``).

    ``no_data_value`` defaults to SAGA's conventional -99999 when the
    dtype can hold it, else the dtype maximum (byte grids)."""
    array = np.asarray(array)
    if no_data_value is None:
        try:
            representable = array.dtype.type(-99999.0) == -99999.0
        except (OverflowError, ValueError):
            representable = False
        if representable:
            no_data_value = -99999.0
        else:
            no_data_value = float(get_dtype_max(array.dtype))
    if array.ndim == 3:
        if array.shape[0] != 1:
            raise ValueError("SAGA grids are single-band")
        array = array[0]
    ny, nx = array.shape
    ox, dx, _, oy, _, dy = (float(v) for v in geo_transform)
    if abs(abs(dy) - dx) > 1e-9 * dx:
        raise ValueError("SAGA grids require square cells")
    kind_map = {v: k for k, v in _SAGA_DTYPES.items()}
    fmt = kind_map.get(array.dtype.str[1:])
    if fmt is None:
        array = array.astype(np.float64)  # e.g. int64/float16 payloads
        fmt = "DOUBLE"
    base = os.path.splitext(path)[0]
    xmin = ox + dx / 2.0
    ymin = oy + dy * ny - dy / 2.0  # dy<0: southernmost cell centre
    with open(base + ".sgrd", "w") as f:
        f.write(
            "NAME\t= %s\nDATAFORMAT\t= %s\nDATAFILE_OFFSET\t= 0\n"
            "BYTEORDER_BIG\t= FALSE\nPOSITION_XMIN\t= %.10f\n"
            "POSITION_YMIN\t= %.10f\nCELLCOUNT_X\t= %d\nCELLCOUNT_Y\t= %d\n"
            "CELLSIZE\t= %.10f\nZ_FACTOR\t= 1.000000\n"
            "NODATA_VALUE\t= %f\nTOPTOBOTTOM\t= FALSE\n"
            % (os.path.basename(base), fmt, xmin, ymin, nx, ny, dx,
               float(no_data_value))
        )
    with open(base + ".sdat", "wb") as f:
        f.write(np.ascontiguousarray(array[::-1], array.dtype.newbyteorder("<")).tobytes())


_IDRISI_DTYPES = {
    "byte": "u1",
    "integer": "<i2",
    "real": "<f4",
}


def read_idrisi(path):
    """Read an Idrisi raster (``.rst`` data + ``.rdc`` metadata)."""
    base = os.path.splitext(path)[0]
    rdc = base + ".rdc"
    if not os.path.exists(rdc):
        rdc = base + ".RDC"
    fields = {}
    with open(rdc, errors="replace") as f:
        for line in f:
            key, _, value = line.partition(":")
            fields[key.strip().lower()] = value.strip()
    dtype_name = fields.get("data type", "real").lower()
    if dtype_name not in _IDRISI_DTYPES:
        raise NotImplementedError("Idrisi data type %r" % dtype_name)
    dtype = np.dtype(_IDRISI_DTYPES[dtype_name])
    nx = int(fields["columns"])
    ny = int(fields["rows"])
    xmin = float(fields["min. x"])
    xmax = float(fields["max. x"])
    ymin = float(fields["min. y"])
    ymax = float(fields["max. y"])
    flag = fields.get("flag value", "none")
    values = np.fromfile(path, dtype=dtype, count=nx * ny)
    grid = values.reshape(ny, nx)  # rows run north->south on disk
    # edge-registered extents (GDAL Idrisi convention)
    dx = (xmax - xmin) / nx
    dy = (ymax - ymin) / ny
    geo_transform = (xmin, dx, 0.0, ymax, 0.0, -dy)
    if flag and flag.lower() not in ("none", ""):
        nodata = float(flag)
    else:
        nodata = float(get_dtype_max(dtype))
    projection = None
    ref = fields.get("ref. system", "").lower()
    if ref.startswith("utm-"):
        zone = ref[4:]
        south = zone.endswith("s")
        zone_num = int(zone.rstrip("ns"))
        projection = "EPSG:%d" % ((32700 if south else 32600) + zone_num)
    elif ref.startswith("lat"):
        projection = "EPSG:4326"
    if projection is None:
        projection = _sidecar_projection(path)
    return _raster_data(
        grid[np.newaxis].astype(dtype.newbyteorder("=")), geo_transform,
        nodata, projection,
    )
