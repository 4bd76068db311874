"""Esri ASCII Grid (AAIGrid) and XYZ gridded-text raster readers.

Counterpart of dask_geomodeling_tpu/io/asciigrid.py, copied: the same
RasterData payload as the JAX readers, so ``RasterFileSource`` serves
both formats.  ``_sidecar_projection`` is the CRS convention of the
sidecar-georeferenced formats (PNG, Surfer, SAGA, Idrisi).

AAIGrid (``.asc``/``.agr``): ``ncols/nrows``, ``xllcorner``/``yllcorner``
(or ``xllcenter``/``yllcenter``), ``cellsize`` (or ``dx``+``dy``),
optional ``NODATA_value``, then nrows lines of values north to south.
Integer-only payloads load as int32, otherwise float32 (GDAL's
heuristic).  A sidecar ``.prj`` carries the CRS (WKT or EPSG text);
absent one, EPSG:4326 is assumed, matching common AAIGrid usage.

XYZ (``.xyz``): whitespace/comma/semicolon-separated ``x y z`` records
on a regular grid, any row order; the grid spacing is inferred from the
sorted unique coordinates (GDAL's XYZ driver contract: complete regular
grids; missing cells become nodata here rather than erroring).
"""
import os

import numpy as np

__all__ = ["read_ascii_grid", "read_xyz"]

_HEADER_KEYS = (
    "ncols", "nrows", "xllcorner", "yllcorner", "xllcenter", "yllcenter",
    "cellsize", "dx", "dy", "nodata_value",
)


def _sidecar_projection(path):
    """The CRS of a sidecar: GDAL's PAM (<path>.aux.xml) SRS before the
    .prj file; EPSG:4326 without either."""
    from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt
    from dask_geomodeling_tpu_torch.io.geotiff import _pam_overrides

    pam_srs, _ = _pam_overrides(path)
    if pam_srs is not None:
        try:
            return get_epsg_or_wkt(pam_srs)
        except Exception:
            return pam_srs
    for ext in (".prj", ".PRJ"):
        prj = os.path.splitext(path)[0] + ext
        if os.path.exists(prj):
            with open(prj) as stream:
                text = stream.read().strip()
            if text:
                try:
                    return get_epsg_or_wkt(text)
                except Exception:
                    return text
    return "EPSG:4326"


def read_ascii_grid(path):
    """Read an Esri ASCII grid into a RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    header = {}
    data_start = 0
    with open(path) as f:
        while True:
            pos = f.tell()
            line = f.readline()
            if not line:
                raise ValueError("%s: no data rows" % path)
            parts = line.split()
            key = parts[0].lower() if parts else ""
            if key in _HEADER_KEYS:
                header[key] = float(parts[1])
            else:
                data_start = pos
                break
        f.seek(data_start)
        # token stream, not line-oriented: Esri tooling wraps long rows
        tokens = f.read().split()

    ncols = int(header["ncols"])
    nrows = int(header["nrows"])
    if len(tokens) < nrows * ncols:
        raise ValueError("%s: expected %d values, found %d"
                         % (path, nrows * ncols, len(tokens)))
    values = np.array(tokens[: nrows * ncols], dtype=np.float64)
    values = values.reshape(nrows, ncols)
    dx = header.get("dx", header.get("cellsize"))
    dy = header.get("dy", header.get("cellsize"))
    if dx is None or dy is None:
        raise ValueError("%s: missing cellsize" % path)
    if "xllcorner" in header:
        x0 = header["xllcorner"]
    else:
        x0 = header["xllcenter"] - dx / 2
    if "yllcorner" in header:
        y0 = header["yllcorner"]
    else:
        y0 = header["yllcenter"] - dy / 2
    nodata = header.get("nodata_value")

    integral = bool(np.all(values == np.floor(values)))
    if integral and np.all(np.abs(values) < 2**31):
        array = values.astype(np.int32)
        no_data_value = int(nodata) if nodata is not None else -(2**31)
    else:
        array = values.astype(np.float32)
        no_data_value = (
            np.float32(nodata)
            if nodata is not None
            else float(np.finfo(np.float32).max)
        )
    # rows are stored north to south; origin is the upper-left corner
    geo_transform = (x0, dx, 0.0, y0 + nrows * dy, 0.0, -dy)
    return RasterData(
        array=array[None],
        projection=_sidecar_projection(path),
        geo_transform=geo_transform,
        no_data_value=float(no_data_value),
        metadata=[""],
    )


def read_xyz(path):
    """Read a regular-grid XYZ text file into a RasterData payload."""
    from dask_geomodeling_tpu_torch.raster.sources import RasterData

    with open(path) as stream:
        text = stream.read()
    for sep in (",", ";"):
        text = text.replace(sep, " ")
    rows = np.loadtxt(
        text.splitlines(), dtype=np.float64, comments="#", ndmin=2
    )
    if rows.shape[1] < 3:
        raise ValueError("%s: expected x y z columns" % path)
    xs, ys, zs = rows[:, 0], rows[:, 1], rows[:, 2]
    ux = np.unique(xs)
    uy = np.unique(ys)
    if len(ux) < 2 or len(uy) < 2:
        raise ValueError("%s: not a 2-D grid" % path)
    dx = float(np.min(np.diff(ux)))
    dy = float(np.min(np.diff(uy)))
    if dx <= 0 or dy <= 0:
        raise ValueError("%s: degenerate grid spacing" % path)
    width = int(round((ux[-1] - ux[0]) / dx)) + 1
    height = int(round((uy[-1] - uy[0]) / dy)) + 1

    integral = bool(np.all(zs == np.floor(zs)))
    if integral and np.all(np.abs(zs) < 2**31):
        dtype, no_data_value = np.int32, -(2**31)
    else:
        dtype, no_data_value = np.float32, float(np.finfo(np.float32).max)
    array = np.full((height, width), no_data_value, dtype)
    col = np.rint((xs - ux[0]) / dx).astype(np.int64)
    row = np.rint((uy[-1] - ys) / dy).astype(np.int64)  # north-up rows
    keep = (col >= 0) & (col < width) & (row >= 0) & (row < height)
    array[row[keep], col[keep]] = zs[keep].astype(dtype)

    geo_transform = (
        ux[0] - dx / 2,  # pixel centers at the sample points
        dx,
        0.0,
        uy[-1] + dy / 2,
        0.0,
        -dy,
    )
    return RasterData(
        array=array[None],
        projection=_sidecar_projection(path),
        geo_transform=geo_transform,
        no_data_value=float(no_data_value),
        metadata=[""],
    )
