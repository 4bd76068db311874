"""Rasterization: burn geometries into pixel grids.

Counterpart of dask_geomodeling_tpu/geo/rasterize.py; the frame is the
port's own (geo/features.py), so no pandas.  Convention matches GDAL's
default: a pixel is burned when its *center* is inside the polygon
(even-odd rule over all rings); later features overwrite earlier ones.
Lines burn the cells their path crosses; points burn the cell containing
them.

Polygonal features burn natively (``_burn_native``: native/rasterize.cpp,
built with g++ at first use), as the JAX package's do whenever its library
is built, so the port answers as the JAX numpy executor.  The numpy
scanline (``_burn_polygon_rows``, vectorized per row) burns a call whose
features include a line or a point, and is the plain version the native
burn is held to.  The two place a crossing against the pixel centres
differently (``ceil((x - x0) / a - 0.5)`` against ``searchsorted`` of the
centres), which parts them only where a crossing lies within float64
rounding of a pixel centre (ROADMAP Queue 3).  The device counterparts (RasterizeWKT's
twin in raster/misc.py, the zonal label planes in ops/segment.py) compute
the numpy scanline's crossings in the same float64 order of operations.
"""
import numpy as np

from dask_geomodeling_tpu_torch.geo.dtypes import get_dtype_max
from dask_geomodeling_tpu_torch.geo.geometry import (
    LineString,
    MultiLineString,
    MultiPoint,
    Point,
    _linework,
    _polygonize,
)
from dask_geomodeling_tpu_torch.geo.features import Series
from dask_geomodeling_tpu_torch.geo.geotransform import GeoTransform

__all__ = ["rasterize_geoseries", "burn_mask", "burn_values"]


def _burn_polygon_rows(mask_row_setter, rings, gt, height, width):
    """Scanline fill: set pixels whose center is inside the rings."""
    p, a, _, q, _, d = gt
    # pixel center coordinates
    y_centers = q + d * (np.arange(height) + 0.5)
    x_centers = p + a * (np.arange(width) + 0.5)

    # collect all edges from all rings
    starts = np.concatenate([r[:-1] for r in rings], axis=0)
    ends = np.concatenate([r[1:] for r in rings], axis=0)
    y1, y2 = starts[:, 1], ends[:, 1]
    x1, x2 = starts[:, 0], ends[:, 0]

    ymin, ymax = min(y1.min(), y2.min()), max(y1.max(), y2.max())

    for row in range(height):
        yc = y_centers[row]
        if yc < ymin or yc > ymax:
            continue
        crosses = (y1 > yc) != (y2 > yc)
        if not crosses.any():
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            xs = x1[crosses] + (yc - y1[crosses]) * (x2[crosses] - x1[crosses]) / (
                y2[crosses] - y1[crosses]
            )
        xs.sort()
        # fill between crossing pairs
        cols_lo = np.searchsorted(x_centers, xs[0::2])
        cols_hi = np.searchsorted(x_centers, xs[1::2])
        for lo, hi in zip(cols_lo, cols_hi):
            if hi > lo:
                mask_row_setter(row, lo, hi)


def _burn_line(mask, coords, gt, height, width):
    """Burn cells crossed by a linestring path (dense sampling)."""
    p, a, _, q, _, d = gt
    for i in range(len(coords) - 1):
        (xa, ya), (xb, yb) = coords[i], coords[i + 1]
        n = int(max(abs(xb - xa) / abs(a), abs(yb - ya) / abs(d)) * 2) + 2
        t = np.linspace(0.0, 1.0, n)
        xs = xa + (xb - xa) * t
        ys = ya + (yb - ya) * t
        cols = np.floor((xs - p) / a).astype(int)
        rows = np.floor((ys - q) / d).astype(int)
        ok = (cols >= 0) & (cols < width) & (rows >= 0) & (rows < height)
        mask[rows[ok], cols[ok]] = True


def _flatten_polygons(geometries):
    """Flatten polygonal geometries for the native rasterizer; None if any
    geometry is non-polygonal (the numpy path handles those)."""
    coords = []
    ring_sizes = []
    ring_counts = []
    for geom in geometries:
        if geom is None or geom.is_empty:
            ring_counts.append(0)
            continue
        polys = _polygonize(geom)
        if not polys:
            return None
        rings = [r for poly in polys for r in poly._rings()]
        ring_counts.append(len(rings))
        for ring in rings:
            ring_sizes.append(len(ring))
            coords.append(np.asarray(ring, dtype=np.float64).ravel())
    if not coords:
        return None
    return np.concatenate(coords), ring_sizes, ring_counts


def _burn_native(geometries, burn, out, gt):
    """Burn with the native scanline rasterizer; False if not applicable
    (a non-polygonal feature, or no feature with rings)."""
    from dask_geomodeling_tpu_torch.native import rasterize_native

    flat = _flatten_polygons(geometries)
    if flat is None:
        return False
    coords, ring_sizes, ring_counts = flat
    return rasterize_native(coords, ring_sizes, ring_counts, burn, out, gt)


def burn_mask(geometries, gt, height, width):
    """Boolean (height, width) mask of cells covered by the geometries."""
    mask = np.zeros((height, width), dtype=bool)
    geometries = list(geometries)
    out8 = np.zeros((height, width), dtype=np.uint8)
    if _burn_native(geometries, np.ones(len(geometries), np.uint8), out8, gt):
        return out8.astype(bool)
    for geom in geometries:
        if geom is None or geom.is_empty:
            continue
        polys = _polygonize(geom)
        if polys:
            rings = [r for poly in polys for r in poly._rings()]

            def setter(row, lo, hi):
                mask[row, lo:hi] = True

            _burn_polygon_rows(setter, rings, gt, height, width)
        elif isinstance(geom, (LineString, MultiLineString)):
            for coords in _linework(geom):
                _burn_line(mask, coords, gt, height, width)
        elif isinstance(geom, (Point, MultiPoint)):
            p, a, _, q, _, d = gt
            for px, py in [(g.x, g.y) for g in getattr(geom, "geoms", [geom])]:
                col = int(np.floor((px - p) / a))
                row = int(np.floor((py - q) / d))
                if 0 <= row < height and 0 <= col < width:
                    mask[row, col] = True
    return mask


def burn_values(geometries, burn, out, gt):
    """Burn per-geometry values into ``out`` (later features overwrite)."""
    height, width = out.shape
    geometries = list(geometries)
    if _burn_native(geometries, np.asarray(burn, dtype=out.dtype), out, gt):
        return out
    for geom, value in zip(geometries, burn):
        if geom is None or geom.is_empty:
            continue
        polys = _polygonize(geom)
        if polys:
            rings = [r for poly in polys for r in poly._rings()]

            def setter(row, lo, hi, _v=value):
                out[row, lo:hi] = _v

            _burn_polygon_rows(setter, rings, gt, height, width)
        else:
            mask = burn_mask([geom], gt, height, width)
            out[mask] = value
    return out


def _finalize(array, no_data_value):
    if array.dtype == np.uint8:  # our boolean carrier
        return {"values": array.astype(bool), "no_data_value": None}
    return {"values": array, "no_data_value": no_data_value}


def rasterize_geoseries(geoseries, bbox, projection, height, width, values=None):
    """Burn a GeoSeries into a (1, height, width) raster.

    Same contract as the reference (utils.py:638-756): ``values`` None or
    boolean yields a boolean raster; float values burn as float64 (nodata =
    dtype max, non-finite filtered); int values burn as int32.  Point
    requests (zero-area bbox) sample the intersecting feature.
    """
    if values is not None and str(values.dtype) == "category":
        values = Series(np.asarray(values), index=values.index)

    if values is None or values.dtype == bool:
        dtype = np.uint8
        no_data_value = 0
        if values is not None and geoseries is not None:
            geoseries = geoseries[values]  # boolean mask selects features
            values = None
    elif np.issubdtype(values.dtype, np.floating):
        dtype = np.float64
        no_data_value = get_dtype_max(dtype)
        if geoseries is not None:
            finite = np.isfinite(values)
            geoseries = geoseries[finite]
            values = values[finite]
    elif np.issubdtype(values.dtype, np.integer):
        dtype = np.int32
        no_data_value = get_dtype_max(dtype)
    else:
        raise TypeError(
            "Unsupported values dtype to rasterize: '{}'".format(values.dtype)
        )

    array = np.full((1, height, width), no_data_value, dtype=dtype)

    if geoseries is None or len(geoseries) == 0:
        return _finalize(array, no_data_value)

    # drop empty geometries
    mask = np.array([not (g is None or g.is_empty) for g in geoseries], dtype=bool)
    geoseries = geoseries[mask]
    if values is not None:
        values = values[mask]

    x1, y1, x2, y2 = bbox
    if not ((x2 == x1 and y2 == y1) or (x1 < x2 and y1 < y2)):
        raise ValueError("Invalid bbox ({})".format(bbox))

    # point request: sample the last intersecting feature
    if x2 == x1 and y2 == y1:
        point = Point(x1, y1)
        hits = [i for i, g in enumerate(geoseries) if g.intersects(point)]
        if not hits:
            pass
        elif values is not None:
            array[:] = values.iloc[hits[-1]]
        else:
            array[:] = 1
        return _finalize(array, no_data_value)

    gt = GeoTransform.from_bbox(bbox, height, width)
    if values is None:
        burned = burn_mask(list(geoseries), gt, height, width)
        array[0][burned] = 1
    else:
        burn_values(list(geoseries), list(values), array[0], gt)
    return _finalize(array, no_data_value)
