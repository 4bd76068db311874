"""Clip, Mask, MaskBelow, Step, Classify, Reclassify, Rasterize and
RasterizeWKT: blocks, numpy processes and torch twins.

Counterparts of dask_geomodeling_tpu/raster/misc.py.  RasterizeWKT's twin
burns by crossing parity (ops/segment.py:rasterize_parity), bitwise to
the numpy scanline; Rasterize has no twin, as in the JAX package: it is a
host node, which the tile runtime runs per tile while planning and whose
results it stacks into the twins that take them.  The twins compare in
numpy's promoted dtypes (device.py:compare), so float64 thresholds stay
float64 on the card.  ``torch.searchsorted`` wants
the boundaries and the values in one dtype, so the twins cast both to
numpy's common type first, the type numpy's own searchsorted compares in:
float32 values against float bins compare in float64, int64 values
against int bins stay int64.
"""
from functools import lru_cache

import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import (
    as_operand,
    compare,
    data_mask,
    equal_scalar,
    numpy_dtype,
    torch_dtype,
)
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    GeoSeries,
    WKTReadingError,
    get_dtype_max,
    get_index,
    get_int_dtype,
    get_sr,
    get_uint_dtype,
    rasterize_geoseries,
    shapely_from_wkt,
    shapely_transform,
)
from dask_geomodeling_tpu_torch.geo.geometry import MultiPolygon, Point, Polygon, box
from dask_geomodeling_tpu_torch.ops.segment import centres, polygon_edges, rasterize_parity
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = [
    "Clip",
    "Mask",
    "MaskBelow",
    "Step",
    "Classify",
    "Reclassify",
    "Rasterize",
    "RasterizeWKT",
]

#: the features a Rasterize asks its source for, unless it sets a limit:
#: the JAX package's default ``geomodeling.geometry-limit``
GEOMETRY_LIMIT = 10000


def _data_cells(frame):
    """Boolean index of a frame's data-carrying cells (boolean frames:
    the True cells); numpy arrays and tensors alike."""
    values = frame["values"]
    if isinstance(values, torch.Tensor):
        if values.dtype == torch.bool:
            return values
        return compare("not_equal", values, frame["no_data_value"])
    if values.dtype == np.dtype("bool"):
        return values
    return values != frame["no_data_value"]


def _clip_process(data, source_data):
    """Keep store cells only where the clip source has data (or True).

    Pass-throughs first: empty stores, time/meta responses, and frames
    that are already all-nodata (nothing left to clip away)."""
    if data is None or "values" not in data:
        return data
    fill = data["no_data_value"]
    if not (data["values"] != fill).any():
        return data
    if source_data is None:
        return None
    clipped = data["values"].copy()
    clipped[~_data_cells(source_data)] = fill
    return {"values": clipped, "no_data_value": fill}


def _clip_torch(data, source_data):
    """Twin of ``_clip_process``, which it follows where the JAX twin does
    not: an all-nodata store comes back as it is even without a clip
    source.  Over a batch that test covers every tile at once."""
    if data is None or "values" not in data:
        return data
    fill = data["no_data_value"]
    values = data["values"]
    if source_data is None:
        has_data = bool(compare("not_equal", values, fill).any())
        return None if has_data else data
    clipped = torch.where(
        _data_cells(source_data),
        values,
        # boolean stores have no nodata sentinel; numpy casts None to False
        as_operand(False if fill is None else fill, numpy_dtype(values.dtype), values.device),
    )
    return {"values": clipped, "no_data_value": fill}


class Clip(BaseSingle):
    """Clip one raster ('store') to the data/True extent of another
    ('source'); inputs must share time resolution."""

    def __init__(self, store, source):
        expect_instance(source, RasterBlock, "source")
        if store.temporal and not source.temporal:
            raise ValueError(
                "The values raster is temporal while the clipping mask is "
                "not. Consider using Snap."
            )
        if not store.temporal and source.temporal:
            raise ValueError(
                "The clipping mask is temporal while the values raster is "
                "not. Consider using Snap."
            )
        if store.temporal and (store.timedelta != source.timedelta):
            raise ValueError(
                "Time resolution of the clipping mask does not match that "
                "of the values raster. Consider using Snap."
            )
        super().__init__(store, source)

    source = arg(1)

    def get_sources_and_requests(self, **request):
        # clamp start/stop into the common period so frames align
        period = self.period
        if period is None:
            return [(None, None), (None, None)]
        lo, hi = period

        def clamp(instant):
            return min(max(instant, lo), hi)

        start = request.get("start")
        if start is None:
            start = hi
        stop = request.get("stop")
        if stop is not None:
            if stop < lo or start > hi:
                return [(None, None), (None, None)]  # no overlap at all
            request["stop"] = clamp(stop)
        request["start"] = clamp(start)
        return [(source, request) for source in self.args]

    process = staticmethod(_clip_process)

    @property
    def extent(self):
        boxes = [s.extent for s in self.args]
        if any(b is None for b in boxes):
            return None
        # the clipped extent is the overlap of store and mask
        x1, y1 = (max(b[axis] for b in boxes) for axis in (0, 1))
        x2, y2 = (min(b[axis] for b in boxes) for axis in (2, 3))
        if x2 <= x1 or y2 <= y1:
            return None
        return x1, y1, x2, y2

    @property
    def footprint(self):
        result, mask = [x.footprint for x in self.args]
        if result is None or mask is None:
            return None
        return result.intersection(mask)

    @property
    def period(self):
        periods = [x.period for x in self.args]
        if any(period is None for period in periods):
            return None
        start = max(p[0] for p in periods)
        stop = min(p[1] for p in periods)
        if stop < start:
            return None
        return start, stop


def _mask_dtype_from_value(value):
    if isinstance(value, float):
        return np.dtype("float32")
    if value >= 0:
        return get_uint_dtype(value)
    return get_int_dtype(value)


def _mask_process(data, value):
    if data is None or "values" not in data:
        return data
    index = get_index(data["values"], data["no_data_value"])
    fillvalue = 1 if value == 0 else 0
    dtype = _mask_dtype_from_value(value)
    values = np.full_like(data["values"], fillvalue, dtype=dtype)
    values[index] = value
    return {"values": values, "no_data_value": fillvalue}


def _mask_torch(data, value):
    if data is None or "values" not in data:
        return data
    fillvalue = 1 if value == 0 else 0
    dtype = _mask_dtype_from_value(value)
    values = data["values"]
    values = torch.where(
        data_mask(values, data["no_data_value"]),
        as_operand(value, dtype, values.device),
        as_operand(fillvalue, dtype, values.device),
    )
    return {"values": values, "no_data_value": fillvalue}


class Mask(BaseSingle):
    """Replace data values with a constant; nodata is preserved."""

    def __init__(self, store, value):
        expect_instance(value, (float, int), "value")
        super().__init__(store, value)

    value = arg(1)

    @property
    def fillvalue(self):
        return 1 if self.value == 0 else 0

    @property
    def dtype(self):
        return _mask_dtype_from_value(self.value)

    process = staticmethod(_mask_process)


def _mask_below_process(data, value):
    if data is None or "values" not in data:
        return data
    values, no_data_value = data["values"].copy(), data["no_data_value"]
    values[values < value] = no_data_value
    return {"values": values, "no_data_value": no_data_value}


def _mask_below_torch(data, value):
    if data is None or "values" not in data:
        return data
    values, no_data_value = data["values"], data["no_data_value"]
    values = torch.where(
        compare("less", values, value),
        as_operand(no_data_value, numpy_dtype(values.dtype), values.device),
        values,
    )
    return {"values": values, "no_data_value": no_data_value}


class MaskBelow(BaseSingle):
    """Convert cells below a value to 'no data'."""

    def __init__(self, store, value):
        expect_instance(value, (float, int), "value")
        super().__init__(store, value)

    process = staticmethod(_mask_below_process)


def _step_process(data, left, right, location, at):
    """Three-way threshold as a where-ladder; nodata cells are re-stamped
    last so a sentinel that happens to compare against ``location`` cannot
    leak through."""
    if data is None or "values" not in data:
        return data
    values = data["values"]
    fill = data["no_data_value"]
    dtype = values.dtype
    out = np.where(values < location, dtype.type(left), values)
    out = np.where(values == location, dtype.type(at), out)
    out = np.where(values > location, dtype.type(right), out)
    out = np.where(values == fill, dtype.type(fill), out)
    return {"values": out, "no_data_value": fill}


def _step_torch(data, left, right, location, at):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    fill = data["no_data_value"]
    dtype = numpy_dtype(values.dtype)

    def constant(x):
        return as_operand(dtype.type(x), dtype, values.device)

    out = torch.where(compare("less", values, location), constant(left), values)
    out = torch.where(compare("equal", values, location), constant(at), out)
    out = torch.where(compare("greater", values, location), constant(right), out)
    out = torch.where(compare("equal", values, fill), constant(fill), out)
    return {"values": out, "no_data_value": fill}


class Step(BaseSingle):
    """Three-way step function: left if x < value, at if x == value, right
    if x > value."""

    def __init__(self, store, left=0, right=1, value=0, at=None):
        at = (left + right) / 2 if at is None else at
        for x in left, right, value, at:
            expect_instance(x, (float, int), "x")
        super().__init__(store, left, right, value, at)

    left = arg(1)
    right = arg(2)
    value = arg(3)
    at = arg(4)

    process = staticmethod(_step_process)


def _classify_process(data, bins, right):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    dtype = get_uint_dtype(len(bins) + 2)
    fillvalue = get_dtype_max(dtype)
    result_values = np.digitize(values, bins, right).astype(dtype)
    result_values[values == data["no_data_value"]] = fillvalue
    return {"values": result_values, "no_data_value": fillvalue}


class Classify(BaseSingle):
    """Classify values into bins given by increasing edges; the output is
    the bin index (0 = below the first edge)."""

    def __init__(self, store, bins, right=False):
        expect_instance(store, RasterBlock, "store")
        if not hasattr(bins, "__iter__"):
            raise TypeError(
                "bins must be an iterable of edges, got '%s'"
                % type(bins).__name__
            )
        edges = np.asarray(bins)
        for ok, message in (
            (edges.ndim == 1, "'bins' should be one-dimensional"),
            (np.issubdtype(edges.dtype, np.number), "'bins' should be numeric"),
        ):
            if not ok:
                raise TypeError(message)
        steps = np.diff(edges)
        if np.all(steps < 0) or not np.all(steps > 0):
            raise TypeError("'bins' should be monotonic")
        super().__init__(store, edges.tolist(), right)

    bins = arg(1)
    right = arg(2)

    @property
    def dtype(self):
        return get_uint_dtype(len(self.bins) + 2)

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)

    process = staticmethod(_classify_process)


def _reclassify_table(data):
    source, target = zip(*data)
    return np.asarray(source), np.asarray(target)


def _reclassify_lookup(process_kwargs, no_data_value):
    """Sorted (source, target) lookup arrays, with the store's nodata
    sentinel mapped onto the output fill; shared by process and twin."""
    source, target = _reclassify_table(process_kwargs["data"])
    if no_data_value is not None and no_data_value not in source:
        source = np.append(source, no_data_value)
        target = np.append(target, process_kwargs["fillvalue"])
    order = np.argsort(source)
    return source[order], target[order]


def _reclassify_process(store_data, process_kwargs):
    """Table lookup: searchsorted into the sorted source alphabet, then a
    hit test (a miss past either end lands on a non-equal slot).  Missed
    cells keep their value, or become the fill when ``select``."""
    if store_data is None or "values" not in store_data:
        return store_data
    values = store_data["values"]
    dtype = np.dtype(process_kwargs["dtype"])
    fill = process_kwargs["fillvalue"]
    source, target = _reclassify_lookup(
        process_kwargs, store_data["no_data_value"]
    )

    slots = np.minimum(np.searchsorted(source, values), len(source) - 1)
    hit = source[slots] == values
    base = (
        np.full(values.shape, fill, dtype)
        if process_kwargs["select"]
        else values.astype(dtype)
    )
    result = np.where(hit, target[slots].astype(dtype), base)
    return {"values": result, "no_data_value": fill}


class Reclassify(BaseSingle):
    """Reclassify integer/boolean rasters via [from, to] pairs; with
    ``select`` unmapped cells become nodata."""

    def __init__(self, store, data, select=False):
        dtype = store.dtype
        if dtype != bool and not np.issubdtype(dtype, np.integer):
            raise TypeError("The store must be of boolean or integer datatype")

        if not hasattr(data, "__iter__"):
            raise TypeError(
                "data must be an iterable of [from, to] pairs, got '%s'"
                % type(data).__name__
            )
        try:
            source, target = _reclassify_table(data)
        except ValueError:
            raise ValueError("Please supply a list of [from, to] values")
        if source.dtype != bool and not np.issubdtype(source.dtype, np.integer):
            raise TypeError(
                "Cannot reclassify from value with type '{}'".format(source.dtype)
            )
        if len(np.unique(source)) != len(source):
            raise ValueError("There are duplicates in the reclassify values")
        if not np.issubdtype(target.dtype, np.number):
            raise TypeError(
                "Cannot reclassify to value with type '{}'".format(target.dtype)
            )
        data = [list(x) for x in zip(source.tolist(), target.tolist())]

        if select is not True and select is not False:
            raise TypeError(
                "select must be a bool, got '%s'" % type(select).__name__
            )
        super().__init__(store, data, select)

    data = arg(1)
    select = arg(2)

    @property
    def dtype(self):
        _, target = _reclassify_table(self.data)
        return target.dtype

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)

    def get_sources_and_requests(self, **request):
        process_kwargs = {
            "dtype": self.dtype.str,
            "fillvalue": self.fillvalue,
            "data": self.data,
            "select": self.select,
        }
        return [(self.store, request), (process_kwargs, None)]

    process = staticmethod(_reclassify_process)


# --- torch twins ---


def _common(sorted_array, values):
    """(boundaries tensor, values tensor) in numpy's common dtype."""
    common = np.result_type(sorted_array.dtype, numpy_dtype(values.dtype))
    boundaries = torch.from_numpy(sorted_array.astype(common)).to(values.device)
    return boundaries, values.to(torch_dtype(common)).contiguous()


def _classify_torch(data, bins, right):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    dtype = get_uint_dtype(len(bins) + 2)
    fillvalue = get_dtype_max(dtype)
    edges, keys = _common(np.asarray(bins), values)
    # np.digitize(x, bins, right=False) is searchsorted(bins, x, side="right")
    index = torch.searchsorted(edges, keys, right=not right)
    index = torch.where(equal_scalar(values, data["no_data_value"]), fillvalue, index)
    return {"values": index.to(torch_dtype(dtype)), "no_data_value": fillvalue}


def _reclassify_torch(store_data, process_kwargs):
    if store_data is None or "values" not in store_data:
        return store_data
    values = store_data["values"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = process_kwargs["fillvalue"]
    source, target = _reclassify_lookup(process_kwargs, store_data["no_data_value"])
    source_t, keys = _common(source, values)
    target_t = torch.from_numpy(target.astype(dtype)).to(values.device)

    slots = torch.clamp(torch.searchsorted(source_t, keys), max=len(source) - 1)
    hit = source_t[slots] == keys
    if process_kwargs["select"]:
        base = torch.full(values.shape, fillvalue, dtype=torch_dtype(dtype), device=values.device)
    else:
        base = values.to(torch_dtype(dtype))
    return {"values": torch.where(hit, target_t[slots], base), "no_data_value": fillvalue}


register(_clip_process, _clip_torch)
register(_mask_process, _mask_torch)
register(_mask_below_process, _mask_below_torch)
register(_step_process, _step_torch)
register(_classify_process, _classify_torch)
register(_reclassify_process, _reclassify_torch)


class _GeometryRaster(RasterBlock):
    """Base for rasters burned from vector data: static in time, with no
    intrinsic grid, projection, or extent of their own."""

    @property
    def period(self):
        return (self.DEFAULT_ORIGIN,) * 2

    extent = None
    timedelta = None
    temporal = False
    footprint = None
    projection = None
    geo_transform = None

    @staticmethod
    def _static_answer(mode, instant):
        """The time/meta response of a single static frame."""
        if mode == "time":
            return {"time": [instant]}
        return {"meta": [None]}


class Rasterize(_GeometryRaster):
    """Rasterize a GeometryBlock, burning values from ``column_name`` (or a
    boolean presence raster when no column is given)."""

    def __init__(self, source, column_name=None, dtype=None, limit=None):
        from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock

        expect_instance(source, GeometryBlock, "source")
        if column_name is not None:
            expect_instance(column_name, str, "column_name")
        if dtype is None:
            dtype = "bool" if column_name is None else "int32"
        else:
            dtype = str(np.dtype(dtype))
        if limit:
            expect_instance(limit, int, "limit")
        if limit and limit < 1:
            raise ValueError("Limit should be greater than 1")
        super().__init__(source, column_name, dtype, limit)

    source = arg(0)
    column_name = arg(1)
    limit = arg(3)

    @property
    def dtype(self):
        return np.dtype(self.args[2])

    @property
    def fillvalue(self):
        return None if self.dtype == bool else get_dtype_max(self.dtype)

    @staticmethod
    def _cell_floor(bbox, width, height):
        """The smallest cell edge of the target grid; None for points."""
        x1, y1, x2, y2 = bbox
        if x2 == x1 and y2 == y1:
            return None
        if not (x1 < x2 and y1 < y2):
            raise ValueError("Invalid bbox ({})".format(bbox))
        return min((x2 - x1) / width, (y2 - y1) / height)

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        if mode in ("time", "meta"):
            instant = self.period[-1] if mode == "time" else None
            return [(instant, None), ({"mode": mode}, None)]
        if mode != "vals":
            raise ValueError("Unknown mode '{}'".format(mode))

        width, height = request["width"], request["height"]
        geom_request = {
            "mode": "intersects",
            "geometry": box(*request["bbox"]),
            "projection": request["projection"],
            "min_size": self._cell_floor(request["bbox"], width, height),
            "limit": self.limit if self.limit is not None else GEOMETRY_LIMIT,
            "start": request.get("start"),
            "stop": request.get("stop"),
        }
        burn_kwargs = {
            "mode": "vals",
            "column_name": self.column_name,
            "dtype": self.dtype,
            "no_data_value": self.fillvalue,
            "width": width,
            "height": height,
            "bbox": request["bbox"],
        }
        return [(self.source, geom_request), (burn_kwargs, None)]

    @staticmethod
    def _burn_values(features, column_name):
        """The per-feature burn values, None (presence mask), or False
        (missing column)."""
        if column_name is None:
            return None
        if column_name in features:
            return features[column_name]
        if features.index.name == column_name:
            return features.index.to_series()
        return False

    @staticmethod
    def process(data, burn_kwargs):
        mode = burn_kwargs["mode"]
        if mode in ("time", "meta"):
            return _GeometryRaster._static_answer(mode, data)

        dtype = burn_kwargs["dtype"]
        fill = burn_kwargs["no_data_value"]
        shape = (1, burn_kwargs["height"], burn_kwargs["width"])
        features = data["features"]
        burn = Rasterize._burn_values(features, burn_kwargs["column_name"])
        if len(features) == 0 or burn is False:
            return {
                "values": np.full(shape, fill, dtype=dtype),
                "no_data_value": fill,
            }

        burned = rasterize_geoseries(
            geoseries=features["geometry"] if "geometry" in features else None,
            values=burn,
            bbox=burn_kwargs["bbox"],
            projection=data["projection"],
            height=shape[1],
            width=shape[2],
        )
        raw = burned["values"]
        with np.errstate(over="ignore", under="ignore"):
            values = raw.astype(dtype)
        if burned["no_data_value"] != fill:
            values[raw == burned["no_data_value"]] = fill
        return {"values": values, "no_data_value": fill}


class RasterizeWKT(_GeometryRaster):
    """Rasterize a single WKT geometry into a boolean mask."""

    def __init__(self, wkt, projection):
        expect_instance(wkt, str, "wkt")
        expect_instance(projection, str, "projection")
        try:
            shapely_from_wkt(wkt)
        except WKTReadingError:
            raise ValueError("The provided geometry is not a valid WKT")
        try:
            get_sr(projection)
        except (TypeError, ValueError):
            raise ValueError("The provided projection is not valid")
        super().__init__(wkt, projection)

    wkt = arg(0)
    projection = arg(1)
    dtype = np.dtype("bool")
    fillvalue = None

    @property
    def extent(self):
        return tuple(
            shapely_transform(shapely_from_wkt(self.wkt), self.projection, "EPSG:4326").bounds
        )

    @property
    def geometry(self):
        geom = shapely_from_wkt(self.wkt)
        geom.srs = self.projection
        return geom

    @property
    def footprint(self):
        """The geometry's box, as the port's footprints are."""
        return Extent(shapely_from_wkt(self.wkt).bounds, self.projection)

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        if mode not in ("time", "meta", "vals"):
            raise ValueError("Unknown mode '{}'".format(mode))
        if mode == "vals":
            data = {"wkt": self.wkt, "projection": self.projection}
        else:
            data = self.period[-1] if mode == "time" else None
        return [(data, None), (request, None)]

    @staticmethod
    def process(data, request):
        mode = request["mode"]
        if mode in ("time", "meta"):
            return _GeometryRaster._static_answer(mode, data)

        geometry = shapely_from_wkt(data["wkt"])
        if data["projection"] != request["projection"]:
            geometry = shapely_transform(geometry, data["projection"], request["projection"])

        x1, y1, x2, y2 = request["bbox"]
        probe = Point(x1, y1) if (x1 == x2 and y1 == y2) else box(x1, y1, x2, y2)
        if not geometry.intersects(probe):
            empty = np.full((1, request["height"], request["width"]), False, dtype=bool)
            return {"values": empty, "no_data_value": None}

        return rasterize_geoseries(
            geoseries=GeoSeries([geometry]) if not geometry.is_empty else None,
            bbox=request["bbox"],
            projection=request["projection"],
            height=request["height"],
            width=request["width"],
        )


@lru_cache(maxsize=16)
def _wkt_geometry(wkt, src, dst):
    """The geometry of a WKT in ``dst``, parsed and transformed once."""
    geometry = shapely_from_wkt(wkt)
    return geometry if src == dst else shapely_transform(geometry, src, dst)


def _rasterize_wkt_capable(data, request):
    """Polygons and multipolygons over an area; a point request, another
    geometry type or an empty one runs the numpy process on the host."""
    if not isinstance(request, dict) or request.get("mode") != "vals":
        return False
    x1, y1, x2, y2 = request["bbox"]
    if x1 == x2 or y1 == y2:
        return False  # a point request
    geometry = _wkt_geometry(data["wkt"], data["projection"], data["projection"])
    return not geometry.is_empty and isinstance(geometry, (Polygon, MultiPolygon))


def _rasterize_wkt_torch(data, request):
    """RasterizeWKT's twin over B tiles: the host scanline's pixel centres
    (``p + a * (i + 0.5)`` of GeoTransform.from_bbox) per tile from the
    (B, 4) float64 bbox, and the parity of the crossings strictly right of
    each centre (ops/segment.py:rasterize_parity)."""
    bbox = request["bbox"]
    device = bbox.device
    width, height = request["width"], request["height"]
    geometry = _wkt_geometry(data["wkt"], data["projection"], request["projection"])
    starts, ends, _ = polygon_edges([geometry])
    x1, y1, x2, y2 = bbox.unbind(1)
    x_centres = centres(x1, (x2 - x1) / width, width, device)  # (B, w)
    y_centres = centres(y2, (y1 - y2) / height, height, device)  # (B, h)
    inside = rasterize_parity(
        torch.as_tensor(starts, device=device),
        torch.as_tensor(ends, device=device),
        y_centres.reshape(-1),
        x_centres.repeat_interleave(height, dim=0),
    )
    return {"values": inside.view(len(bbox), 1, height, width), "no_data_value": None}


RasterizeWKT.process.torch_dynamic = {"bbox"}
register(RasterizeWKT.process, _rasterize_wkt_torch, capable=_rasterize_wkt_capable)
