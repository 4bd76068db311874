"""Dilate, Smooth, MovingMax, HillShade and Place: blocks, numpy
processes, torch twins.

Counterparts of dask_geomodeling_tpu/raster/spatial.py.  A stencil grows
its source request by its halo (``expand_request_pixels`` /
``expand_request_meters``), computes on the over-fetched array and crops
the margin off.  The twins run batch-first on (B, bands, h, w): the
Gaussian and the moving maximum are one kernel launch over all B x bands
planes of a batch (ops/cuda_stencils.py); the dilation, HillShade and
Place are plain torch, as the JAX package has no Pallas kernel for them.
"""
import math

import numpy as np
import torch
from scipy import ndimage

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import (
    as_operand,
    data_mask,
    equal_scalar,
    numpy_dtype,
)
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    get_dtype_min,
    get_footprint,
    get_index,
    get_sr,
    transform_points,
)
from dask_geomodeling_tpu_torch.ops.cuda_stencils import gaussian_blur, moving_max
from dask_geomodeling_tpu_torch.ops.stencils import binary_dilation, blur_dtype
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.raster.reduction import (
    check_statistic,
    reduce_rasters,
    reduce_rasters_torch,
)
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["Dilate", "Smooth", "MovingMax", "HillShade", "Place"]


def expand_request_pixels(request, radius=1):
    """A copy of a vals request grown by ``radius`` pixels on every side.

    Returns None for non-vals requests and for degenerate (point) bboxes,
    which have no pixel size to grow by.
    """
    if request["mode"] != "vals":
        return None
    x1, y1, x2, y2 = request["bbox"]
    if x2 == x1 or y2 == y1:
        return None
    dx = (x2 - x1) / request["width"] * radius
    dy = (y2 - y1) / request["height"] * radius
    grown = dict(request)
    grown["bbox"] = (x1 - dx, y1 - dy, x2 + dx, y2 + dy)
    grown["width"] = request["width"] + 2 * radius
    grown["height"] = request["height"] + 2 * radius
    return grown


def expand_request_meters(request, radius_m=1):
    """A copy of a vals request grown by ``radius_m`` meters on every side,
    snapped outward to a whole number of pixels.

    Returns ``(grown_request, radius_px)`` with ``radius_px`` the unsnapped
    (y, x) radius expressed in pixels.
    """
    sr = get_sr(request["projection"])
    geographic = sr.IsGeographic()
    bbox = request["bbox"]
    if geographic:
        # grow in the web-mercator frame so "meters" means meters
        bbox = Extent(bbox, request["projection"]).transformed("EPSG:3857").bbox
    x1, y1, x2, y2 = bbox

    span_y, span_x = y2 - y1, x2 - x1
    if span_y > 0 and span_x > 0:
        # pixel density (px per meter) along each axis
        density = (request["height"] / span_y, request["width"] / span_x)
        radius_px = [radius_m * d for d in density]
        snap_px = [int(round(r)) for r in radius_px]
        snap_m = [px / d for px, d in zip(snap_px, density)]
    else:
        radius_px = snap_px = [Smooth.MARGIN_THRESHOLD] * 2
        snap_m = [radius_m] * 2

    grown = dict(request)
    grown["bbox"] = (x1 - snap_m[1], y1 - snap_m[0], x2 + snap_m[1], y2 + snap_m[0])
    if geographic:
        grown["bbox"] = (
            Extent(grown["bbox"], "EPSG:3857")
            .transformed(request["projection"])
            .bbox
        )
    grown["height"] = request["height"] + 2 * snap_px[0]
    grown["width"] = request["width"] + 2 * snap_px[1]
    return grown, radius_px


# --- Dilate ---


def _dilate_process(data, values=None):
    if data is None or values is None or "values" not in data:
        return data
    original = data["values"]
    dilated = original.copy()
    for value in np.asarray(values, dtype=original.dtype):
        dilated[ndimage.binary_dilation(original == value)] = value
    dilated = dilated[:, 1:-1, 1:-1]
    return {"values": dilated, "no_data_value": data["no_data_value"]}


def _dilate_torch(data, values=None):
    """Batch-first twin of ``_dilate_process``: each value's cells grow by
    the rank-3 cross of scipy's default structure, across the bands too
    (ops/stencils.py:binary_dilation), later values over earlier ones."""
    if data is None or values is None or "values" not in data:
        return data
    original = data["values"]
    dtype = numpy_dtype(original.dtype)
    dilated = original
    for value in np.asarray(values, dtype=dtype):
        grown = binary_dilation(equal_scalar(original, value))
        dilated = torch.where(grown, as_operand(value, dtype, original.device), dilated)
    dilated = dilated[..., 1:-1, 1:-1]
    return {"values": dilated, "no_data_value": data["no_data_value"]}


class Dilate(BaseSingle):
    """Dilate cells with the given values by one cell in each (non-diagonal)
    direction, in the order of the values list."""

    def __init__(self, store, values):
        values = np.asarray(values, dtype=store.dtype)
        super().__init__(store, values.tolist())

    values = arg(1)

    def get_sources_and_requests(self, **request):
        new_request = expand_request_pixels(request, radius=1)
        if new_request is None:
            return [(self.store, request)]
        return [(self.store, new_request), (self.values, None)]

    process = staticmethod(_dilate_process)


register(_dilate_process, _dilate_torch)


# --- MovingMax ---


def _crop_margin(values, radius):
    """Drop the halo pixels the request expansion added (the leading axes
    stay whole); shared by the process and its twin."""
    return values[..., radius:-radius, radius:-radius]


def _moving_max_process(data, size=None):
    """Circular-footprint max filter.  Nodata cells participate as the
    dtype minimum so any real neighbour wins; a cell stays nodata only
    where it was nodata and no data reached it."""
    if data is None or size is None or "values" not in data:
        return data
    values = data["values"]
    fill = data["no_data_value"]
    floor = values.dtype.type(get_dtype_min(values.dtype))
    gaps = values == fill

    peaks = ndimage.maximum_filter(
        np.where(gaps, floor, values), footprint=get_footprint(size)[None]
    )
    unreached = gaps & (peaks == floor)
    if unreached.any():
        peaks[unreached] = fill
    return {
        "values": _crop_margin(peaks, int(size // 2)),
        "no_data_value": fill,
    }


class MovingMax(BaseSingle):
    """Circular-footprint spatial maximum filter (for sparse-data display)."""

    def __init__(self, store, size):
        size = int(2 * round((size - 1) / 2) + 1)
        if size < 3:
            raise ValueError("The size should be odd and larger than 1")
        super().__init__(store, size)

    size = arg(1)

    def get_sources_and_requests(self, **request):
        size = self.size
        new_request = expand_request_pixels(request, radius=int(size // 2))
        if new_request is None:
            return [(self.store, request)]
        return [(self.store, new_request), (size, None)]

    process = staticmethod(_moving_max_process)


def _moving_max_torch(data, size=None):
    """Batch-first twin of ``_moving_max_process`` (the JAX package's
    ``_moving_max_jax``): nodata becomes the dtype minimum, then one
    kernel launch over all B x bands planes, then cells that were nodata
    and still hold the minimum become nodata, then the margin goes."""
    if data is None or size is None or "values" not in data:
        return data
    values = data["values"]
    n_batch, bands, height, width = values.shape
    no_data_value = data["no_data_value"]
    minimum = numpy_dtype(values.dtype).type(get_dtype_min(numpy_dtype(values.dtype)))
    no_data_mask = equal_scalar(values, no_data_value)
    planes = torch.where(no_data_mask, minimum.item(), values)
    filtered = moving_max(
        planes.reshape(n_batch * bands, height, width).contiguous(), size
    ).reshape(values.shape)
    unreached = (filtered == minimum.item()) & no_data_mask
    filtered = torch.where(
        unreached,
        numpy_dtype(values.dtype).type(no_data_value).item(),
        filtered,
    )
    return {
        "values": _crop_margin(filtered, int(size // 2)),
        "no_data_value": no_data_value,
    }


register(_moving_max_process, _moving_max_torch)


# --- Smooth ---


def _smooth_process(data, process_kwargs=None):
    """Gaussian blur with sigma = size/3 per axis, nodata cells first
    replaced by the constant ``fill``.  "exact" mode crops the expanded
    margin afterwards; "zoom" mode resamples the blurred array back onto
    the request grid (order-0)."""
    if data is None or process_kwargs is None:
        return data
    size_y, size_x = process_kwargs["size"]
    fill = process_kwargs["fill"]
    frame = data["values"]
    blurred = np.where(
        frame == data["no_data_value"], frame.dtype.type(fill), frame
    )
    ndimage.gaussian_filter(
        blurred,
        (0, size_y / 3, size_x / 3),
        output=blurred,
        mode="constant",
        cval=fill,
    )

    if process_kwargs["smooth_mode"] == "exact":
        my, mx = int(round(size_y)), int(round(size_x))
        blurred = blurred[
            :, my : blurred.shape[1] - my, mx : blurred.shape[2] - mx
        ]
    else:
        _, ny, nx = blurred.shape
        blurred = ndimage.affine_transform(
            blurred,
            order=0,
            matrix=np.diag([1, 1 - 2 * size_y / ny, 1 - 2 * size_x / nx]),
            offset=[0, size_y, size_x],
        )

    return {"values": blurred, "no_data_value": data["no_data_value"]}


class Smooth(BaseSingle):
    """Gaussian smoothing with an extent given in meters (sigma = size/3).

    Above MARGIN_THRESHOLD pixels of margin the computation switches to a
    zoomed (downsampled) mode.
    """

    MARGIN_THRESHOLD = 6

    def __init__(self, store, size, fill=0):
        for x in (size, fill):
            expect_instance(x, (int, float), "x")
        super().__init__(store, size, fill)

    size = arg(1)
    fill = arg(2)

    def get_sources_and_requests(self, **request):
        if request["mode"] != "vals":
            return [(self.store, request)]

        grown, size = expand_request_meters(request, self.size)

        zoomed = any(s > self.MARGIN_THRESHOLD for s in size)
        if zoomed:
            # big margins: fetch downsampled at the request's own pixel
            # count; sigma shrinks by the per-axis zoom factor
            for px, axis in enumerate(("height", "width")):
                size[px] *= request[axis] / grown[axis]
                grown[axis] = request[axis]

        plan = {
            "smooth_mode": "zoom" if zoomed else "exact",
            "fill": self.fill,
            "size": size,
        }
        return [(self.store, grown), (plan, None)]

    process = staticmethod(_smooth_process)


def _smooth_torch(data, process_kwargs=None):
    """Batch-first twin of ``_smooth_process`` (the JAX package's
    ``_smooth_jax``): nodata becomes ``fill``, then the Gaussian (one
    kernel launch over all B x bands planes of a batch), the cast back to
    the frame's dtype, then the exact crop or the order-0 zoom back onto
    the request grid.  ``size`` is the batch's first tile's."""
    if data is None or process_kwargs is None:
        return data
    size_y, size_x = process_kwargs["size"]
    fill = process_kwargs["fill"]
    no_data_value = data["no_data_value"]
    values = data["values"]
    dtype = values.dtype
    n_batch, bands, height, width = values.shape

    values = torch.where(
        equal_scalar(values, no_data_value),
        numpy_dtype(dtype).type(fill).item(),
        values,
    )
    planes = values.to(blur_dtype(dtype)).reshape(n_batch * bands, height, width)
    blurred = gaussian_blur(planes.contiguous(), size_y / 3, size_x / 3, fill)
    blurred = blurred.to(dtype).reshape(n_batch, bands, height, width)

    if process_kwargs["smooth_mode"] == "exact":
        my, mx = int(round(size_y)), int(round(size_x))
        blurred = blurred[:, :, my : height - my, mx : width - mx]
    else:
        # nearest-neighbour zoom back to the original shape (order 0),
        # ndimage.affine_transform's floor(c + 0.5) with c = i * zoom + size
        device = values.device
        zy, zx = 1 - 2 * size_y / height, 1 - 2 * size_x / width
        rows = torch.arange(height, dtype=torch.float64, device=device) * zy
        cols = torch.arange(width, dtype=torch.float64, device=device) * zx
        rows = torch.clamp((rows + size_y + 0.5).long(), 0, height - 1)
        cols = torch.clamp((cols + size_x + 0.5).long(), 0, width - 1)
        blurred = blurred[:, :, rows][:, :, :, cols]
    return {"values": blurred, "no_data_value": no_data_value}


register(_smooth_process, _smooth_torch)


# --- HillShade ---


def _hillshade_math(array, resolution, altitude, azimuth, xp):
    """Shared hillshade math (GDAL-dem style 3x3 gradient + illumination)
    over the last two axes; ``xp`` is numpy or torch."""
    xres, yres = resolution
    alt = math.radians(altitude)
    az = math.radians(azimuth)
    zsf = 1.0 / 8.0
    square_zsf = zsf * zsf

    a = array
    s0 = a[..., :-2, :-2]
    s1 = a[..., :-2, 1:-1]
    s2 = a[..., :-2, 2:]
    s3 = a[..., 1:-1, :-2]
    s5 = a[..., 1:-1, 2:]
    s6 = a[..., 2:, :-2]
    s7 = a[..., 2:, 1:-1]
    s8 = a[..., 2:, 2:]

    y = (s0 + 2 * s1 + s2 - s6 - 2 * s7 - s8) / yres
    x = (s0 + 2 * s3 + s6 - s2 - 2 * s5 - s8) / xres

    xx_plus_yy = x * x + y * y
    aspect = xp.arctan2(y, x)
    cang = (
        math.sin(alt)
        - math.cos(alt) * zsf * xp.sqrt(xx_plus_yy) * xp.sin(aspect - az)
    ) / xp.sqrt(1 + square_zsf * xx_plus_yy)
    return cang


def _hillshade_process(data, process_kwargs=None):
    if process_kwargs is None:
        return data

    array = data["values"].copy().astype("f4")
    array[data["values"] == data["no_data_value"]] = process_kwargs["fill"]

    with np.errstate(all="ignore"):
        cang = _hillshade_math(
            array,
            process_kwargs["resolution"],
            process_kwargs["altitude"],
            process_kwargs["azimuth"],
            np,
        )
    result = np.where(cang <= 0, 0, 255 * cang).astype("u1")
    return {"values": result, "no_data_value": 256}


class HillShade(BaseSingle):
    """GDAL-dem style hillshade; uint8 output with fillvalue 256."""

    def __init__(self, store, altitude=45, azimuth=315, fill=0):
        for x in (altitude, azimuth, fill):
            expect_instance(x, (int, float), "x")
        super().__init__(store, float(altitude), float(azimuth), fill)

    altitude = arg(1)
    azimuth = arg(2)
    fill = arg(3)

    @property
    def dtype(self):
        return np.dtype("u1")

    @property
    def fillvalue(self):
        return 256  # intentionally not representable in uint8

    process = staticmethod(_hillshade_process)

    def get_sources_and_requests(self, **request):
        grown = expand_request_pixels(request, radius=1)
        if grown is None:
            return [(self.store, request)]

        x1, y1, x2, y2 = request["bbox"]
        plan = {
            "resolution": (
                (x2 - x1) / request["width"],
                (y2 - y1) / request["height"],
            ),
            "altitude": self.altitude,
            "azimuth": self.azimuth,
            "fill": self.fill,
        }
        return [(self.store, grown), (plan, None)]


def _hillshade_torch(data, process_kwargs=None):
    """Batch-first twin of ``_hillshade_process``: float32 with nodata
    replaced by ``fill``, uint8 out with no_data_value 256.  ``resolution``
    is the batch's first tile's."""
    if process_kwargs is None:
        return data
    values = data["values"]
    array = torch.where(
        equal_scalar(values, data["no_data_value"]),
        torch.tensor(process_kwargs["fill"], dtype=torch.float32, device=values.device),
        values.to(torch.float32),
    )
    cang = _hillshade_math(
        array,
        process_kwargs["resolution"],
        process_kwargs["altitude"],
        process_kwargs["azimuth"],
        torch,
    )
    result = torch.where(cang <= 0, 0.0, 255 * cang).to(torch.uint8)
    return {"values": result, "no_data_value": 256}


register(_hillshade_process, _hillshade_torch)


# --- Place ---


def _transform_point(point, src_srs, dst_srs):
    """A point in ``dst_srs``; the same string passes it through as is."""
    x, y = point
    if src_srs.upper() == dst_srs.upper():
        return (float(x), float(y))
    (tx,), (ty,) = transform_points(np.array([x], float), np.array([y], float), src_srs, dst_srs)
    return (float(tx), float(ty))


class Place(BaseSingle):
    """Place the source raster at each of the given coordinates, merging
    overlaps with a statistic.

    Args:
      store (RasterBlock): raster to place
      place_projection (str): projection of anchor and coordinates
      anchor (2 numbers): the point in the source placed at each coordinate
      coordinates (list of (x, y)): target positions
      statistic (str): overlap merge statistic (see reduction.STATISTICS)
    """

    def __init__(self, store, place_projection, anchor, coordinates, statistic="last"):
        expect_instance(store, RasterBlock, "store")
        try:
            get_sr(place_projection)
        except Exception:
            raise ValueError(
                "'{}' is not a valid projection string".format(place_projection)
            )
        check_statistic(statistic)
        super().__init__(
            store,
            place_projection,
            self._coerce_point(anchor, "anchor"),
            self._coerce_points(coordinates),
            statistic,
        )

    @staticmethod
    def _coerce_point(value, name):
        point = list(value)
        if len(point) != 2:
            raise ValueError("Expected 2 numbers in the '%s' parameter" % name)
        for x in point:
            expect_instance(x, (int, float), "x")
        return point

    @staticmethod
    def _coerce_points(coordinates):
        if coordinates is None or len(coordinates) == 0:
            return []
        coordinates = np.asarray(coordinates, dtype=float)
        if coordinates.ndim != 2 or coordinates.shape[1] != 2:
            raise ValueError(
                "Expected a list of lists of 2 numbers in the "
                "'coordinates' parameter"
            )
        return coordinates.tolist()

    place_projection = arg(1)
    anchor = arg(2)
    coordinates = arg(3)
    statistic = arg(4)

    @property
    def projection(self):
        store_projection = self.store.projection
        if store_projection is None:
            return None
        if get_sr(self.place_projection) == get_sr(store_projection):
            return store_projection
        return None

    @property
    def geo_transform(self):
        if self.projection is not None:
            return self.store.geo_transform
        return None

    @property
    def extent(self):
        footprint = self.footprint
        if footprint is None:
            return None
        return footprint.transformed("EPSG:4326").bbox

    @property
    def footprint(self):
        store_footprint = self.store.footprint
        if store_footprint is None:
            return None
        extent = store_footprint.transformed(self.place_projection)
        _x1, _y1, _x2, _y2 = extent.bbox
        p, q = self.anchor
        if not self.coordinates:
            return None
        P, Q = zip(*self.coordinates)
        x1, x2 = _x1 + min(P) - p, _x2 + max(P) - p
        y1, y2 = _y1 + min(Q) - q, _y2 + max(Q) - q
        return Extent((x1, y1, x2, y2), extent.srs)

    def _points_in(self, projection):
        """Anchor and target coordinates transformed to ``projection``."""
        anchor = _transform_point(self.anchor, self.place_projection, projection)
        coordinates = [
            _transform_point(coord, self.place_projection, projection)
            for coord in self.coordinates
        ]
        return anchor, coordinates

    @staticmethod
    def _warp_mode_plan(request, anchor, coordinates, source_box, cell):
        """One full-extent fetch shifted on the output grid, when that is
        cheaper than per-coordinate requests; None otherwise."""
        xmin, ymin, xmax, ymax = source_box
        size_x, size_y = cell
        full_height = math.ceil((ymax - ymin) / size_y)
        full_width = math.ceil((xmax - xmin) / size_x)
        if full_height * full_width > request["width"] * request["height"]:
            return None
        source_request = dict(
            request,
            width=full_width,
            height=full_height,
            bbox=(
                xmin,
                ymin,
                xmin + full_width * size_x,
                ymin + full_height * size_y,
            ),
        )
        plan = {
            "mode": "warp",
            "anchor": anchor,
            "coordinates": coordinates,
            "src_bbox": source_request["bbox"],
            "dst_bbox": request["bbox"],
            "dst_shape": (request["height"], request["width"]),
            "cellsize": cell,
            "statistic": None,  # filled by the caller
        }
        return plan, source_request

    def get_sources_and_requests(self, **request):
        if request["mode"] != "vals":
            return ({"mode": request["mode"]}, None), (self.store, request)

        anchor, coordinates = self._points_in(request["projection"])

        footprint = self.store.footprint
        if footprint is None:
            return (({"mode": "null"}, None),)
        xmin, ymin, xmax, ymax = footprint.transformed(request["projection"]).bbox

        x1, y1, x2, y2 = request["bbox"]
        size_x = (x2 - x1) / request["width"]
        size_y = (y2 - y1) / request["height"]

        if size_x > 0 and size_y > 0:
            warp = self._warp_mode_plan(
                request,
                anchor,
                coordinates,
                (xmin, ymin, xmax, ymax),
                (size_x, size_y),
            )
            if warp is not None:
                plan, source_request = warp
                plan["statistic"] = self.statistic
                return [(plan, None), (self.store, source_request)]

        # per-coordinate shifted requests ("group" mode)
        sources_and_requests = []
        for _x, _y in coordinates:
            bbox = [
                x1 + anchor[0] - _x,
                y1 + anchor[1] - _y,
                x2 + anchor[0] - _x,
                y2 + anchor[1] - _y,
            ]
            # cells span [xmin, xmax) and (ymin, ymax]
            if bbox[0] >= xmax or bbox[1] > ymax or bbox[2] < xmin or bbox[3] <= ymin:
                continue
            _request = request.copy()
            _request["bbox"] = tuple(bbox)
            sources_and_requests.append((self.store, _request))
        if not sources_and_requests:
            # no coordinate overlaps; a time request provides the band depth
            empty_plan = dict(
                mode="empty",
                dtype=self.dtype,
                fillvalue=self.fillvalue,
                width=request["width"],
                height=request["height"],
                statistic=self.statistic,
            )
            return [
                (empty_plan, None),
                (self.store, dict(request, mode="time")),
            ]
        group_plan = dict(mode="group", statistic=self.statistic)
        return [(group_plan, None)] + sources_and_requests

    @staticmethod
    def process(process_kwargs, *multi):
        mode = process_kwargs["mode"]
        if mode in {"meta", "time"}:
            return multi[0]
        if mode == "null":
            return None
        if mode == "group":
            # shifted copies already arrived as separate frames: just merge
            stack = [frame for frame in multi if frame is not None]
            if not stack:
                return None
            return reduce_rasters(stack, process_kwargs["statistic"])
        if mode == "empty":
            data = multi[0]
            if data is None:
                return None
            return _nodata_raster(
                (
                    len(data["time"]),
                    process_kwargs["height"],
                    process_kwargs["width"],
                ),
                process_kwargs["fillvalue"],
                process_kwargs["dtype"],
            )
        if mode != "warp":
            raise ValueError("Unknown mode '{}'".format(mode))

        data = multi[0]
        if data is None:
            return None
        out_shape, stack = _paste_placements(process_kwargs, data)
        if not stack:
            return _nodata_raster(
                out_shape, data["no_data_value"], data["values"].dtype
            )
        return reduce_rasters(stack, process_kwargs["statistic"])


def _nodata_raster(shape, no_data_value, dtype):
    """An all-nodata raster response of the given shape."""
    return {
        "values": np.full(shape, no_data_value, dtype),
        "no_data_value": no_data_value,
    }


def _paste_placements(process_kwargs, data):
    """Warp-mode placements as whole-rectangle pastes.

    Each coordinate shifts the source block over the destination canvas;
    the overlap rectangle is pasted in bulk.  Returns ``(out_shape,
    stack)``; a placement whose visible part is all nodata is left out
    (so an all-nodata source yields an empty stack, which the caller
    answers with nodata, also for sum and count).
    """
    no_data_value = data["no_data_value"]
    source = data["values"]
    src_d, src_h, src_w = source.shape

    x1, y1, x2, y2 = process_kwargs["dst_bbox"]
    size_x, size_y = process_kwargs["cellsize"]
    dst_h = round((y2 - y1) / size_y)
    dst_w = round((x2 - x1) / size_x)
    out_shape = (src_d, dst_h, dst_w)

    if not np.any(get_index(source, no_data_value)):
        return out_shape, []

    anchor = process_kwargs["anchor"]
    src_bbox = process_kwargs["src_bbox"]
    anchor_px = (
        (anchor[0] - src_bbox[0]) / size_x,
        (anchor[1] - src_bbox[1]) / size_y,
    )

    stack = []
    for x, y in process_kwargs["coordinates"]:
        di = round((x - x1) / size_x - anchor_px[0])
        dj = round((y - y1) / size_y - anchor_px[1])
        # the row axis counts down from the top of the canvas
        dj = dst_h - src_h - dj

        # overlap rectangle between the shifted source and the canvas
        row0, row1 = max(dj, 0), min(dj + src_h, dst_h)
        col0, col1 = max(di, 0), min(di + src_w, dst_w)
        if row0 >= row1 or col0 >= col1:
            continue
        window = source[:, row0 - dj : row1 - dj, col0 - di : col1 - di]
        if not np.any(get_index(window, no_data_value)):
            continue
        canvas = np.full(out_shape, no_data_value, source.dtype)
        canvas[:, row0:row1, col0:col1] = window
        stack.append({"values": canvas, "no_data_value": no_data_value})
    return out_shape, stack


def _place_capable(process_kwargs, *rest):
    """The twin serves the warp and group modes; the others carry no
    arrays of their own and run on the host."""
    return isinstance(process_kwargs, dict) and process_kwargs.get("mode") in ("warp", "group")


def _placements_torch(process_kwargs, data):
    """The warp mode's canvases, batch-first: one (B, bands, h, w) tensor
    per coordinate, and a (coordinates, B) flag of the placements whose
    visible part holds data (those ``_paste_placements`` keeps).  Each
    tile's offsets come from its own ``dst_bbox`` (a (B, 4) tensor),
    rounded half to even as Python's ``round`` does."""
    ndv = data["no_data_value"]
    source = data["values"]
    n_batch, bands, src_h, src_w = source.shape
    dst_h, dst_w = process_kwargs["dst_shape"]
    device = source.device
    size_x, size_y = process_kwargs["cellsize"]
    anchor = process_kwargs["anchor"]
    src_bbox = process_kwargs["src_bbox"]
    anchor_px = (
        (anchor[0] - src_bbox[0]) / size_x,
        (anchor[1] - src_bbox[1]) / size_y,
    )
    dst_bbox = process_kwargs["dst_bbox"].to(torch.float64).reshape(n_batch, 4)
    x1, y1 = dst_bbox[:, 0], dst_bbox[:, 1]
    has_data = data_mask(source, ndv)
    fill = as_operand(ndv, numpy_dtype(source.dtype), device)
    batch = torch.arange(n_batch, device=device)[:, None, None]
    rows = torch.arange(dst_h, device=device)
    cols = torch.arange(dst_w, device=device)

    canvases, kept = [], []
    for x, y in process_kwargs["coordinates"]:
        di = torch.round((x - x1) / size_x - anchor_px[0]).to(torch.int64)
        dj = torch.round((y - y1) / size_y - anchor_px[1]).to(torch.int64)
        dj = dst_h - src_h - dj
        src_rows = rows[None, :] - dj[:, None]  # (B, h)
        src_cols = cols[None, :] - di[:, None]  # (B, w)
        inside = (
            ((src_rows >= 0) & (src_rows < src_h))[:, :, None]
            & ((src_cols >= 0) & (src_cols < src_w))[:, None, :]
        )  # (B, h, w)
        r = src_rows.clamp(0, src_h - 1)[:, :, None]
        c = src_cols.clamp(0, src_w - 1)[:, None, :]
        # (B, h, w, bands) -> (B, bands, h, w)
        placed = source.permute(0, 2, 3, 1)[batch, r, c].permute(0, 3, 1, 2)
        visible = has_data.permute(0, 2, 3, 1)[batch, r, c].permute(0, 3, 1, 2)
        canvases.append(torch.where(inside[:, None], placed, fill))
        kept.append((visible & inside[:, None]).flatten(1).any(1))
    return canvases, (torch.stack(kept) if kept else None)


def _place_torch(process_kwargs, *multi):
    """Twin of ``Place.process`` for the warp and group modes.

    Warp mode pastes the source once per coordinate, at each tile's own
    offset, and reduces only the placements ``_paste_placements`` keeps:
    the tiles of a batch are grouped by which placements they keep, so
    every statistic (sum and count included, whose empty stack gives
    nodata rather than 0) reduces the same layers as the numpy process,
    in the same order."""
    mode = process_kwargs["mode"]
    if mode == "group":
        stack = [frame for frame in multi if frame is not None]
        if not stack:
            return None
        return reduce_rasters_torch(stack, process_kwargs["statistic"])

    data = multi[0]
    if data is None:
        return None
    source = data["values"]
    ndv = data["no_data_value"]
    dtype = numpy_dtype(source.dtype)
    dst_h, dst_w = process_kwargs["dst_shape"]
    out = torch.full(
        (source.shape[0], source.shape[1], dst_h, dst_w),
        np.full((), ndv, dtype)[()].item(),
        dtype=source.dtype,
        device=source.device,
    )
    canvases, kept = _placements_torch(process_kwargs, data)
    if kept is None:
        return {"values": out, "no_data_value": ndv}
    patterns, tile_pattern = torch.unique(kept.T, dim=0, return_inverse=True)
    for index, pattern in enumerate(patterns.cpu().numpy()):
        if not pattern.any():
            continue  # nothing visible: the tiles stay all nodata
        tiles = torch.nonzero(tile_pattern == index)[:, 0]
        stack = [
            {"values": canvas[tiles], "no_data_value": ndv}
            for canvas, keep in zip(canvases, pattern)
            if keep
        ]
        out[tiles] = reduce_rasters_torch(stack, process_kwargs["statistic"])["values"]
    return {"values": out, "no_data_value": ndv}


# the tile's bbox varies per tile: placements shift per tile in one batch
Place.process.torch_dynamic = {"dst_bbox"}
register(Place.process, _place_torch, capable=_place_capable)
