"""Smooth, MovingMax and HillShade: blocks, numpy processes, torch twins.

Counterparts of dask_geomodeling_tpu/raster/spatial.py.  A stencil grows
its source request by its halo (``expand_request_pixels`` /
``expand_request_meters``), computes on the over-fetched array and crops
the margin off.  The twins run batch-first on (B, bands, h, w): the
Gaussian and the moving maximum are one kernel launch over all B x bands
planes of a batch (ops/cuda_stencils.py); HillShade is plain torch, as
the JAX package has no Pallas kernel for it.
"""
import math

import numpy as np
import torch
from scipy import ndimage

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import equal_scalar, numpy_dtype
from dask_geomodeling_tpu_torch.geo import Extent, get_dtype_min, get_footprint, get_sr
from dask_geomodeling_tpu_torch.ops.cuda_stencils import gaussian_blur, moving_max
from dask_geomodeling_tpu_torch.ops.stencils import blur_dtype
from dask_geomodeling_tpu_torch.raster.base import BaseSingle
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["Smooth", "MovingMax", "HillShade"]


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
