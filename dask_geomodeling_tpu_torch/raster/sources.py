"""MemorySource, its numpy process, and its torch twin.

Counterparts of dask_geomodeling_tpu/raster/sources.py: ``RasterData``,
``RasterSourceBase`` with its numpy ``process`` (the requested time window
snaps onto the band axis, a point request reads the single containing
pixel, an area request warps into the requested grid), ``MemorySource``,
and the twin of ``_source_process_jax``.  A MemorySource payload is moved
to the device once (``to_device``) and stays resident across tiles and
batches, as the JAX executor keeps it in HBM.  File sources are not
ported.  Both the process and the twin resample as
``geomodeling.warp-interpolation`` says ("nearest" or "bilinear").
"""
import weakref
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import arg
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    GeoTransform,
    dt_to_ms,
    get_epsg_or_wkt,
    get_projection,
    snap_start_stop,
    transform_points,
)
from dask_geomodeling_tpu_torch.ops.warp import (
    APPROX_STRIDE,
    coarse_index_grid,
    warp_numpy,
    warp_torch,
)
from dask_geomodeling_tpu_torch.raster.base import RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["MemorySource", "RasterData", "to_device"]

_EMPTY_ANSWERS = {
    "empty_vals": None,
    "empty_time": {"time": []},
    "empty_meta": {"meta": []},
}


@dataclass
class RasterData:
    """In-memory raster payload shipped in process_kwargs."""

    array: np.ndarray
    projection: str
    geo_transform: tuple
    no_data_value: float
    metadata: list


def utc_from_ms_timestamp(timestamp):
    """Naive UTC datetime from a milliseconds POSIX timestamp."""
    return datetime.fromtimestamp(timestamp / 1000, tz=timezone.utc).replace(
        tzinfo=None
    )


def _as_ms(value, default=None):
    """Milliseconds from a datetime/timedelta/number timestamp or spacing."""
    if isinstance(value, datetime):
        return dt_to_ms(value)
    if isinstance(value, timedelta):
        return int(value.total_seconds() * 1000)
    if value is None:
        return default
    return int(value)


def warp_interpolation():
    """The sources' resampling, ``geomodeling.warp-interpolation``."""
    return config.get("geomodeling.warp-interpolation", "nearest")


class RasterSourceBase(RasterBlock):
    """Shared process() and temporal/extent attributes of the sources."""

    @staticmethod
    def process(process_kwargs):
        mode = process_kwargs["mode"]
        if mode in _EMPTY_ANSWERS:
            return _EMPTY_ANSWERS[mode]

        bands = process_kwargs["bands"]
        if mode == "time":
            start = process_kwargs["start"]
            delta = process_kwargs["delta"]
            return {
                "time": [start + i * delta for i in range(bands[1] - bands[0])]
            }

        raster_data = process_kwargs.get("raster_data")
        if raster_data is None:
            raise NotImplementedError("file sources are not ported")
        if mode == "meta":
            metadata = raster_data.metadata or [None] * len(raster_data.array)
            return {"meta": list(metadata[bands[0] : bands[1]])}
        return RasterSourceBase._answer_vals(process_kwargs, raster_data)

    @staticmethod
    def _answer_vals(process_kwargs, raster_data):
        bands = process_kwargs["bands"]
        dtype = np.dtype(process_kwargs["dtype"])
        bbox = process_kwargs["bbox"]
        width, height = process_kwargs["width"], process_kwargs["height"]
        fill = np.dtype(dtype).type(process_kwargs["fillvalue"]).item()

        if width == 0 or height == 0:
            return {
                "values": np.empty(
                    (bands[1] - bands[0], height, width), dtype=dtype
                ),
                "no_data_value": fill,
            }

        if bbox[0] == bbox[2] or bbox[1] == bbox[3]:
            result = RasterSourceBase._read_point(
                raster_data, bbox, process_kwargs["projection"], dtype, fill
            )[bands[0] : bands[1]]
        else:
            # slice the band window before the warp, as the twin does
            result = warp_numpy(
                raster_data.array[bands[0] : bands[1]],
                GeoTransform(raster_data.geo_transform),
                raster_data.projection,
                raster_data.no_data_value,
                bbox,
                process_kwargs["projection"],
                width,
                height,
                dtype=dtype,
                fillvalue=fill,
                interpolation=warp_interpolation(),
            )
        if result.dtype.kind == "f":
            result[~np.isfinite(result)] = fill
        return {"values": result, "no_data_value": fill}

    @staticmethod
    def _read_point(raster_data, bbox, projection, dtype, fill):
        """A 1x1 read of the pixel containing the (reprojected) point."""
        array = raster_data.array
        (x,), (y,) = transform_points(
            np.array([bbox[0]]),
            np.array([bbox[1]]),
            projection,
            raster_data.projection,
        )
        gt = GeoTransform(raster_data.geo_transform)
        (i,), (j,) = gt.get_indices(((x, y),))
        result = np.full((len(array), 1, 1), fill, dtype=dtype)
        if 0 <= i < array.shape[1] and 0 <= j < array.shape[2]:
            result[:, 0, 0] = array[:, i, j]
        return result

    def _snap_bands(self, request):
        """Snap start/stop onto the band axis; None if empty."""
        start, stop, band1, band2 = snap_start_stop(
            request.get("start"),
            request.get("stop"),
            utc_from_ms_timestamp(self.time_first),
            self.timedelta,
            len(self),
        )
        if start is None:
            return None
        return start, stop, (band1, band2 + 1)

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        if mode not in ("vals", "meta", "time"):
            raise RuntimeError("Unknown mode '{}'".format(mode))
        snapped = self._snap_bands(request)
        if snapped is None:
            return [({"mode": "empty_" + mode}, None)]
        start, stop, bands = snapped

        if mode == "time":
            plan = {
                "mode": "time",
                "start": start,
                "delta": self.timedelta or timedelta(0),
                "bands": bands,
            }
        else:
            plan = self._payload_plan(mode)
            plan["bands"] = bands
            if mode == "vals":
                plan.update(
                    mode="vals",
                    bbox=request["bbox"],
                    width=request["width"],
                    height=request["height"],
                    projection=request["projection"],
                    dtype=self.dtype,
                    fillvalue=self.fillvalue,
                )
        return [(plan, None)]

    @property
    def period(self):
        count = len(self)
        if count == 0:
            return None
        first = utc_from_ms_timestamp(self.time_first)
        if count == 1:
            return (first, first)
        return first, first + (count - 1) * self.timedelta

    @property
    def extent(self):
        extent = self._get_extent()
        return None if extent is None else extent.transformed("EPSG:4326").bbox

    @property
    def footprint(self):
        return self._get_extent()


class MemorySource(RasterSourceBase):
    """A raster source interfacing data from memory.

    Args:
      data (ndarray or number): pixel values, coerced to a 3D (t, y, x) array
      no_data_value (number): the 'no data' marker
      projection (str): projection of the data
      pixel_size (float or (x, y)): pixel size in projection units
      pixel_origin ((x, y)): location of pixel (0, 0)
      time_first (int or datetime): timestamp of the first frame (ms)
      time_delta (int, timedelta or None): frame spacing (ms)
      metadata (list or None): per-frame metadata
    """

    def __init__(
        self,
        data,
        no_data_value,
        projection,
        pixel_size,
        pixel_origin,
        time_first=0,
        time_delta=None,
        metadata=None,
    ):
        data = self._coerce_data(data)
        no_data_value = data.dtype.type(no_data_value)
        projection = get_epsg_or_wkt(projection)
        pixel_size = self._coerce_pair(pixel_size, "pixel_size")
        pixel_origin = self._coerce_pair(pixel_origin, "pixel_origin")
        time_first = _as_ms(time_first, 0)
        time_delta = _as_ms(time_delta)
        if time_delta is None and data.shape[0] > 1:
            raise ValueError("time_delta is required for temporal data")
        if metadata is not None:
            metadata = list(metadata)
            if len(metadata) != data.shape[0]:
                raise ValueError("Metadata length should match data length")
        super().__init__(
            data,
            no_data_value,
            projection,
            pixel_size,
            pixel_origin,
            time_first,
            time_delta,
            metadata,
        )

    @staticmethod
    def _coerce_data(data):
        data = np.asarray(data)
        if data.dtype == "i8":
            data = data.astype("i4")  # parity with the reference's GDAL limit
        if data.ndim == 2:
            data = data[np.newaxis]
        if data.ndim != 3:
            raise ValueError("data should be two- or three-dimensional.")
        return data

    @staticmethod
    def _coerce_pair(value, name):
        pair = [value] * 2 if not hasattr(value, "__iter__") else list(value)
        if len(pair) != 2:
            raise ValueError("%s should have length 2" % name)
        return [float(x) for x in pair]

    data = arg(0)
    no_data_value = arg(1)
    projection = arg(2)
    pixel_size = arg(3)
    pixel_origin = arg(4)
    time_first = arg(5)
    time_delta = arg(6)
    metadata = arg(7)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def fillvalue(self):
        return self.no_data_value

    @property
    def geo_transform(self):
        p, q = self.pixel_origin
        a, d = self.pixel_size
        return GeoTransform((p, a, 0, q, 0, -d))

    def _get_extent(self):
        if not self.data.size:
            return None
        bbox = self.geo_transform.get_bbox((0, 0), self.data.shape[1:])
        return Extent(bbox, self.projection)

    def __len__(self):
        return self.data.shape[0]

    @property
    def timedelta(self):
        if self.time_delta is None:
            return None
        return timedelta(milliseconds=self.time_delta)

    @property
    def temporal(self):
        return self.time_delta is not None

    def get_sources_and_requests(self, **request):
        if request["mode"] == "meta" and self.metadata is None:
            return [({"mode": "empty_meta"}, None)]
        return super().get_sources_and_requests(**request)

    def _payload_plan(self, mode):
        raster_data = RasterData(
            array=self.data,
            metadata=self.metadata,
            geo_transform=tuple(self.geo_transform),
            no_data_value=float(self.no_data_value),
            projection=self.projection,
        )
        return {"mode": mode, "raster_data": raster_data}


# --- the torch twin ---

#: (id(array), device) -> (weakref to the array, tensor)
_RESIDENT = {}


def to_device(array, device):
    """The tensor on ``device`` holding numpy ``array``, cached by the
    array's identity: a source payload crosses to the device once and is
    shared by every later tile.  The entry goes when the array does.
    Twins treat the result as read-only (on the CPU it may share the
    array's memory)."""
    device = torch.device(device)
    key = (id(array), str(device))
    entry = _RESIDENT.get(key)
    if entry is not None and entry[0]() is array:
        return entry[1]
    if device.type == "cpu" and array.flags.writeable:
        tensor = torch.from_numpy(np.ascontiguousarray(array))
    else:
        tensor = torch.tensor(np.ascontiguousarray(array), device=device)
    try:
        ref = weakref.ref(array, lambda _ref: _RESIDENT.pop(key, None))
    except TypeError:
        return tensor  # not weak-referenceable: not cached
    _RESIDENT[key] = (ref, tensor)
    return tensor


def _source_capable(process_kwargs):
    """The twin serves in-memory vals requests with a real bbox."""
    if not isinstance(process_kwargs, dict):
        return False
    if process_kwargs.get("mode") != "vals":
        return False
    if process_kwargs.get("raster_data") is None:
        return False
    bbox = process_kwargs["bbox"]
    if bbox[0] == bbox[2] or bbox[1] == bbox[3]:
        return False  # point request: host single-pixel read
    return process_kwargs["width"] > 0 and process_kwargs["height"] > 0


def _source_stage(process_kwargs):
    """Per tile, on the host: a cross-CRS vals request gets its float64
    coarse index grid (ops/warp.py) as ``warp_grid``."""
    raster_data = process_kwargs["raster_data"]
    if (
        get_projection(raster_data.projection).upper()
        == get_projection(process_kwargs["projection"]).upper()
    ):
        return (process_kwargs,)
    grid = coarse_index_grid(
        tuple(raster_data.geo_transform),
        raster_data.projection,
        process_kwargs["bbox"],
        process_kwargs["projection"],
        process_kwargs["width"],
        process_kwargs["height"],
        APPROX_STRIDE,
    )
    return (dict(process_kwargs, warp_grid=grid),)


def _source_process_torch(process_kwargs):
    """Batch-first twin of RasterSourceBase.process for the vals path:
    ``raster_data.array`` is the resident tensor, ``bbox`` (B, 4) and
    ``warp_grid`` (B, 2, ch, cw, from ``_source_stage``) are per-tile
    tensors."""
    raster_data = process_kwargs["raster_data"]
    bands = process_kwargs["bands"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = dtype.type(process_kwargs["fillvalue"]).item()
    result = warp_torch(
        raster_data.array[bands[0] : bands[1]],
        tuple(raster_data.geo_transform),
        raster_data.projection,
        raster_data.no_data_value,
        process_kwargs["bbox"],
        process_kwargs["projection"],
        process_kwargs["width"],
        process_kwargs["height"],
        dtype,
        fillvalue,
        interpolation=warp_interpolation(),
        coarse_grid=process_kwargs.get("warp_grid"),
    )
    if dtype.kind == "f":
        result = torch.where(torch.isfinite(result), result, fillvalue)
    return {"values": result, "no_data_value": fillvalue}


# per-tile literals, stacked over a batch (runtime/executor.py:batch_literals)
RasterSourceBase.process.torch_dynamic = {"bbox", "warp_grid"}
register(
    RasterSourceBase.process,
    _source_process_torch,
    capable=_source_capable,
    stage=_source_stage,
)
