"""The raster sources, their numpy process, and its torch twin.

Counterparts of dask_geomodeling_tpu/raster/sources.py: ``RasterData``,
``RasterSourceBase`` with its numpy ``process`` (the requested time window
snaps onto the band axis, a point request reads the single containing
pixel, an area request warps into the requested grid), ``MemorySource``,
``RasterFileSource`` (GeoTIFF, VRT, Zarr v2 stores, HDF4, netCDF, PNG,
GRIB, NITF, the plain-grid formats and the tile pyramids of
``runtime/pipeline.py:whole_file_reader``; its
other formats raise NotImplementedError naming the JAX module that reads
them), and the twin
of ``_source_process_jax``.  Both the process and the twin resample as
``geomodeling.warp-interpolation`` says ("nearest" or "bilinear").

A payload read whole (a MemorySource's array, a small file through the
read cache) is moved to the device once (``to_device``) and stays
resident across tiles and batches, as the JAX executor keeps it in HBM.
A GeoTIFF, VRT, Zarr store or netCDF file above
``geomodeling.windowed-read-limit`` is read window by window (a store or a
netCDF-4 file chunk by chunk, a classic netCDF file as slices of its
cached whole decode): each tile's plan
carries the window its bbox touches, with the window's own float64
geotransform.  The twin takes those windows per tile
(``torch_dynamic``): a batch's windows are stacked, padded to the largest,
and each tile is indexed as the numpy process indexes its own window, so
windowed tiles share batches as a MemorySource's do and stay bitwise.
"""
import dataclasses
import weakref
from dataclasses import dataclass
from datetime import datetime, timedelta, timezone

import numpy as np
import torch

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    GeoTransform,
    dt_to_ms,
    get_dtype_max,
    get_epsg_or_wkt,
    get_projection,
    get_transform_func,
    snap_start_stop,
    transform_points,
)
from dask_geomodeling_tpu_torch.geo.safefiles import safe_abspath, safe_file_url
from dask_geomodeling_tpu_torch.ops.warp import (
    APPROX_STRIDE,
    coarse_index_grid,
    warp_numpy,
    warp_torch,
)
from dask_geomodeling_tpu_torch.raster.base import RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["MemorySource", "RasterFileSource", "RasterData", "to_device"]

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

        # memory and file paths converge on a RasterData payload
        raster_data = process_kwargs.get("raster_data")
        if raster_data is None:
            from dask_geomodeling_tpu_torch.runtime.pipeline import read_geotiff_cached

            raster_data = read_geotiff_cached(safe_abspath(process_kwargs["url"]))
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
            plan = self._payload_plan(mode, request)
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
    def geometry(self):
        extent = self._get_extent()
        return None if extent is None else extent.as_geometry()


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

    @property
    def data(self):
        data = self.args[0]
        if not isinstance(data, np.ndarray):
            # views loaded from JSON (no validation) carry plain lists: an
            # integer list becomes int64, as in the JAX package; coerce
            # once and keep it
            data = np.asarray(data)
            if data.ndim == 2:
                data = data[np.newaxis]
            self.args = (data,) + tuple(self.args[1:])
        return data

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

    def _payload_plan(self, mode, request=None):
        raster_data = RasterData(
            array=self.data,
            metadata=self.metadata,
            geo_transform=tuple(self.geo_transform),
            no_data_value=float(self.no_data_value),
            projection=self.projection,
        )
        return {"mode": mode, "raster_data": raster_data}


class RasterFileSource(RasterSourceBase):
    """A raster source reading a raster file from a path: a GeoTIFF, a VRT
    mosaic, a Zarr v2 store (a directory), an HDF4 file (``.hdf``, ``.h4``
    or ``.hdf4`` with HDF4's magic: its scientific data sets are the
    frames), a netCDF file (classic CDF-1 or CDF-2, or netCDF-4/HDF5 where
    h5py is importable: ``.nc``, ``.cdf``, ``.nc3``, ``.nc4``, ``.h5``,
    ``.hdf5``, and an ``.hdf``, ``.h4`` or ``.hdf4`` that is no HDF4
    file), or a format that decodes whole (PNG,
    SRTM ``.hgt``, DTED, GRIB editions 1 and 2 (``.grib``, ``.grib2``,
    ``.grb``, ``.grb2``, ``.gb2``: each field a frame), Esri ASCII and
    XYZ, Surfer, SAGA, Idrisi, ENVI, ERDAS Imagine, MBTiles, a
    GeoPackage's tile layer: a ``.gpkg`` is always read as tiles here, a
    GeoPackage of features raising).

    Args:
      url (str): path to the file, sandboxed by ``geomodeling.root``
      time_first (int or datetime): timestamp of the first frame (ms)
      time_delta (int or timedelta): frame spacing (ms), default 5 minutes
      variable (str): data variable of multi-variable containers (a Zarr
        store's array, a netCDF file's variable; the largest when None);
        kept in the cache keys
    """

    def __init__(self, url, time_first=0, time_delta=300000, variable=None):
        if variable is not None:
            expect_instance(variable, str, "variable")
        super().__init__(
            safe_file_url(url),
            _as_ms(time_first, 0),
            _as_ms(time_delta, 300000),
            variable,
        )

    url = arg(0)
    time_first = arg(1)
    time_delta = arg(2)
    variable = arg(3, "data variable for multi-variable containers", default=None)

    @property
    def info(self):
        """Cached header info of the file (no pixel data read)."""
        try:
            return self._info
        except AttributeError:
            from dask_geomodeling_tpu_torch.runtime.pipeline import (
                check_ported_format,
                is_hdf4,
                is_netcdf,
                whole_file_reader,
            )

            path = safe_abspath(self.url)
            check_ported_format(path)
            if path.lower().endswith(".zarr"):
                # from the metadata: a large store decodes no chunk for it
                from dask_geomodeling_tpu_torch.io.zarr import read_zarr_info

                self._info = read_zarr_info(path, self.variable)
            elif is_hdf4(path):
                # from the header: a large granule decodes no chunk for it
                from dask_geomodeling_tpu_torch.io.hdf4 import read_hdf4_info

                self._info = read_hdf4_info(path)
            elif is_netcdf(path):
                # a netCDF-4 file's from its metadata and coordinates
                from dask_geomodeling_tpu_torch.io.netcdf import read_netcdf_info

                self._info = read_netcdf_info(path, self.variable)
            elif path.lower().endswith((".ntf", ".nitf")):
                # from the headers: no segment decoded for it
                from dask_geomodeling_tpu_torch.io.nitf import read_nitf_info

                self._info = read_nitf_info(path)
            elif path.lower().endswith(".vrt"):
                from dask_geomodeling_tpu_torch.io.vrt import read_vrt_info

                self._info = read_vrt_info(path)
            elif whole_file_reader(path) is not None:
                # no header reader: the whole-file read cache decodes it
                from dask_geomodeling_tpu_torch.io.geotiff import GeoTIFFInfo
                from dask_geomodeling_tpu_torch.runtime.pipeline import read_geotiff_cached

                data = read_geotiff_cached(path, variable=self.variable)
                self._info = GeoTIFFInfo(
                    width=data.array.shape[2],
                    height=data.array.shape[1],
                    bands=data.array.shape[0],
                    dtype=str(data.array.dtype),
                    projection=data.projection,
                    geo_transform=data.geo_transform,
                    no_data_value=data.no_data_value,
                    metadata=data.metadata,
                )
            else:
                from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff_info

                self._info = read_geotiff_info(path)
            return self._info

    def close_dataset(self):
        for attribute in ("_info", "_overviews"):
            if hasattr(self, attribute):
                delattr(self, attribute)

    @property
    def projection(self):
        return get_epsg_or_wkt(self.info.projection)

    @property
    def dtype(self):
        return np.dtype(self.info.dtype)

    @property
    def fillvalue(self):
        # a file without a nodata tag, or with one outside the dtype's
        # range (SAGA's -99999 on byte grids), cannot hold nodata cells:
        # the fill is the dtype's maximum
        no_data = self.info.no_data_value
        if no_data is not None:
            try:
                cast = self.dtype.type(no_data)
                if float(cast) == float(no_data):
                    return cast
            except (OverflowError, ValueError):
                pass
        return self.dtype.type(get_dtype_max(self.dtype))

    @property
    def geo_transform(self):
        return GeoTransform(self.info.geo_transform)

    def _get_extent(self):
        bbox = self.geo_transform.get_bbox((0, 0), (self.info.height, self.info.width))
        return Extent(bbox, self.projection)

    def __len__(self):
        return self.info.bands

    @property
    def timedelta(self):
        if len(self) <= 1:
            return None
        return timedelta(milliseconds=self.time_delta)

    @property
    def temporal(self):
        return len(self) > 1

    def _payload_plan(self, mode, request=None):
        from dask_geomodeling_tpu_torch.runtime.pipeline import (
            read_geotiff_cached,
            read_geotiff_window_cached,
        )

        if mode == "meta":
            return {"mode": "meta", "url": self.url}
        path = safe_abspath(self.url)
        plan = self._file_read_plan(request)
        if plan is None:
            return {
                "mode": mode,
                "raster_data": read_geotiff_cached(path, variable=self.variable),
            }
        level, window = plan
        return {
            "mode": mode,
            "raster_data": read_geotiff_window_cached(
                path, *window, level=level, variable=self.variable
            ),
            # the twin takes this payload per tile (_source_stage)
            "windowed": True,
        }

    def _file_read_plan(self, request):
        """``(level, (row0, row1, col0, col1))`` for a vals request, or
        None for the plain whole-file read: a GeoTIFF, VRT, Zarr store, HDF4
        or netCDF file above ``geomodeling.windowed-read-limit`` decodes
        only the blocks (a store's, an HDF4 or a netCDF-4 file's chunks) of
        the request's source-CRS bbox plus a 2-pixel margin, and with
        ``geomodeling.use-overviews`` a request at 2x or more coarser
        resolution reads the best overview level of a GeoTIFF."""
        if request is None:
            return None
        path = safe_abspath(self.url)
        from dask_geomodeling_tpu_torch.runtime.pipeline import is_hdf4, is_netcdf

        # VRTs, Zarr stores, HDF4 and netCDF files have no overview levels
        chunked_store = (path.lower().endswith((".zarr", ".vrt")) or is_hdf4(path)
                         or is_netcdf(path))
        if not (chunked_store or path.lower().endswith((".tif", ".tiff"))):
            return None
        info = self.info

        # 1. source-CRS bbox of the request (densified across CRSes)
        bbox = request["bbox"]
        try:
            if (
                get_projection(self.projection).upper()
                != get_projection(request["projection"]).upper()
            ):
                bbox = self._densified_extent(bbox, request["projection"], self.projection)
                if bbox is None:
                    return None
        except Exception:
            return None  # unparseable CRS etc.: whole-file fallback

        # 2. overview selection: coarse requests read the pyramid
        level = 0
        level_w, level_h = info.width, info.height
        gt = tuple(self.geo_transform)
        if not chunked_store and config.get("geomodeling.use-overviews", False):
            level, level_w, level_h = self._overview_choice(bbox, request)
            if level:
                fx = info.width / float(level_w)
                fy = info.height / float(level_h)
                gt = (gt[0], gt[1] * fx, gt[2], gt[3], gt[4], gt[5] * fy)

        # 3. window gate: only files above the limit decode block-wise
        limit = config.get("geomodeling.windowed-read-limit", 64 * 1024**2)
        if limit is None or level_w * level_h <= int(limit):
            if level == 0:
                return None
            return level, (0, level_h, 0, level_w)

        try:
            (row0, row1), (col0, col1) = GeoTransform(gt).get_indices_for_bbox(bbox)
        except Exception:
            return (level, (0, level_h, 0, level_w)) if level else None
        # nearest/bilinear sampling margin + half-open upper edge
        margin = 2
        row0, col0 = row0 - margin, col0 - margin
        row1, col1 = row1 + margin + 1, col1 + margin + 1
        if row1 <= 0 or col1 <= 0 or row0 >= level_h or col0 >= level_w:
            # no overlap: a minimal corner window keeps the plan shape
            return level, (0, 1, 0, 1)
        return level, (max(0, row0), min(level_h, row1), max(0, col0), min(level_w, col1))

    def _overview_choice(self, bbox, request):
        """(level, width, height) of the coarsest overview still finer
        than the request resolution, or (0, full_w, full_h)."""
        info = self.info
        full = (0, info.width, info.height)
        width, height = request["width"], request["height"]
        if width <= 0 or height <= 0:
            return full
        req_cell_x = abs(bbox[2] - bbox[0]) / float(width)
        req_cell_y = abs(bbox[3] - bbox[1]) / float(height)
        gt = self.geo_transform
        src_cell_x, src_cell_y = abs(gt[1]), abs(gt[5])
        if req_cell_x <= 0 or req_cell_y <= 0:
            return full
        ratio = min(req_cell_x / src_cell_x, req_cell_y / src_cell_y)
        if ratio < 2.0:
            return full
        try:
            overviews = self._overview_sizes()
        except Exception:
            return full
        best = full
        best_factor = 1.0
        for index, (ov_w, ov_h) in enumerate(overviews):
            factor = info.width / float(ov_w)
            if factor <= ratio and factor > best_factor:
                best = (index + 1, ov_w, ov_h)
                best_factor = factor
        return best

    def _overview_sizes(self):
        try:
            return self._overviews
        except AttributeError:
            from dask_geomodeling_tpu_torch.io.geotiff import read_geotiff_overviews

            self._overviews = read_geotiff_overviews(safe_abspath(self.url))
            return self._overviews

    @staticmethod
    def _densified_extent(bbox, src_proj, dst_proj, points_per_edge=21):
        """Transform ``bbox`` to ``dst_proj`` sampling every edge densely
        (21 points, as GDAL does: corners alone under-cover the curved
        preimage of a bbox); any non-finite sample gives None."""
        x1, y1, x2, y2 = bbox
        t = np.linspace(0.0, 1.0, points_per_edge)
        xs = np.concatenate(
            [x1 + (x2 - x1) * t, np.full_like(t, x2), x2 + (x1 - x2) * t, np.full_like(t, x1)]
        )
        ys = np.concatenate(
            [np.full_like(t, y1), y1 + (y2 - y1) * t, np.full_like(t, y2), y2 + (y1 - y2) * t]
        )
        tx, ty = get_transform_func(src_proj, dst_proj)(xs, ys)
        tx, ty = np.asarray(tx, float), np.asarray(ty, float)
        if not (np.isfinite(tx).all() and np.isfinite(ty).all()):
            return None
        return (tx.min(), ty.min(), tx.max(), ty.max())


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
        # the table is bound now: at interpreter exit the module's globals
        # may already be gone when the last arrays go
        ref = weakref.ref(array, lambda _ref, table=_RESIDENT: table.pop(key, None))
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
    coarse index grid (ops/warp.py) as ``warp_grid``, in the coordinates
    of the payload (a window's own, for a windowed read).  A windowed
    payload leaves ``raster_data`` for the per-tile literals ``window``
    (its requested bands), ``window_gt`` and ``window_shape``, which the
    batch stacks; what stays in ``raster_data`` is the same in every
    tile."""
    raster_data = process_kwargs["raster_data"]
    staged = process_kwargs
    if (
        get_projection(raster_data.projection).upper()
        != get_projection(process_kwargs["projection"]).upper()
    ):
        grid = coarse_index_grid(
            tuple(raster_data.geo_transform),
            raster_data.projection,
            process_kwargs["bbox"],
            process_kwargs["projection"],
            process_kwargs["width"],
            process_kwargs["height"],
            APPROX_STRIDE,
        )
        staged = dict(staged, warp_grid=grid)
    if process_kwargs.get("windowed"):
        bands = process_kwargs["bands"]
        window = raster_data.array[bands[0] : bands[1]]
        staged = dict(
            staged,
            raster_data=dataclasses.replace(raster_data, array=None, geo_transform=None),
            window=window,
            window_gt=np.asarray(raster_data.geo_transform, np.float64),
            window_shape=np.asarray(window.shape[1:], np.int64),
        )
    return (staged,)


def _source_process_torch(process_kwargs):
    """Batch-first twin of RasterSourceBase.process for the vals path:
    ``raster_data.array`` is the resident tensor, or ``window`` (B, bands,
    H, W) holds each tile's window with ``window_gt`` (B, 6) and
    ``window_shape`` (B, 2); ``bbox`` (B, 4) and ``warp_grid`` (B, 2, ch,
    cw, from ``_source_stage``) are per-tile tensors."""
    raster_data = process_kwargs["raster_data"]
    bands = process_kwargs["bands"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = dtype.type(process_kwargs["fillvalue"]).item()
    window = process_kwargs.get("window")
    if window is None:
        values, src_gt, src_size = (
            raster_data.array[bands[0] : bands[1]], tuple(raster_data.geo_transform), None
        )
    else:
        values, src_gt, src_size = window, process_kwargs["window_gt"], process_kwargs["window_shape"]
    result = warp_torch(
        values,
        src_gt,
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
        src_size=src_size,
    )
    if dtype.kind == "f":
        result = torch.where(torch.isfinite(result), result, fillvalue)
    return {"values": result, "no_data_value": fillvalue}


# per-tile literals, stacked over a batch (runtime/executor.py:batch_literals)
RasterSourceBase.process.torch_dynamic = {
    "bbox", "warp_grid", "window", "window_gt", "window_shape"
}
register(
    RasterSourceBase.process,
    _source_process_torch,
    capable=_source_capable,
    stage=_source_stage,
)
