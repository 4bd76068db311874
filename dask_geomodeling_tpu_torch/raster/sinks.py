"""Raster sinks: RasterFileSink and the exports ``to_file``, ``to_cog`` and
``to_zarr``.

Counterpart of dask_geomodeling_tpu/raster/sinks.py: each vals request
writes one deflate-compressed tiled GeoTIFF named by the first 7
characters of the request's token, so a re-run writes the same files;
``to_file`` runs the sink under a RasterTiler and merges the tiles into a
VRT; ``to_cog`` writes one cloud-optimized GeoTIFF and ``to_zarr`` one
consolidated Zarr v2 group store.  The sink is a host
process over fetched inputs (``torch_fetch_inputs``): ``compute_torch``
copies its source's device result to the host once per subrequest, and
the writer is the JAX package's, copied (io/geotiff.py), so the port
writes the same names and the same bytes (the Zarr writer is io/zarr.py's
copy).
"""
import glob
import os
from collections import namedtuple

import numpy as np

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.core.tokens import tokenize
from dask_geomodeling_tpu_torch.geo.geotransform import GeoTransform
from dask_geomodeling_tpu_torch.geo.safefiles import safe_abspath, safe_file_url
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.raster.parallelize import RasterTiler

__all__ = ["RasterFileSink", "to_file", "to_cog", "to_zarr"]

#: everything one tile write needs, planned at request-rewrite time
_TileWriteSpec = namedtuple("_TileWriteSpec", ["directory", "stem", "bbox", "projection"])


class RasterFileSink(BaseSingle):
    """Write raster data to hash-named GeoTIFF files in a directory.

    Args:
      source (RasterBlock): block the data comes from
      url (str): target directory (relative to ``geomodeling.root``)
    """

    def __init__(self, source, url):
        expect_instance(source, RasterBlock, "source")
        super().__init__(source, safe_file_url(url))

    url = arg(1, "sandboxed target directory URL")

    def get_sources_and_requests(self, **request):
        spec = None
        if request["mode"] == "vals":
            spec = _TileWriteSpec(
                directory=self.url,
                stem=tokenize(request)[:7],
                bbox=request["bbox"],
                projection=request["projection"],
            )
        return [(self.store, request), (spec, None)]

    @staticmethod
    def process(data, spec=None):
        from dask_geomodeling_tpu_torch.io.geotiff import write_geotiff

        if spec is None:
            return data  # non-vals mode passes through
        if data is None or "values" not in data:
            return None
        spec = _TileWriteSpec(*spec)

        values = np.asarray(data["values"])
        if values.ndim != 3 or values.shape[0] != 1:
            raise ValueError(
                "Expected a single-band raster (shape (1, H, W)), got shape "
                "{}".format(values.shape)
            )
        fill = data["no_data_value"]
        if fill is not None and not np.any(values != fill):
            return None  # an all-nodata tile leaves no file behind

        directory = safe_abspath(spec.directory)
        os.makedirs(directory, exist_ok=True)
        height, width = values.shape[1:]
        if values.dtype == bool:
            values = values.astype(np.uint8)
        write_geotiff(
            os.path.join(directory, spec.stem + ".tif"),
            values,
            geo_transform=tuple(GeoTransform.from_bbox(spec.bbox, height, width)),
            projection=spec.projection,
            no_data_value=None if fill is None else float(fill),
            compress="deflate",
            tiled=True,
        )
        return None

    @staticmethod
    def merge_files(path, target):
        """Merge the sink's GeoTIFF tiles into a VRT file."""
        from dask_geomodeling_tpu_torch.io.vrt import build_vrt

        path = safe_abspath(path)
        target = safe_abspath(target)

        if os.path.exists(target):
            raise IOError("Target '{}' already exists".format(target))

        source_paths = glob.glob(os.path.join(path, "*.tif"))
        if len(source_paths) == 0:
            raise IOError("No source .tif files found in '{}'".format(path))

        build_vrt(target, sorted(source_paths))


RasterFileSink.process.torch_fetch_inputs = True


def to_file(source, url, tile_size, device=None, **request):
    """Export a RasterBlock to tiled GeoTIFFs merged into a VRT at ``url``;
    the subrequests run on ``device`` (see ``get_data``).

    Missing request fields (projection, bbox, width, height) default to the
    source raster's native values.
    """
    request = _native_request(source, request)

    path = safe_abspath(url)
    if os.path.isdir(path):
        path = os.path.join(path, "output.vrt")
    tiles_dir = os.path.join(os.path.split(path)[0], "tiles")

    tiler = RasterTiler(RasterFileSink(source, tiles_dir), tile_size)
    tiler.get_data(device=device, **request)

    RasterFileSink.merge_files(tiles_dir, path)


def to_cog(source, url, overviews=None, overview_resampling="nearest", device=None,
           **request):
    """Export a RasterBlock as a single cloud-optimized GeoTIFF: tiled
    pixel data, an overview pyramid (auto-generated unless ``overviews``
    decimation factors are given; ``overview_resampling`` "nearest" or the
    nodata-aware "average"), and every IFD at the head of the file.
    Missing request fields default to the source's native grid, as in
    :func:`to_file`; the request runs on ``device`` (see ``get_data``).
    """
    from dask_geomodeling_tpu_torch.io.geotiff import write_geotiff

    request = _native_request(source, request)
    path = safe_abspath(url)
    data = source.get_data(device=device, **request)
    if data is None or "values" not in data:
        raise ValueError("The source returned no data for this request")
    height, width = np.asarray(data["values"]).shape[1:]
    fill = data["no_data_value"]
    write_geotiff(
        path,
        np.asarray(data["values"]),
        geo_transform=tuple(GeoTransform.from_bbox(request["bbox"], height, width)),
        projection=request["projection"],
        no_data_value=None if fill is None else float(fill),
        compress="deflate",
        cog=True,
        overviews=overviews,
        overview_resampling=overview_resampling,
    )


def to_zarr(source, url, device=None, **request):
    """Export a RasterBlock as a consolidated Zarr v2 group store (the
    cloud-native xarray interchange layout; one chunk an array).  Missing
    request fields default to the source's native grid, as in
    :func:`to_cog`; the request runs on ``device`` (see ``get_data``)."""
    from dask_geomodeling_tpu_torch.io.zarr import write_zarr

    request = _native_request(source, request)
    path = safe_abspath(url)
    data = source.get_data(device=device, **request)
    if data is None or "values" not in data:
        raise ValueError("The source returned no data for this request")
    height, width = np.asarray(data["values"]).shape[1:]
    fill = data["no_data_value"]
    write_zarr(
        path,
        np.asarray(data["values"]),
        geo_transform=tuple(GeoTransform.from_bbox(request["bbox"], height, width)),
        projection=request["projection"],
        no_data_value=None if fill is None else float(fill),
    )


#: export request fields derivable from a source raster's native grid:
#: field -> (source attribute to derive from, derivation)
_NATIVE_FIELDS = (
    ("projection", "projection", lambda source: source.projection),
    ("bbox", "extent", lambda source: source.geometry.bounds),
)


def _native_request(source, overrides):
    """A full vals request: the source's native grid + user overrides;
    each derivation runs only when the user left its field out."""
    request = dict(overrides, mode="vals")
    for field, label, derive in _NATIVE_FIELDS:
        if field in request:
            continue
        try:
            derived = derive(source)
            if derived is None:
                raise ValueError(label)
        except (AttributeError, ValueError):
            raise ValueError(
                "Cannot determine the {} from the source raster. "
                "Please provide a '{}' argument.".format(label, field)
            )
        request[field] = derived
    if not ("width" in request and "height" in request):
        grid = source.geo_transform
        if grid is None:
            raise ValueError(
                "Cannot determine the pixel size from the source raster. "
                "Please provide 'width' and 'height' arguments."
            )
        x1, y1, x2, y2 = request["bbox"]
        request["width"] = int(round((x2 - x1) / abs(float(grid[1]))))
        request["height"] = int(round((y2 - y1) / abs(float(grid[5]))))
    return request
