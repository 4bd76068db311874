"""Geometry sinks: GeometryFileSink and the tiled ``to_file`` export.

Counterpart of dask_geomodeling_tpu/geometry/sinks.py, on the port's
pandas-free frame: per-request-hash files (the stem is the first 7
characters of the request's token, as in the JAX package, so both write
the same file names), JSON-serialized nested columns, GeoJSON
reprojection to EPSG:4326, ``merge_files`` gathering partials (their rows
concatenated, geo/features.py:concat).  The formats are GeoJSON,
GeoPackage, Shapefile, GML, FlatGeobuf, MapInfo MIF/MID (the .mid
travels with its .mif), SpatiaLite and TopoJSON (io/vectorfile.py);
GeoParquet raises NotImplementedError naming the module that writes it.
"""
import glob
import json
import os
import shutil
import tempfile
from collections import namedtuple
from contextlib import contextmanager

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.core.tokens import tokenize
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, Series, concat
from dask_geomodeling_tpu_torch.geo.geometry import box
from dask_geomodeling_tpu_torch.geo.safefiles import safe_abspath, safe_file_url
from dask_geomodeling_tpu_torch.geometry.base import BaseSingle
from dask_geomodeling_tpu_torch.geometry.parallelize import GeometryTiler

__all__ = ["GeometryFileSink", "to_file"]

#: output format registry: extension -> (driver label, per-format rules);
#: "force_crs" reprojects before writing (GeoJSON is 4326 by spec)
_FORMATS = {
    "geojson": ("GeoJSON", {"force_crs": "EPSG:4326"}),
    "gpkg": ("GPKG", {}),
    "shp": ("ESRI Shapefile", {}),
    "gml": ("GML", {}),
    "fgb": ("FlatGeobuf", {}),
    "mif": ("MapInfo MIF/MID", {}),
    "sqlite": ("SpatiaLite", {}),
    # TopoJSON is a GeoJSON sibling: geographic coordinates by convention
    "topojson": ("TopoJSON", {"force_crs": "EPSG:4326"}),
}

#: the JAX package's other sink formats, which the port does not write
_UNPORTED_FORMATS = ("parquet",)

#: everything one partial-file write needs, planned at request-rewrite time
_FeatureWriteSpec = namedtuple(
    "_FeatureWriteSpec", ["directory", "fields", "extension", "stem"]
)


_SIDECAR_EXTENSIONS = (".mid", ".shx", ".dbf", ".prj", ".cpg")


def _sidecar_pairs(source, target):
    """Existing (source sidecar, target sidecar) path pairs for formats
    whose attributes travel in companion files."""
    source_base, _ = os.path.splitext(source)
    target_base, _ = os.path.splitext(target)
    return [
        (source_base + ext, target_base + ext)
        for ext in _SIDECAR_EXTENSIONS
        if os.path.exists(source_base + ext)
    ]


def _normalize_extension(extension):
    """A registry key from user input ('.gpkg' and 'gpkg' both work)."""
    from dask_geomodeling_tpu_torch.io.vectorfile import _format_of

    expect_instance(extension, str, "extension")
    key = extension.lstrip(".")
    if key in _UNPORTED_FORMATS:
        _format_of("partial." + key)  # raises, naming the JAX module
    if key not in _FORMATS:
        raise ValueError("Format '{}' is unsupported".format(key))
    return key


def _field_mapping(fields, columns):
    """The {output name: source column} mapping, defaulting to identity
    over every non-geometry column."""
    if fields is None:
        return {name: name for name in columns if name != "geometry"}
    expect_instance(fields, dict, "fields")
    missing = set(fields.values()) - set(columns)
    if missing:
        raise ValueError("Columns {} are not available".format(missing))
    return fields


def _export_series(gdf, column, index_name):
    """One output column's data: a frame column, or the index by name."""
    if column == index_name and column not in gdf.columns:
        return Series(gdf.index.values, index=gdf.index)
    return gdf[column]


def _writable_values(series):
    """File-format-safe values: nested objects JSON-encoded — one pass
    per column.  (The JAX package also decays a pandas categorical to its
    categories' dtype; the port's frame has no categorical column, and
    Classify's result is already cast to its labels' dtype.)"""

    def encode(value):
        if isinstance(value, (list, dict)):
            try:
                return json.dumps(value)
            except TypeError:
                return "<unable to export>"
        return value

    if series.dtype == object:
        series = series.map(encode)
    return series


class GeometryFileSink(BaseSingle):
    """Write feature data to hash-named files in a directory.

    Args:
      source (GeometryBlock): block the data comes from
      url (str): target directory (relative to ``geomodeling.root``)
      extension (str): output format; see ``supported_extensions``
      fields (dict): {output field name: column name} mapping
    """

    supported_extensions = {key: spec[0] for key, spec in _FORMATS.items()}

    def __init__(self, source, url, extension="geojson", fields=None):
        super().__init__(
            source,
            safe_file_url(url),
            _normalize_extension(extension),
            _field_mapping(fields, source.columns),
        )

    url = arg(1, "sandboxed target directory URL")
    extension = arg(2, "output format key")
    fields = arg(3, "output-name to column-name mapping")

    @property
    def columns(self):
        return {"saved"}

    def get_sources_and_requests(self, **request):
        spec = _FeatureWriteSpec(
            directory=self.url,
            fields=self.fields,
            extension=self.extension,
            stem=tokenize(request)[:7],
        )
        return [(self.source, request), (spec, None)]

    @staticmethod
    def process(data, spec):
        from dask_geomodeling_tpu_torch.io.vectorfile import write_vector

        if "features" not in data or len(data["features"]) == 0:
            return data
        spec = _FeatureWriteSpec(*spec)
        projection = data["projection"]
        source = data["features"]

        # assemble the output frame column by column (format-safe values)
        frame = GeoDataFrame(
            index=source.index,
            geometry=list(source.geometry),
            crs=projection,
        )
        for name, column in spec.fields.items():
            frame[name] = _writable_values(
                _export_series(source, column, source.index.name)
            )

        rules = _FORMATS[spec.extension][1]
        forced = rules.get("force_crs")
        if forced and projection.upper() != forced:
            frame = frame.to_crs(forced)

        directory = safe_abspath(spec.directory)
        os.makedirs(directory, exist_ok=True)
        write_vector(
            frame,
            os.path.join(directory, spec.stem + "." + spec.extension),
        )

        saved = GeoDataFrame(index=source.index)
        saved["saved"] = True
        return {"features": saved, "projection": projection}

    @staticmethod
    def merge_files(path, target, remove_source=False):
        """Merge the sink's partial files into one file."""
        from dask_geomodeling_tpu_torch.io.vectorfile import read_vector, write_vector

        path = safe_abspath(path)
        target = safe_abspath(target)

        if os.path.exists(target):
            raise IOError("Target '{}' already exists".format(target))

        ext = os.path.splitext(target)[1]
        partials = sorted(glob.glob(os.path.join(path, "*" + ext)))
        if not partials:
            raise IOError(
                "No source files found with matching extension '{}'".format(ext)
            )

        if len(partials) == 1:
            transfer = shutil.move if remove_source else shutil.copy
            transfer(partials[0], target)
            # formats with attribute/CRS sidecars (MIF's .mid, .prj)
            # travel as a file family
            for source_sidecar, target_sidecar in _sidecar_pairs(
                partials[0], target
            ):
                transfer(source_sidecar, target_sidecar)
        else:
            frames = [read_vector(partial) for partial in partials]
            merged = concat(frames)
            merged.crs = frames[0].crs
            merged._geometry_column_name = "geometry"
            write_vector(merged, target)
            if remove_source:
                for partial in partials:
                    os.remove(partial)
                    for source_sidecar, _ in _sidecar_pairs(partial, target):
                        os.remove(source_sidecar)
        if remove_source:
            try:
                os.rmdir(path)
            except OSError:
                pass  # directory not empty: other extensions remain


@contextmanager
def DryRunTempDir(*args, **kwargs):
    """Stand-in temporary directory that never touches the filesystem."""
    yield "/tmp/dummy"


def to_file(source, url, fields=None, tile_size=None, dry_run=False, device=None,
            **request):
    """Export a GeometryBlock to a file; optionally tiled via GeometryTiler.

    Args:
      source (GeometryBlock): block the data comes from
      url (str): target path; extension selects the format
      fields (dict): output field mapping
      tile_size (float): optional tiling size (projection units)
      dry_run (bool): only validate the arguments
      device: where the request's twins run (see ``get_data``)
      **request: geometry request fields (mode defaults to 'centroid')
    """
    request.setdefault("mode", "centroid")
    if "geometry" not in request:
        extent = source.get_data(
            mode="extent", projection=request["projection"]
        )["extent"]
        request["geometry"] = box(*extent)

    path = safe_abspath(url)
    extension = os.path.splitext(path)[1]

    TmpDir = DryRunTempDir if dry_run else tempfile.TemporaryDirectory
    with TmpDir(dir=config.get("temporary_directory", None)) as tmpdir:
        sink = GeometryFileSink(source, tmpdir, extension=extension, fields=fields)

        if tile_size is not None:
            sink = GeometryTiler(sink, tile_size, request["projection"])

        if dry_run:
            return

        sink.get_data(device=device, **request)
        GeometryFileSink.merge_files(tmpdir, path)
