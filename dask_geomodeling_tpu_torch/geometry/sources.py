"""Geometry sources: GeometryFileSource and GeometryWKTSource.

Counterpart of dask_geomodeling_tpu/geometry/sources.py, on the port's
pandas-free frame: bbox-prefiltered file reads, FID-or-custom index,
equality filters, CRS conversion, min_size filtering, centroid-vs-
intersects predicates and limit enforcement (``geomodeling.geometry-
limit``).  Above ``geomodeling.vector-windowed-read-limit`` bytes, a
FlatGeobuf file with a packed R-tree and a GeoPackage that carries a
``gpkg_rtree_index`` answer the request's bbox (transformed into the
file's CRS) through their index and decode only the features it finds;
any other file is parsed whole once into the read cache
(runtime/pipeline.py); a format the port does not read (GeoParquet)
raises there, naming the JAX module that reads it.
"""
import os

from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo import (
    TransformException,
    WKTReadingError,
    get_sr,
    shapely_from_wkt,
    shapely_transform,
    transform_extent,
)
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geo.safefiles import safe_abspath, safe_file_url
from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock

__all__ = ["GeometryFileSource", "GeometryWKTSource"]


class GeometryFileSource(GeometryBlock):
    """A geometry source reading a vector file from disk.

    Args:
      url (str): path to the file, sandboxed by ``geomodeling.root``
      layer (str, optional): layer name (GeoPackage, SpatiaLite, TopoJSON;
        GPX's waypoints/routes/tracks, OSM's points/lines/multipolygons,
        a zipped dataset's stem); default the first layer, or all layers
        of a GPX or OSM file
      id_field (str, optional): column to use as the feature index when the
        file has no built-in FID
    """

    def __init__(self, url, layer=None, id_field=None):
        safe_url = safe_file_url(url)
        super().__init__(safe_url, layer, id_field)

    url = arg(0)
    layer = arg(1)
    id_field = arg(2)

    @property
    def path(self):
        return safe_abspath(self.url)

    @property
    def columns(self):
        from dask_geomodeling_tpu_torch.io.vectorfile import read_vector_info

        info = read_vector_info(self.path, layer=self.layer)
        return set(info["fields"]) | {"geometry"}

    def get_sources_and_requests(self, **request):
        filters = request.get("filters") or {}
        unsupported = [field for field in filters if "__" in field]
        if unsupported:
            raise ValueError(
                "Filter '{}' is not supported".format(unsupported[0])
            )
        mode = request.get("mode", "intersects").lower()
        if mode not in ("extent", "intersects", "centroid"):
            raise ValueError("Unknown mode '{}'".format(mode))
        request.update(
            filters=filters, mode=mode, layer=self.layer,
            id_field=self.id_field,
        )
        return [(self.url, None), (request, None)]

    # the read is a pipeline of pure frame filters; each stage below is
    # independently testable and shared between modes

    @staticmethod
    def _above_vector_limit(path):
        """True when the file is large enough that per-request indexed
        reads beat the parse-whole-once LRU."""
        limit = config.get("geomodeling.vector-windowed-read-limit")
        if limit is None:
            return False
        try:
            return os.path.getsize(path) > int(limit)
        except OSError:
            return False

    @staticmethod
    def _fgb_above_limit(path):
        """Like :meth:`_above_vector_limit`, plus the .fgb must carry a
        spatial index."""
        if not GeometryFileSource._above_vector_limit(path):
            return False
        from dask_geomodeling_tpu_torch.io.flatgeobuf import header_index_node_size

        try:
            with open(path, "rb") as stream:
                head = stream.read(1 << 16)
            return bool(header_index_node_size(head))
        except Exception:
            return False

    @staticmethod
    def _gpkg_has_rtree(path, layer):
        from dask_geomodeling_tpu_torch.io.vectorfile import gpkg_rtree_name

        return gpkg_rtree_name(path, layer) is not None

    @staticmethod
    def _bbox_prefilter(f, filt_geom, projection):
        """Keep features whose bounds touch the filter bbox (file CRS)."""
        bbox = filt_geom.bounds
        if f.crs and f.crs.upper() != projection.upper():
            bbox = transform_extent(bbox, projection, f.crs)
        bounds = f.geometry.bounds
        keep = ~(
            (bounds["maxx"] < bbox[0])
            | (bounds["minx"] > bbox[2])
            | (bounds["maxy"] < bbox[1])
            | (bounds["miny"] > bbox[3])
        )
        return f[keep.values]

    @staticmethod
    def _attribute_filter(f, filters):
        """Equality filters ANDed over attribute columns."""
        mask = None
        for field, value in filters.items():
            if field not in f.columns:
                continue
            term = f[field] == value
            mask = term if mask is None else (mask & term)
        return f if mask is None else f[mask.values]

    @staticmethod
    def _size_filter(f, min_size):
        """Drop features smaller than min_size in both dimensions."""
        bounds = f.geometry.bounds
        widths = bounds["maxx"] - bounds["minx"]
        heights = bounds["maxy"] - bounds["miny"]
        return f[((widths > min_size) | (heights > min_size)).values]

    @staticmethod
    def _predicate_filter(f, filt_geom, mode):
        if mode == "centroid":
            return f[f.geometry.centroid.within(filt_geom).values]
        return f[f.geometry.intersects(filt_geom).values]

    @staticmethod
    def _enforce_limit(f, limit):
        if limit:
            return f.iloc[:limit]
        if limit is None:
            ceiling = config.get("geomodeling.geometry-limit")
            if len(f) > ceiling:
                raise RuntimeError(
                    "The amount of returned geometries exceeded "
                    "the maximum of {} geometries.".format(ceiling)
                )
        return f

    @staticmethod
    def process(url, request):
        from dask_geomodeling_tpu_torch.runtime.pipeline import read_vector_cached

        projection = request["projection"]
        mode = request["mode"]
        filt_geom = request.get("geometry")

        path = safe_abspath(url)
        lower = path.lower()
        if (
            filt_geom is not None
            and lower.endswith(".fgb")
            and GeometryFileSource._fgb_above_limit(path)
        ):
            # large FlatGeobuf: search the packed R-tree and decode only
            # the features the filter bbox touches (the format's
            # random-access design) instead of parsing the whole file
            from dask_geomodeling_tpu_torch.io.flatgeobuf import read_flatgeobuf

            f = read_flatgeobuf(
                path, bbox=filt_geom.bounds, bbox_projection=projection
            )
        elif (
            filt_geom is not None
            and lower.endswith(".gpkg")
            and GeometryFileSource._above_vector_limit(path)
            and GeometryFileSource._gpkg_has_rtree(path, request["layer"])
        ):
            # large GeoPackage WITH a gpkg_rtree_index: the index answers
            # the bbox; index-less files keep the parse-once LRU below
            from dask_geomodeling_tpu_torch.io.vectorfile import _read_gpkg

            f = _read_gpkg(
                path, layer=request["layer"], bbox=filt_geom.bounds,
                bbox_projection=projection,
            )
            f = GeometryFileSource._bbox_prefilter(f, filt_geom, projection)
        else:
            # the cache hands back a shared frame; the copy keeps
            # attribute writes (crs below) off the cached object
            f = read_vector_cached(path, layer=request["layer"]).copy()
            if filt_geom is not None and len(f):
                f = GeometryFileSource._bbox_prefilter(
                    f, filt_geom, projection
                )

        if len(f) == 0:
            if mode == "extent":
                return {"projection": projection, "extent": None}
            return {"projection": projection, "features": GeoDataFrame([])}

        if request["id_field"] is not None:
            f = f.set_index(request["id_field"])
        f = GeometryFileSource._attribute_filter(f, request["filters"])
        if f.crs is None:
            # CRS-less formats (e.g. CSV/WKT) are taken to already be in
            # the requested projection, like OGR sources without an SRS
            f.crs = projection
        f = f.to_crs(projection)
        if request.get("min_size") and len(f):
            f = GeometryFileSource._size_filter(f, request["min_size"])
        if filt_geom is not None and len(f):
            f = GeometryFileSource._predicate_filter(f, filt_geom, mode)

        if mode == "extent":
            extent = tuple(f.geometry.total_bounds) if len(f) else None
            return {"projection": projection, "extent": extent}
        f = GeometryFileSource._enforce_limit(f, request.get("limit"))
        return {"projection": projection, "features": f}


class GeometryWKTSource(GeometryBlock):
    """A single WKT geometry as a geometry source."""

    def __init__(self, wkt, projection):
        expect_instance(wkt, str, "wkt")
        expect_instance(projection, str, "projection")
        try:
            shapely_from_wkt(wkt)
        except WKTReadingError:
            raise ValueError("The provided geometry is not a valid WKT")
        try:
            get_sr(projection)
        except (TypeError, TransformException):
            raise ValueError("The provided projection is not valid")
        super().__init__(wkt, projection)

    wkt = arg(0)
    projection = arg(1)

    @property
    def columns(self):
        return {"geometry"}

    def get_sources_and_requests(self, **request):
        data = {"wkt": self.wkt, "projection": self.projection}
        return [(data, None), (request, None)]

    @staticmethod
    def process(data, request):
        mode = request["mode"]
        if mode not in ("extent", "intersects", "centroid"):
            raise ValueError("Unknown mode '{}'".format(mode))

        geometry = shapely_from_wkt(data["wkt"])
        if data["projection"] != request["projection"]:
            geometry = shapely_transform(geometry, data["projection"], request["projection"])

        def empty():
            return {
                "projection": request["projection"],
                "features": GeoDataFrame([]),
            }

        f = GeoDataFrame(geometry=[geometry], crs=request["projection"])

        min_size = request.get("min_size")
        if min_size:
            minx, miny, maxx, maxy = geometry.bounds
            if (maxy - miny) < min_size or (maxx - minx) < min_size:
                return empty()

        if mode == "intersects":
            if not geometry.intersects(request["geometry"]):
                return empty()
            return {"features": f, "projection": request["projection"]}
        if mode == "centroid":
            if not geometry.centroid.intersects(request["geometry"]):
                return empty()
            return {"features": f, "projection": request["projection"]}
        # extent
        if not geometry.intersects(request["geometry"]):
            return {"projection": request["projection"], "extent": None}
        return {
            "extent": tuple(geometry.bounds),
            "projection": request["projection"],
        }
