"""GeometryWKTSource: a single WKT geometry as a geometry source.

Counterpart of dask_geomodeling_tpu/geometry/sources.py:241-308.  Its
GeometryFileSource waits for the vector readers (io/ there), which the
port does not have.
"""
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo import (
    WKTReadingError,
    get_sr,
    shapely_from_wkt,
    shapely_transform,
)
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock

__all__ = ["GeometryWKTSource"]


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
        except (TypeError, ValueError):
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
