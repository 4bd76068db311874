"""Geometry set operations: Difference and Intersection.

Counterpart of dask_geomodeling_tpu/geometry/set_operations.py.
Difference asks its source for its extent while planning (on the host,
``compute_metadata``) to scope the other's request, subtracts by index
label, and passes a geometry whose label the other lacks through
unchanged ("A minus nothing is A"); Intersection clips the features to
the request's geometry.  Host nodes: they run their numpy processes.
"""
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geo.geometry import box
from dask_geomodeling_tpu_torch.geometry.base import BaseSingle, GeometryBlock

__all__ = ["Difference", "Intersection"]


def _subtract_aligned(source_data, other_data):
    """Per-label difference; labels absent from ``other`` pass through."""
    minuend = source_data["features"]
    subtrahend = other_data["features"]
    if not len(minuend) or not len(subtrahend):
        return source_data

    left = minuend.geometry
    right = subtrahend.geometry.reindex(left.index)
    shrunk = left.difference(right)
    absent = right.isnull().values
    shrunk = shrunk.where(~absent, left)  # A - nothing = A
    return {
        "features": minuend.set_geometry(shrunk),
        "projection": source_data["projection"],
    }


class Difference(BaseSingle):
    """Subtract the same-index geometries of 'other' from 'source'."""

    def __init__(self, source, other):
        expect_instance(other, GeometryBlock, "other")
        super().__init__(source, other)

    other = arg(1)

    def get_sources_and_requests(self, **request):
        if request["mode"] == "extent":
            # the true extent could only shrink; computing that would mean
            # evaluating, so the source's extent is reported as it is
            return [(self.source, request)]

        # scope the other's request by the source's actual extent
        extent = self.source.get_data(**dict(request, mode="extent"))["extent"]
        if extent is None:
            empty = {"empty": True, "projection": request["projection"]}
            return [(empty, None)]

        scoped = dict(request, geometry=box(*extent))
        return [(self.source, request), (self.other, scoped)]

    @staticmethod
    def process(source_data, other_data=None):
        if other_data is not None:
            return _subtract_aligned(source_data, other_data)
        if source_data.get("empty"):
            return {
                "features": GeoDataFrame([]),
                "projection": source_data["projection"],
            }
        return source_data


class Intersection(BaseSingle):
    """Clip each feature to the request geometry."""

    def __init__(self, source, other=None):
        if other is not None:
            kind = (
                "another geometry datasource"
                if isinstance(other, GeometryBlock)
                else "a constant geometry"
            )
            raise NotImplementedError("Cannot compare geometries with %s" % kind)
        super().__init__(source, other)

    other = arg(1)

    def get_sources_and_requests(self, **request):
        return [(self.source, request), (request["geometry"], None)]

    @staticmethod
    def process(data, geometry):
        # features arrive already in the request geometry's projection
        if "features" in data:
            clipped = data["features"].geometry.intersection(geometry)
            return {
                "features": data["features"].set_geometry(clipped),
                "projection": data["projection"],
            }
        if "extent" in data:
            gx1, gy1, gx2, gy2 = geometry.bounds
            ex1, ey1, ex2, ey2 = data["extent"]
            clipped_bbox = (max(ex1, gx1), max(ey1, gy1), min(ex2, gx2), min(ey2, gy2))
            return {"extent": clipped_bbox, "projection": data["projection"]}
        return data
