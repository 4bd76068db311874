"""Series derived from the geometry field itself: Area.

Counterpart of dask_geomodeling_tpu/geometry/geom_operations.py — the
area is computed after transforming into the requested projection (an
equal-area CRS gives physical areas; the request CRS may not).
"""
import numpy as np

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import Series
from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock, SeriesBlock

__all__ = ["Area"]

_EMPTY = Series(np.empty(0))


class Area(SeriesBlock):
    """The area of each feature, computed in the given projection."""

    def __init__(self, source, projection):
        expect_instance(source, GeometryBlock, "source")
        if not isinstance(projection, str):
            raise TypeError("Argument 'projection' must be a str.")
        super().__init__(source, projection)

    source = arg(0)
    projection = arg(1)

    @staticmethod
    def process(data, projection):
        frame = data.get("features")
        if frame is None or not len(frame):
            return _EMPTY.copy()
        shapes = frame.geometry
        shapes.crs = data["projection"]
        return shapes.to_crs(projection).area
