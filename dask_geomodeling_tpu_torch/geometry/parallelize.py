"""Geometry request tiling.

Counterpart of dask_geomodeling_tpu/geometry/parallelize.py: the request
geometry is covered by a grid of at-most-``size`` boxes in a chosen
projection, every tile is clipped to the requested geometry with the
planar overlay (geo/_overlay.py; empty tiles are skipped), and the
per-tile frames concatenate (geo/features.py:concat). Only 'centroid'
mode is tiled — it guarantees each feature lands in exactly one tile (a
centroid on a shared tile edge is within neither, as in the JAX package)
— and 'extent' passes through.
"""
from math import ceil

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo import shapely_transform
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, concat
from dask_geomodeling_tpu_torch.geo.geometry import box
from dask_geomodeling_tpu_torch.geometry.base import BaseSingle

__all__ = ["GeometryTiler"]


def _cover_with_boxes(geometry, size):
    """At-most-``size`` boxes covering ``geometry``, equalized so the grid
    divides the bounds exactly; boxes not touching the geometry drop out."""
    min_x, min_y, max_x, max_y = geometry.bounds
    n_cols = ceil((max_x - min_x) / size)
    n_rows = ceil((max_y - min_y) / size)
    if n_cols <= 1 and n_rows <= 1:
        return None  # no tiling needed
    step_x = (max_x - min_x) / n_cols
    step_y = (max_y - min_y) / n_rows
    pieces = []
    for col in range(n_cols):
        for row in range(n_rows):
            tile = box(
                min_x + step_x * col,
                min_y + step_y * row,
                min_x + step_x * (col + 1),
                min_y + step_y * (row + 1),
            ).intersection(geometry)
            if not tile.is_empty:
                pieces.append(tile)
    return pieces


class GeometryTiler(BaseSingle):
    """Tile geometry requests into boxes of at most ``size``.

    Args:
      source (GeometryBlock): source block
      size (float): maximum tile size in projection units
      projection (str): the projection the tiling happens in

    Only 'centroid' and 'extent' request modes are supported.
    """

    def __init__(self, source, size, projection):
        expect_instance(projection, str, "projection")
        super().__init__(source, float(size), projection)

    size = arg(1)
    projection = arg(2)

    def get_sources_and_requests(self, **request):
        mode = request["mode"]
        if mode == "extent":
            return [(self.source, request)]
        if mode != "centroid":
            raise NotImplementedError("Cannot process '{}' mode".format(mode))

        geometry = shapely_transform(
            request["geometry"], request["projection"], self.projection
        )
        pieces = _cover_with_boxes(geometry, self.size)
        if pieces is None:
            return [(self.source, request)]

        tiled = dict(request, projection=self.projection)
        return [
            (self.source, dict(tiled, geometry=piece)) for piece in pieces
        ]

    @staticmethod
    def process(*partials):
        if len(partials) == 0:
            return {"features": GeoDataFrame([]), "projection": None}
        if len(partials) == 1:
            return partials[0]  # untiled or extent requests
        frames = [
            part["features"]
            for part in partials
            if part is not None and len(part.get("features")) != 0
        ]
        if not frames:
            merged = GeoDataFrame([])
        elif len(frames) == 1:
            merged = frames[0]
        else:
            merged = concat(frames)
        return {"features": merged, "projection": partials[0]["projection"]}
