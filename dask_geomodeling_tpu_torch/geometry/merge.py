"""Merging GeometryBlocks by index.

Counterpart of dask_geomodeling_tpu/geometry/merge.py, which calls
pandas' ``merge`` on the indexes with how in {left, right, inner, outer}
and column suffixes; the port's frame does the same without pandas
(geo/features.py:merge).  An extent request does the interval algebra of
boxes.  A host node: it runs its numpy process.
"""
from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.geo.features import merge
from dask_geomodeling_tpu_torch.geometry.base import GeometryBlock

__all__ = ["MergeGeometryBlocks"]


class MergeGeometryBlocks(GeometryBlock):
    """Merge two GeometryBlocks on their feature index.

    Args:
      left, right (GeometryBlock): blocks to merge
      how (str): 'left', 'right', 'inner' (default) or 'outer'
      suffixes (tuple of 2 str): appended to overlapping column names
    """

    allow_how_joins = ("left", "right", "outer", "inner")

    def __init__(self, left, right, how="inner", suffixes=("", "_right")):
        expect_instance(left, GeometryBlock, "left")
        expect_instance(right, GeometryBlock, "right")
        if how not in self.allow_how_joins:
            raise KeyError(
                "'{}' is not part of the list of operations: {}".format(
                    how, self.allow_how_joins
                )
            )
        if len(suffixes) != 2 or not all(isinstance(suffix, str) for suffix in suffixes):
            raise TypeError(
                "suffixes must be a pair of strings, got '%s'" % type(suffixes).__name__
            )
        super().__init__(left, right, how, tuple(suffixes))

    left = arg(0)
    right = arg(1)
    how = arg(2)
    suffixes = arg(3)

    @property
    def columns(self):
        mine, theirs = self.left.columns, self.right.columns
        shared = mine & theirs
        lsuf, rsuf = self.suffixes
        return (mine ^ theirs) | {name + suffix for name in shared for suffix in (lsuf, rsuf)}

    def get_sources_and_requests(self, **request):
        process_kwargs = {"how": self.how, "suffixes": self.suffixes, "mode": request["mode"]}
        return [(self.left, request), (self.right, request), (process_kwargs, None)]

    @staticmethod
    def process(left, right, kwargs):
        mode = kwargs["mode"]
        how = kwargs["how"]
        projection = left["projection"]

        if mode in ("intersects", "centroid"):
            merged = merge(left["features"], right["features"], how=how,
                           suffixes=kwargs["suffixes"])
            merged.crs = projection
            return {"features": merged, "projection": projection}
        if mode == "extent":
            if how == "left":
                return left
            if how == "right":
                return right
            if how == "inner":
                # interval algebra (not geometry ops): extents touching at
                # an edge or corner still intersect, as degenerate bboxes
                values = None
                if left["extent"] and right["extent"]:
                    lx1, ly1, lx2, ly2 = left["extent"]
                    rx1, ry1, rx2, ry2 = right["extent"]
                    x1, y1 = max(lx1, rx1), max(ly1, ry1)
                    x2, y2 = min(lx2, rx2), min(ly2, ry2)
                    if x1 <= x2 and y1 <= y2:
                        values = (x1, y1, x2, y2)
                return {"extent": values, "projection": projection}
            if how == "outer":
                values = None
                if left["extent"] and right["extent"]:
                    lx1, ly1, lx2, ly2 = left["extent"]
                    rx1, ry1, rx2, ry2 = right["extent"]
                    values = (min(lx1, rx1), min(ly1, ry1), max(lx2, rx2), max(ly2, ry2))
                elif left["extent"]:
                    values = left["extent"]
                elif right["extent"]:
                    values = right["extent"]
                return {"extent": values, "projection": projection}
        raise ValueError("Unknown mode '{}'".format(mode))
