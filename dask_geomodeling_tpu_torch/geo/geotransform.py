"""GeoTransform and Extent: the affine pixel-to-world foundation
(counterparts of dask_geomodeling_tpu/geo/geotransform.py).

A GDAL-style 6-tuple ``(p, a, b, q, c, d)`` maps array indices ``(i, j)``
to projected coordinates ``x = p + a*j + b*i``, ``y = q + c*j + d*i``.
Tilted transforms are rejected.  An Extent is a bbox with its spatial
reference; ``as_geometry`` and ``from_geometry`` pass it to and from a
box Polygon that carries its ``srs`` (a raster Block's ``geometry``).
"""
import math

import numpy as np

from dask_geomodeling_tpu_torch.geo.dtypes import get_rounded_repr

__all__ = ["GeoTransform", "Extent"]


class GeoTransform(tuple):
    """Affine pixel-to-world mapping as used by GDAL, with helpers."""

    def __init__(self, tpl):
        if len(tpl) != 6:
            raise ValueError("GeoTransform expected an iterable of length 6")
        if not all(math.isclose(tpl[i], 0.0, abs_tol=1e-7) for i in (2, 4)):
            raise ValueError("Tilted geo_transforms are not supported")
        if any(math.isclose(tpl[i], 0.0, abs_tol=1e-7) for i in (1, 5)):
            raise ValueError("Pixel size should not be zero")

    @classmethod
    def from_bbox(cls, bbox, height, width):
        x1, y1, x2, y2 = bbox
        return cls((x1, (x2 - x1) / width, 0, y2, 0, (y1 - y2) / height))

    def __repr__(self):
        return get_rounded_repr(tuple(self))

    @property
    def cell_area(self):
        p, a, b, q, c, d = self
        return abs(a * d - b * c)

    @property
    def origin(self):
        """(x, y) coordinate of pixel (0, 0)."""
        return self[0], self[3]

    @property
    def origin_normalized(self):
        """(x, y) of the grid line closest to the coordinate origin."""
        return self[0] % self[1], self[3] % self[5]

    def get_inverse(self):
        """2x2 matrix of the inverse affine (no translation)."""
        _, a, b, _, c, d = self
        det = 1.0 / (a * d - b * c)
        return d * det, -b * det, -c * det, a * det

    def scale(self, x, y):
        """Scale the pixel size by (x, y), keeping the origin."""
        p, a, b, q, c, d = self
        return type(self)([p, a * x, b * x, q, c * y, d * y])

    def shift(self, origin):
        """Shift the origin to integer pixel coordinates ``(i, j)``."""
        p, a, b, q, c, d = self
        i, j = origin
        return type(self)([p + a * j + b * i, a, b, q + c * j + d * i, c, d])

    def _pixel_coords(self, x, y):
        """Fractional (col, row) pixel coordinates of world (x, y)."""
        p, _, _, q, _, _ = self
        e, f, g, h = self.get_inverse()
        dx, dy = x - p, y - q
        return e * dx + f * dy, g * dx + h * dy

    def get_indices(self, points):
        """Pixel indices (i, j) for N x 2 world points, as linear arrays."""
        x, y = np.asarray(points).transpose()
        col, row = self._pixel_coords(x, y)
        return (
            np.floor(row).astype(np.int64),
            np.floor(col).astype(np.int64),
        )

    def get_points(self, indices):
        """World coordinates (N x 2) for N x 2 integer indices (i, j)."""
        p, a, b, q, c, d = self
        i, j = indices.transpose()
        points = np.empty(indices.shape)
        points[:, 0] = p + a * j + b * i
        points[:, 1] = q + c * j + d * i
        return points

    def get_bbox(self, offset, shape):
        """Bbox covered by a subarray at ``offset`` with ``shape``."""
        _, a, b, _, c, d = self
        m, n = shape
        west, north = self.shift(offset).origin
        east = west + a * n + b * m
        south = north + c * n + d * m
        return west, south, east, north

    def get_indices_for_bbox(self, bbox):
        """((i1, i2), (j1, j2)) array index ranges covering ``bbox``."""
        x1, y1, x2, y2 = bbox
        # the NW and SE bbox corners in fractional pixel space
        col_nw, row_nw = self._pixel_coords(x1, y2)
        col_se, row_se = self._pixel_coords(x2, y1)
        cols = sorted((int(math.floor(col_nw)), int(math.floor(col_se))))
        rows = sorted((int(math.floor(row_nw)), int(math.floor(row_se))))
        return tuple(rows), tuple(cols)

    def get_array_ranges(self, bbox, shape):
        """Slices and paddings needed to extract ``bbox`` from an array of
        ``shape`` (bands, height, width).

        Returns ``(((i1, i2), (j1, j2)), padding_or_None)`` where padding is
        ``((before_i, after_i), (before_j, after_j))``.
        """
        ranges, padding, outside = [], [], False
        for (lo, hi), size in zip(self.get_indices_for_bbox(bbox), shape[1:]):
            if lo == hi:
                hi += 1  # point request: keep the index range non-empty
            in_lo, in_hi = np.clip([lo, hi], 0, size)
            ranges.append((in_lo, in_hi))
            pad = (hi - lo, 0) if in_lo == in_hi else (in_lo - lo, hi - in_hi)
            padding.append(pad)
            outside = outside or pad[0] > 0 or pad[1] > 0
        return tuple(ranges), tuple(padding) if outside else None

    def aligns_with(self, other):
        """True if the other transform has the same resolution and the grid
        lines coincide (normalized origins match)."""
        if not isinstance(other, GeoTransform):
            other = GeoTransform(other)
        if abs(self[1]) != abs(other[1]) or abs(self[5]) != abs(other[5]):
            return False
        return self.origin_normalized == other.origin_normalized


class Extent:
    """A bounding box that knows its spatial reference."""

    def __init__(self, bbox, sr):
        from dask_geomodeling_tpu_torch.geo.crs import get_projection

        self.bbox = tuple(bbox)
        self.srs = get_projection(sr)

    @property
    def sr(self):
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        return get_sr(self.srs)

    def __repr__(self):
        return "<{}: {} / {}>".format(
            type(self).__name__, self.srs, get_rounded_repr(self.bbox)
        )

    def __eq__(self, other):
        return (
            isinstance(other, Extent)
            and self.bbox == other.bbox
            and self.srs == other.srs
        )

    def __hash__(self):
        return hash((self.bbox, self.srs))

    @property
    def width(self):
        return self.bbox[2] - self.bbox[0]

    @property
    def height(self):
        return self.bbox[3] - self.bbox[1]

    @classmethod
    def from_geometry(cls, geometry):
        """Build from a Geometry that carries its own ``srs``."""
        return cls(bbox=geometry.bounds, sr=geometry.srs)

    def as_geometry(self):
        """Return a Polygon geometry carrying this extent's srs."""
        from dask_geomodeling_tpu_torch.geo.geometry import box

        geom = box(*self.bbox)
        geom.srs = self.srs
        return geom

    def buffered(self, size):
        x1, y1, x2, y2 = self.bbox
        return type(self)((x1 - size, y1 - size, x2 + size, y2 + size), self.srs)

    def transformed(self, sr):
        from dask_geomodeling_tpu_torch.geo.crs import get_projection, transform_extent

        srs = get_projection(sr)
        if self.srs.upper() == srs.upper():
            return self
        return Extent(bbox=transform_extent(self.bbox, self.srs, srs), sr=srs)

    def union(self, other):
        """Union of self and other, in the SRS of self."""
        a = self.bbox
        b = other.transformed(self.srs).bbox
        return Extent(
            (min(a[0], b[0]), min(a[1], b[1]), max(a[2], b[2]), max(a[3], b[3])),
            self.srs,
        )

    def intersection(self, other):
        """Intersection in the SRS of self, or None if it has no area."""
        a = self.bbox
        b = other.transformed(self.srs).bbox
        result = Extent(
            (max(a[0], b[0]), max(a[1], b[1]), min(a[2], b[2]), min(a[3], b[3])),
            self.srs,
        )
        if result.width > 0 and result.height > 0:
            return result
        return None
