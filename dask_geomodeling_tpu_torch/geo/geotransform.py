"""GeoTransform and Extent, as far as the port's paths use them
(counterparts of dask_geomodeling_tpu/geo/geotransform.py).

A GDAL-style 6-tuple ``(p, a, b, q, c, d)`` maps array indices ``(i, j)``
to projected coordinates ``x = p + a*j + b*i``, ``y = q + c*j + d*i``.
Tilted transforms are rejected.
"""
import math

import numpy as np

__all__ = ["GeoTransform", "Extent"]


class GeoTransform(tuple):
    """Affine pixel-to-world mapping as used by GDAL."""

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

    def shift(self, origin):
        """Shift the origin to integer pixel coordinates ``(i, j)``."""
        p, a, b, q, c, d = self
        i, j = origin
        return type(self)([p + a * j + b * i, a, b, q + c * j + d * i, c, d])

    def get_indices(self, points):
        """Pixel indices (i, j) for N x 2 world points, as linear arrays."""
        x, y = np.asarray(points).transpose()
        p, _, _, q, _, _ = self
        e, f, g, h = self.get_inverse()
        dx, dy = x - p, y - q
        col, row = e * dx + f * dy, g * dx + h * dy
        return (
            np.floor(row).astype(np.int64),
            np.floor(col).astype(np.int64),
        )

    def get_bbox(self, offset, shape):
        """Bbox covered by a subarray at ``offset`` with ``shape``."""
        _, a, b, _, c, d = self
        m, n = shape
        west, north = self.shift(offset).origin
        east = west + a * n + b * m
        south = north + c * n + d * m
        return west, south, east, north

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

    def transformed(self, sr):
        from dask_geomodeling_tpu_torch.geo.crs import get_projection, transform_extent

        srs = get_projection(sr)
        if self.srs.upper() == srs.upper():
            return self
        return Extent(bbox=transform_extent(self.bbox, self.srs, srs), sr=srs)

    @property
    def width(self):
        return self.bbox[2] - self.bbox[0]

    @property
    def height(self):
        return self.bbox[3] - self.bbox[1]

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
