"""Planar geometry engine: the types, predicates, measures and WKT/WKB the
port's geometry side uses.

Counterpart of dask_geomodeling_tpu/geo/geometry.py, copied so that it
gives the same float64 bits:

- types: Point, MultiPoint, LineString, MultiLineString, Polygon,
  MultiPolygon, GeometryCollection; ``box()`` and ``shape()``
- predicates: intersects, within, contains, disjoint, equals, is_valid
- measures: area, length, bounds, centroid, distance
- operations: intersection, union and difference (the planar overlay,
  geo/_overlay.py), simplify (Douglas-Peucker) and convex_hull
- WKT and WKB (ISO little-endian) serialization (geo/_wkt.py);
  ``__geo_interface__``

``buffer`` (the JAX package's geo/_buffer.py) is not ported: it raises
NotImplementedError naming the module.

Geometries are immutable value objects; an optional ``srs`` attribute tags
the coordinate system.
"""
import math

import numpy as np

__all__ = [
    "Geometry",
    "Point",
    "MultiPoint",
    "LineString",
    "MultiLineString",
    "Polygon",
    "MultiPolygon",
    "GeometryCollection",
    "box",
    "shape",
    "from_wkt",
    "from_wkb",
    "transform",
    "WKTReadingError",
]

_EPS = 1e-12


class WKTReadingError(Exception):
    """Raised when WKT/WKB input cannot be parsed."""
    pass


def _coords(arr):
    arr = np.asarray(arr, dtype=float)
    if arr.ndim == 1:
        arr = arr.reshape(1, -1)
    if arr.shape[-1] < 2:
        raise ValueError("Coordinates must be 2-dimensional")
    return np.ascontiguousarray(arr[:, :2])


def _close_ring(arr):
    if len(arr) and not np.array_equal(arr[0], arr[-1]):
        arr = np.vstack([arr, arr[:1]])
    return arr


def _ring_area(ring):
    """Signed area (positive = counter-clockwise).

    Anchored at the first vertex: signed area is translation-invariant,
    and shifting makes the shoelace terms feature-sized instead of
    coordinate-sized — at projected-CRS offsets of ~1e7 the raw shoelace
    loses ~1e-1 absolute precision per ring, swamping small features.
    """
    x = ring[:, 0] - ring[0, 0]
    y = ring[:, 1] - ring[0, 1]
    return 0.5 * float(np.sum(x[:-1] * y[1:] - x[1:] * y[:-1]))


def _point_in_ring(px, py, ring):
    """Even-odd (crossing number) point-in-ring test; boundary = unspecified."""
    x, y = ring[:-1, 0], ring[:-1, 1]
    x2, y2 = ring[1:, 0], ring[1:, 1]
    crossing = ((y > py) != (y2 > py)) & (
        px < (x2 - x) * (py - y) / np.where(y2 == y, np.inf, y2 - y) + x
    )
    return bool(np.count_nonzero(crossing) % 2)


def _ring_is_simple(ring):
    """True when the closed ring has no self-intersections: non-adjacent
    segments neither cross nor touch, adjacent segments meet only at their
    shared endpoint (no spikes), and no vertex repeats (except closure)."""
    n = len(ring) - 1  # segment count
    if n < 3:
        return False
    pts = ring[:-1]
    # duplicate vertices (other than the closure) collapse segments
    if len(np.unique(pts, axis=0)) != n:
        return False
    a, b = ring[:-1], ring[1:]
    d = b - a
    for i in range(n - 1):
        # test segment i against all later non-adjacent segments
        j0 = i + 1
        p, dp = a[i], d[i]
        aj, dj = a[j0:], d[j0:]
        denom = dp[0] * dj[:, 1] - dp[1] * dj[:, 0]
        diff = aj - p
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (diff[:, 0] * dj[:, 1] - diff[:, 1] * dj[:, 0]) / denom
            u = (diff[:, 0] * dp[1] - diff[:, 1] * dp[0]) / denom
        parallel = np.abs(denom) < 1e-15
        tol = 1e-12
        hit = (
            ~parallel
            & (t > tol) & (t < 1 - tol)
            & (u > tol) & (u < 1 - tol)
        )
        # adjacency: segment i+1 shares an endpoint (t=1, u=0 excluded by
        # the open interval); the wrap pair (0, n-1) likewise
        if hit.any():
            return False
        # endpoint-on-interior touches (T-junctions) are also non-simple
        touch = (
            ~parallel
            & (
                ((np.abs(t) <= tol) | (np.abs(t - 1) <= tol))
                & (u > tol) & (u < 1 - tol)
                | ((np.abs(u) <= tol) | (np.abs(u - 1) <= tol))
                & (t > tol) & (t < 1 - tol)
            )
        )
        if touch.any():
            return False
        # collinear overlap of parallel segments
        if parallel.any():
            seg_len2 = dp[0] ** 2 + dp[1] ** 2
            for k in np.nonzero(parallel)[0]:
                j = j0 + k
                cross = dp[0] * (a[j][1] - p[1]) - dp[1] * (a[j][0] - p[0])
                if abs(cross) > 1e-9 * np.sqrt(seg_len2) * max(
                    1.0, np.hypot(*d[j])
                ):
                    continue  # parallel but not collinear
                # project segment j's endpoints onto i; interval overlap
                # means doubled/overlapping boundary (for adjacent pairs
                # the shared endpoint projects to exactly 0 or 1, so a
                # straight continuation has zero overlap while a spike
                # doubling back overlaps)
                t1 = ((a[j] - p) @ dp) / seg_len2
                t2 = ((b[j] - p) @ dp) / seg_len2
                lo, hi = min(t1, t2), max(t1, t2)
                if min(hi, 1.0) - max(lo, 0.0) > 1e-12:
                    return False
    return True


def _point_on_segments(px, py, ring, tol=1e-9):
    """True if the point lies on any segment of the ring (within tol)."""
    a = ring[:-1]
    b = ring[1:]
    d = b - a
    ap_x, ap_y = px - a[:, 0], py - a[:, 1]
    cross = d[:, 0] * ap_y - d[:, 1] * ap_x
    seg_len = np.hypot(d[:, 0], d[:, 1])
    with np.errstate(invalid="ignore", divide="ignore"):
        dist = np.abs(cross) / np.where(seg_len == 0, np.inf, seg_len)
        t = (ap_x * d[:, 0] + ap_y * d[:, 1]) / np.where(
            seg_len == 0, np.inf, seg_len**2
        )
    return bool(np.any((dist <= tol) & (t >= -tol) & (t <= 1 + tol)))


def _segments_intersect(p1, p2, p3, p4):
    """Proper or touching intersection of segments p1p2 and p3p4."""

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(v) < _EPS:
            return 0
        return 1 if v > 0 else -1

    def on_seg(a, b, c):
        return (
            min(a[0], b[0]) - _EPS <= c[0] <= max(a[0], b[0]) + _EPS
            and min(a[1], b[1]) - _EPS <= c[1] <= max(a[1], b[1]) + _EPS
        )

    o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
    o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
    if o1 != o2 and o3 != o4:
        return True
    if o1 == 0 and on_seg(p1, p2, p3):
        return True
    if o2 == 0 and on_seg(p1, p2, p4):
        return True
    if o3 == 0 and on_seg(p3, p4, p1):
        return True
    if o4 == 0 and on_seg(p3, p4, p2):
        return True
    return False


def _bbox_disjoint(a, b):
    return a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1]


class Geometry:
    """Base class for all geometries."""

    geom_type = "Geometry"
    srs = None  # optional CRS tag, e.g. "EPSG:28992"

    # --- abstract-ish API ---

    @property
    def is_empty(self):
        return not any(len(c) for c in self._all_coords())

    @property
    def bounds(self):
        # geometries are immutable: memoize (a 20k-feature tile request
        # was spending ~0.5 s per request recomputing these)
        cached = getattr(self, "_bounds_cache", None)
        if cached is not None:
            return cached
        coords = [c for c in self._all_coords() if len(c)]
        if not coords:
            result = ()
        else:
            pts = np.vstack(coords)
            result = (
                float(pts[:, 0].min()),
                float(pts[:, 1].min()),
                float(pts[:, 0].max()),
                float(pts[:, 1].max()),
            )
        self._bounds_cache = result
        return result

    def _all_coords(self):
        """List of coordinate arrays of all constituent parts."""
        raise NotImplementedError

    @property
    def area(self):
        return 0.0

    @property
    def length(self):
        return 0.0

    @property
    def centroid(self):
        pts = np.vstack(self._all_coords())
        return Point(float(pts[:, 0].mean()), float(pts[:, 1].mean()))

    # --- predicates ---

    @property
    def is_valid(self):
        """OGC validity (shapely parity).  Points/lines are always valid;
        Polygon/MultiPolygon override with ring-simplicity and hole
        containment checks."""
        return True

    def equals(self, other):
        """Geometric equality: same point set, regardless of ring
        orientation or starting vertex (polygons); exact otherwise."""
        if isinstance(self, (Polygon, MultiPolygon)) and isinstance(
            other, (Polygon, MultiPolygon)
        ):
            mine = sorted(
                _canonical_rings(p) for p in _polygonize(self)
            )
            theirs = sorted(
                _canonical_rings(p) for p in _polygonize(other)
            )
            return mine == theirs
        return self.wkb == other.wkb

    def __eq__(self, other):
        return isinstance(other, Geometry) and self.equals(other)

    def __hash__(self):
        return hash(self.wkb)

    def disjoint(self, other):
        return not self.intersects(other)

    def intersects(self, other):
        if self.is_empty or other.is_empty:
            return False
        if _bbox_disjoint(self.bounds, other.bounds):
            return False
        return _intersects(self, other)

    def within(self, other):
        """True if self is completely inside other."""
        if self.is_empty or other.is_empty:
            return False
        if _bbox_disjoint(self.bounds, other.bounds):
            return False
        return _within(self, other)

    def contains(self, other):
        return other.within(self)

    def distance(self, other):
        return _distance(self, other)

    # --- operations ---

    def buffer(self, distance, resolution=16):
        raise NotImplementedError("buffer (geo/_buffer.py) is not ported")

    def simplify(self, tolerance, preserve_topology=True):
        return _simplify(self, tolerance)

    def intersection(self, other):
        from dask_geomodeling_tpu_torch.geo import _overlay

        return _overlay.overlay(self, other, "intersection")

    def union(self, other):
        from dask_geomodeling_tpu_torch.geo import _overlay

        return _overlay.overlay(self, other, "union")

    def difference(self, other):
        from dask_geomodeling_tpu_torch.geo import _overlay

        return _overlay.overlay(self, other, "difference")

    @property
    def convex_hull(self):
        pts = np.vstack(self._all_coords())
        hull = _convex_hull(pts)
        if len(hull) < 3:
            return LineString(hull) if len(hull) == 2 else Point(*hull[0])
        return Polygon(hull)

    # --- serialization ---

    @property
    def wkt(self):
        from dask_geomodeling_tpu_torch.geo import _wkt

        return _wkt.dumps(self)

    @property
    def wkb(self):
        from dask_geomodeling_tpu_torch.geo import _wkt

        return _wkt.dumps_wkb(self)

    def __token__(self):
        # deterministic content hash input (used by core.tokens)
        return self.wkb

    def __repr__(self):
        wkt = self.wkt
        if len(wkt) > 70:
            wkt = wkt[:67] + "..."
        return "<{}>".format(wkt)

    @property
    def __geo_interface__(self):
        from dask_geomodeling_tpu_torch.geo import _wkt

        return _wkt.to_geo_interface(self)


class Point(Geometry):
    """A point geometry (x, y)."""
    geom_type = "Point"

    def __init__(self, x, y=None):
        if y is None:
            x, y = x  # accept a coordinate pair
        self.x = float(x)
        self.y = float(y)

    @property
    def coords(self):
        return [(self.x, self.y)]

    @property
    def coords0(self):
        return (self.x, self.y)

    @property
    def is_empty(self):
        return math.isnan(self.x)

    def _all_coords(self):
        return [np.array([[self.x, self.y]])]

    @property
    def bounds(self):
        return (self.x, self.y, self.x, self.y)

    @property
    def centroid(self):
        return self


class LineString(Geometry):
    """An open polyline of 2D coordinates."""
    geom_type = "LineString"

    def __init__(self, coordinates):
        self.coordinates = _coords(coordinates) if len(coordinates) else np.zeros((0, 2))

    @property
    def coords(self):
        return [tuple(c) for c in self.coordinates]

    @property
    def is_empty(self):
        return len(self.coordinates) == 0

    def _all_coords(self):
        return [self.coordinates]

    @property
    def length(self):
        d = np.diff(self.coordinates, axis=0)
        return float(np.hypot(d[:, 0], d[:, 1]).sum())

    @property
    def centroid(self):
        c = self.coordinates
        d = np.diff(c, axis=0)
        seg_len = np.hypot(d[:, 0], d[:, 1])
        total = seg_len.sum()
        if total == 0:
            return Point(*c[0])
        mid = (c[:-1] + c[1:]) / 2
        return Point(*(mid * seg_len[:, None]).sum(axis=0) / total)


class LinearRing(LineString):
    """A closed ring of 2D coordinates."""
    geom_type = "LinearRing"

    def __init__(self, coordinates):
        super().__init__(_close_ring(_coords(coordinates)))


class Polygon(Geometry):
    """A polygon: one exterior ring plus optional interior rings (holes)."""
    geom_type = "Polygon"

    def __init__(self, shell=None, holes=None):
        if shell is None or (hasattr(shell, "__len__") and len(shell) == 0):
            self.shell = np.zeros((0, 2))
            self.holes = []
        else:
            self.shell = _close_ring(_coords(shell))
            self.holes = [_close_ring(_coords(h)) for h in (holes or [])]

    @property
    def exterior(self):
        return LineString(self.shell)

    @property
    def interiors(self):
        return [LineString(h) for h in self.holes]

    @property
    def is_empty(self):
        return len(self.shell) == 0

    def _all_coords(self):
        return [self.shell] + list(self.holes)

    def _rings(self):
        return [self.shell] + list(self.holes)

    @property
    def area(self):
        if self.is_empty:
            return 0.0
        area = abs(_ring_area(self.shell))
        for hole in self.holes:
            area -= abs(_ring_area(hole))
        return area

    @property
    def length(self):
        return sum(LineString(r).length for r in self._rings())

    @property
    def centroid(self):
        if self.is_empty:
            return Point(float("nan"), float("nan"))
        cx = cy = total = 0.0
        for ring, sign in [(self.shell, 1.0)] + [(h, -1.0) for h in self.holes]:
            x, y = ring[:-1, 0], ring[:-1, 1]
            x2, y2 = ring[1:, 0], ring[1:, 1]
            cross = x * y2 - x2 * y
            a = cross.sum() / 2.0
            if a == 0:
                continue
            factor = sign * abs(a) / a  # orient consistently, apply hole sign
            cx += factor * float(((x + x2) * cross).sum()) / 6.0
            cy += factor * float(((y + y2) * cross).sum()) / 6.0
            total += sign * abs(a)
        if total == 0:
            return Point(*self.shell[:-1].mean(axis=0))
        return Point(cx / total, cy / total)

    @property
    def is_valid(self):
        """OGC validity: every ring simple with nonzero area, holes inside
        the exterior, and no two rings crossing (touching at finitely many
        points is allowed by OGC but flagged conservatively here only when
        edges properly cross)."""
        if self.is_empty:
            return True  # matches shapely: empty geometries are valid
        rings = self._rings()
        for ring in rings:
            if len(ring) < 4 or abs(_ring_area(ring)) == 0.0:
                return False
            if not _ring_is_simple(ring):
                return False
        for hole in self.holes:
            # a hole vertex must sit inside (or on) the exterior
            hx, hy = hole[0]
            if not (
                _point_in_ring(hx, hy, self.shell)
                or _point_on_segments(hx, hy, self.shell)
            ):
                return False
        # rings must not properly cross each other
        from dask_geomodeling_tpu_torch.geo import _overlay

        for i in range(len(rings)):
            for j in range(i + 1, len(rings)):
                for k in range(len(rings[i]) - 1):
                    if _overlay._edge_intersections(
                        rings[i][k], rings[i][k + 1], rings[j]
                    ):
                        return False
        return True

    def contains_point(self, px, py, boundary=True):
        """Point-in-polygon over all rings (even-odd)."""
        if _point_on_segments(px, py, self.shell) or any(
            _point_on_segments(px, py, h) for h in self.holes
        ):
            return boundary
        inside = _point_in_ring(px, py, self.shell)
        if inside:
            for hole in self.holes:
                if _point_in_ring(px, py, hole):
                    return False
        return inside


class _Multi(Geometry):
    part_type = Geometry

    def __init__(self, geoms=None):
        self.geoms = [
            g if isinstance(g, self.part_type) else self.part_type(g)
            for g in (geoms or [])
        ]

    @property
    def is_empty(self):
        return all(g.is_empty for g in self.geoms)

    def __len__(self):
        return len(self.geoms)

    def __iter__(self):
        return iter(self.geoms)

    def _all_coords(self):
        return [c for g in self.geoms for c in g._all_coords()]

    @property
    def area(self):
        return sum(g.area for g in self.geoms)

    @property
    def length(self):
        return sum(g.length for g in self.geoms)

    @property
    def centroid(self):
        weights = [max(g.area, 0) or g.length or 1.0 for g in self.geoms]
        pts = [g.centroid for g in self.geoms]
        total = sum(weights)
        return Point(
            sum(w * p.x for w, p in zip(weights, pts)) / total,
            sum(w * p.y for w, p in zip(weights, pts)) / total,
        )


class MultiPoint(_Multi):
    """A collection of Points."""
    geom_type = "MultiPoint"
    part_type = Point


class MultiLineString(_Multi):
    """A collection of LineStrings."""
    geom_type = "MultiLineString"
    part_type = LineString


class MultiPolygon(_Multi):
    """A collection of Polygons."""
    geom_type = "MultiPolygon"
    part_type = Polygon

    @property
    def is_valid(self):
        """All member polygons valid (member-overlap checks, which full
        OGC validity also requires, are not attempted here)."""
        return all(g.is_valid for g in self.geoms)


class GeometryCollection(_Multi):
    """A heterogeneous collection of geometries."""
    geom_type = "GeometryCollection"
    part_type = Geometry

    def __init__(self, geoms=None):
        self.geoms = list(geoms or [])

    @property
    def is_valid(self):
        return all(g.is_valid for g in self.geoms)


def box(x1, y1, x2, y2):
    """Axis-aligned rectangle polygon (counter-clockwise)."""
    return Polygon([(x1, y1), (x2, y1), (x2, y2), (x1, y2), (x1, y1)])


def shape(obj):
    """Build a geometry from a __geo_interface__ / GeoJSON-like mapping."""
    if isinstance(obj, Geometry):
        return obj
    obj = getattr(obj, "__geo_interface__", obj)
    gtype = obj["type"]
    coords = obj.get("coordinates")
    if gtype == "Point":
        return Point(*coords)
    if gtype == "MultiPoint":
        return MultiPoint([Point(*c) for c in coords])
    if gtype == "LineString":
        return LineString(coords)
    if gtype == "MultiLineString":
        return MultiLineString([LineString(c) for c in coords])
    if gtype == "Polygon":
        return Polygon(coords[0], coords[1:]) if coords else Polygon()
    if gtype == "MultiPolygon":
        return MultiPolygon(
            [Polygon(c[0], c[1:]) for c in coords]
        )
    if gtype == "GeometryCollection":
        return GeometryCollection([shape(g) for g in obj["geometries"]])
    raise ValueError("Unsupported geometry type: %s" % gtype)


def from_wkt(text):
    """Parse a WKT string into a Geometry."""
    from dask_geomodeling_tpu_torch.geo import _wkt

    return _wkt.loads(text)


def from_wkb(data):
    """Parse WKB bytes into a Geometry."""
    from dask_geomodeling_tpu_torch.geo import _wkt

    return _wkt.loads_wkb(data)


def transform(func, geom):
    """Apply ``func(x_array, y_array) -> (x, y)`` to all coordinates."""

    def conv(arr):
        x, y = func(arr[:, 0], arr[:, 1])
        return np.column_stack([np.asarray(x, float), np.asarray(y, float)])

    if isinstance(geom, Point):
        x, y = func(np.array([geom.x]), np.array([geom.y]))
        return Point(float(np.asarray(x).ravel()[0]), float(np.asarray(y).ravel()[0]))
    if isinstance(geom, LineString):
        return type(geom)(conv(geom.coordinates))
    if isinstance(geom, Polygon):
        if geom.is_empty:
            return Polygon()
        return Polygon(conv(geom.shell), [conv(h) for h in geom.holes])
    if isinstance(geom, _Multi):
        return type(geom)([transform(func, g) for g in geom.geoms])
    raise TypeError("Cannot transform %r" % type(geom))


# --- shared predicate/measure implementations ---


def _polygonize(geom):
    """List of Polygon parts of a geometry (empty for non-areal)."""
    if isinstance(geom, Polygon):
        return [] if geom.is_empty else [geom]
    if isinstance(geom, (MultiPolygon, GeometryCollection)):
        return [p for g in geom.geoms for p in _polygonize(g)]
    return []


def _linework(geom):
    """List of coordinate arrays forming the boundary/line work."""
    if isinstance(geom, Point):
        return []
    if isinstance(geom, Polygon):
        return geom._rings()
    if isinstance(geom, LineString):
        return [geom.coordinates]
    if isinstance(geom, _Multi):
        return [c for g in geom.geoms for c in _linework(g)]
    return []


def _points_of(geom):
    if isinstance(geom, Point):
        return [(geom.x, geom.y)]
    if isinstance(geom, MultiPoint):
        return [(p.x, p.y) for p in geom.geoms]
    if isinstance(geom, GeometryCollection):
        return [pt for g in geom.geoms for pt in _points_of(g)]
    return []


def _any_segment_intersection(lines_a, lines_b):
    for a in lines_a:
        for b in lines_b:
            if _bbox_disjoint(
                (a[:, 0].min(), a[:, 1].min(), a[:, 0].max(), a[:, 1].max()),
                (b[:, 0].min(), b[:, 1].min(), b[:, 0].max(), b[:, 1].max()),
            ):
                continue
            if _any_segment_pair_intersects(a, b):
                return True
    return False


#: segment pairs tested at once by _any_segment_pair_intersects
_PAIR_CHUNK = 2**20


def _any_segment_pair_intersects(a, b):
    """Whether ``_segments_intersect`` holds for any segment of polyline
    ``a`` against any of polyline ``b``: the same float64 operations and
    tolerances, over every pair at once (the JAX package loops over the
    pairs in Python; the answer is the same)."""

    def orient(p, q, r):
        v = (q[..., 0] - p[..., 0]) * (r[..., 1] - p[..., 1]) - (q[..., 1] - p[..., 1]) * (
            r[..., 0] - p[..., 0]
        )
        return np.where(np.abs(v) < _EPS, 0, np.where(v > 0, 1, -1))

    def on_seg(p, q, r):
        return (
            (np.minimum(p[..., 0], q[..., 0]) - _EPS <= r[..., 0])
            & (r[..., 0] <= np.maximum(p[..., 0], q[..., 0]) + _EPS)
            & (np.minimum(p[..., 1], q[..., 1]) - _EPS <= r[..., 1])
            & (r[..., 1] <= np.maximum(p[..., 1], q[..., 1]) + _EPS)
        )

    p3, p4 = b[None, :-1], b[None, 1:]
    step = max(1, _PAIR_CHUNK // max(len(b) - 1, 1))
    for lo in range(0, len(a) - 1, step):
        hi = min(lo + step, len(a) - 1)
        p1, p2 = a[lo:hi, None], a[lo + 1 : hi + 1, None]
        o1, o2 = orient(p1, p2, p3), orient(p1, p2, p4)
        o3, o4 = orient(p3, p4, p1), orient(p3, p4, p2)
        hit = (
            ((o1 != o2) & (o3 != o4))
            | ((o1 == 0) & on_seg(p1, p2, p3))
            | ((o2 == 0) & on_seg(p1, p2, p4))
            | ((o3 == 0) & on_seg(p3, p4, p1))
            | ((o4 == 0) & on_seg(p3, p4, p2))
        )
        if hit.any():
            return True
    return False


def _nonareal_linework(geom):
    """Linework of the NON-polygon parts only (a polygon's rings are
    covered by the areal containment test)."""
    if isinstance(geom, LineString):
        return [geom.coordinates]
    if isinstance(geom, (MultiLineString, GeometryCollection)):
        return [c for g in geom.geoms for c in _nonareal_linework(g)]
    return []


def _point_in_geom(px, py, geom, boundary=True):
    for poly in _polygonize(geom):
        if poly.contains_point(px, py, boundary=boundary):
            return True
    # line parts are tested even in mixed collections (a point on a line
    # inside a GeometryCollection with polygons still intersects)
    for line in _nonareal_linework(geom):
        if _point_on_segments(px, py, line):
            return boundary
    for qx, qy in _points_of(geom):
        if abs(qx - px) < 1e-9 and abs(qy - py) < 1e-9:
            return True
    return False


def _intersects(a, b):
    # point cases
    for px, py in _points_of(a):
        if _point_in_geom(px, py, b):
            return True
    for px, py in _points_of(b):
        if _point_in_geom(px, py, a):
            return True
    if _points_of(a) and not (_linework(a)):
        return False
    if _points_of(b) and not (_linework(b)):
        return False
    lines_a, lines_b = _linework(a), _linework(b)
    if _any_segment_intersection(lines_a, lines_b):
        return True
    # containment without boundary crossing
    if lines_a and _polygonize(b):
        px, py = lines_a[0][0]
        if _point_in_geom(px, py, b):
            return True
    if lines_b and _polygonize(a):
        px, py = lines_b[0][0]
        if _point_in_geom(px, py, a):
            return True
    return False


def _strictly_cross(p1, p2, q1, q2):
    """True when segments p1p2 and q1q2 cross at an interior point of
    both (touching/collinear contact does not count)."""

    def orient(a, b, c):
        v = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
        if abs(v) < _EPS:
            return 0
        return 1 if v > 0 else -1

    o1, o2 = orient(q1, q2, p1), orient(q1, q2, p2)
    o3, o4 = orient(p1, p2, q1), orient(p1, p2, q2)
    return o1 != 0 and o2 != 0 and o1 != o2 and o3 != 0 and o4 != 0 and o3 != o4


def _within(a, b):
    polys_b = _polygonize(b)
    if not polys_b:
        return False
    # points on the boundary are NOT within (GEOS convention)
    if isinstance(a, Point):
        return any(
            poly.contains_point(a.x, a.y, boundary=False) for poly in polys_b
        )
    # all vertices of a inside b...
    linework_a = _linework(a) or [np.array(_points_of(a))]
    for coords in linework_a:
        for px, py in coords:
            if not _point_in_geom(px, py, b):
                return False
    # ...and no segment of a exits b: a strict boundary crossing means
    # part of a lies outside even though every vertex is inside (concave
    # shells); midpoints guard crossings that graze a boundary vertex
    boundary_b = [np.asarray(r) for poly in polys_b for r in poly._rings()]
    for coords in linework_a:
        coords = np.asarray(coords)
        for i in range(len(coords) - 1):
            p1, p2 = coords[i], coords[i + 1]
            mx, my = (p1[0] + p2[0]) / 2.0, (p1[1] + p2[1]) / 2.0
            if not _point_in_geom(mx, my, b):
                return False
            for ring in boundary_b:
                for j in range(len(ring) - 1):
                    if _strictly_cross(p1, p2, ring[j], ring[j + 1]):
                        return False
    # for polygons we also need b's holes not to poke into a; sample a's
    # representative point
    polys_a = _polygonize(a)
    if polys_a:
        rp = _representative_point(polys_a[0])
        if not _point_in_geom(rp[0], rp[1], b):
            return False
    return True


def _representative_point(poly):
    cx, cy = poly.centroid.x, poly.centroid.y
    if poly.contains_point(cx, cy):
        return (cx, cy)
    # scan along the horizontal line through the bbox middle
    x1, y1, x2, y2 = poly.bounds
    for frac in np.linspace(0.05, 0.95, 19):
        px = x1 + (x2 - x1) * frac
        py = (y1 + y2) / 2.0
        if poly.contains_point(px, py, boundary=False):
            return (px, py)
    return (cx, cy)


def _seg_point_distance(a, b, p):
    d = b - a
    denom = float(d[0] ** 2 + d[1] ** 2)
    if denom == 0:
        return float(np.hypot(*(p - a)))
    t = float(np.clip(((p - a) @ d) / denom, 0.0, 1.0))
    proj = a + t * d
    return float(np.hypot(*(p - proj)))


def _distance_runs(geom, stacked):
    """Linework runs for distance: point-only geometries contribute each
    point as its own degenerate run — never phantom segments between
    unrelated points."""
    lines = _linework(geom)
    if lines:
        return lines
    return [stacked[i : i + 1] for i in range(len(stacked))]


def _distance(a, b):
    if a.intersects(b):
        return 0.0
    pts_a = np.vstack(a._all_coords())
    pts_b = np.vstack(b._all_coords())
    best = np.inf
    for line in _distance_runs(a, pts_a):
        for p in pts_b:
            for i in range(max(len(line) - 1, 1)):
                seg_b = line[min(i + 1, len(line) - 1)]
                best = min(best, _seg_point_distance(line[i], seg_b, p))
    for line in _distance_runs(b, pts_b):
        for p in pts_a:
            for i in range(max(len(line) - 1, 1)):
                seg_b = line[min(i + 1, len(line) - 1)]
                best = min(best, _seg_point_distance(line[i], seg_b, p))
    return float(best)


def _douglas_peucker(coords, tol):
    if len(coords) < 3:
        return coords
    keep = np.zeros(len(coords), dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, len(coords) - 1)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo < 2:
            continue
        a, b = coords[lo], coords[hi]
        seg = b - a
        norm = np.hypot(*seg)
        pts = coords[lo + 1 : hi]
        if norm == 0:
            dists = np.hypot(pts[:, 0] - a[0], pts[:, 1] - a[1])
        else:
            dists = (
                np.abs(seg[0] * (pts[:, 1] - a[1]) - seg[1] * (pts[:, 0] - a[0]))
                / norm
            )
        imax = int(np.argmax(dists))
        if dists[imax] > tol:
            mid = lo + 1 + imax
            keep[mid] = True
            stack.append((lo, mid))
            stack.append((mid, hi))
    return coords[keep]


def _simplify(geom, tol):
    if isinstance(geom, Point) or geom.is_empty:
        return geom
    if isinstance(geom, LineString):
        return type(geom)(_douglas_peucker(geom.coordinates, tol))
    if isinstance(geom, Polygon):
        shell = _douglas_peucker(geom.shell, tol)
        if len(shell) < 4:
            shell = geom.shell
        holes = []
        for h in geom.holes:
            s = _douglas_peucker(h, tol)
            if len(s) >= 4:
                holes.append(s)
        return Polygon(shell, holes)
    if isinstance(geom, _Multi):
        return type(geom)([_simplify(g, tol) for g in geom.geoms])
    return geom


def _canonical_ring(ring):
    """Hashable canonical form: CCW orientation, rotated to start at the
    lexicographically smallest vertex, closing vertex dropped."""
    open_ring = np.asarray(ring)[:-1]
    if _ring_area(np.vstack([open_ring, open_ring[:1]])) < 0:
        open_ring = open_ring[::-1]
    start = np.lexsort((open_ring[:, 1], open_ring[:, 0]))[0]
    rolled = np.roll(open_ring, -start, axis=0)
    return tuple(map(tuple, rolled))


def _canonical_rings(poly):
    return (
        _canonical_ring(poly.shell),
        tuple(sorted(_canonical_ring(h) for h in poly.holes)),
    )


def _convex_hull(points):
    """Andrew's monotone chain; returns hull vertices (CCW, open)."""
    pts = np.unique(points, axis=0)
    if len(pts) <= 2:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(iterable):
        hull = []
        for p in iterable:
            while (
                len(hull) >= 2
                and (hull[-1][0] - hull[-2][0]) * (p[1] - hull[-2][1])
                - (hull[-1][1] - hull[-2][1]) * (p[0] - hull[-2][0])
                <= 0
            ):
                hull.pop()
            hull.append(p)
        return hull

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])
