"""Geometry buffering by contouring a distance field.

Counterpart of dask_geomodeling_tpu/geo/_buffer.py, copied so that it
gives the same float64 bits: the same grid, chunking and interpolation.

``buffer(geom, d)`` is the Minkowski sum (d>0) / erosion (d<0) of the
geometry with a disc.  Rather than offsetting edges and resolving
self-intersections, the buffered outline is extracted as the level set
``dist(p, geom) = |d|`` of the exact point-to-geometry distance field
sampled on a local grid of cell ``|d| / resolution``, with marching
squares and linear interpolation.  It runs in numpy on the host, as in
the JAX package, which has no device version of it either.
"""
import numpy as np

from dask_geomodeling_tpu_torch.geo.geometry import (
    GeometryCollection,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    _linework,
    _point_in_ring,
    _polygonize,
    _ring_area,
)

__all__ = ["buffer"]


def buffer(geom, distance, resolution=16):
    """Return the geometry buffered by ``distance`` (negative = erosion)."""
    if distance == 0:
        return geom
    if geom.is_empty:
        return Polygon()

    # fast exact path for points: a regular polygon approximating the circle
    if isinstance(geom, Point) and distance > 0:
        return _point_buffer(geom.x, geom.y, distance, resolution)

    polys = _polygonize(geom)
    if distance < 0 and not polys:
        return Polygon()  # negative buffer of points/lines is empty

    segments = _collect_segments(geom)
    if not len(segments):
        return Polygon()

    # sample the signed distance field on a grid around the geometry
    x1, y1, x2, y2 = geom.bounds
    pad = abs(distance) * 1.05
    cell = abs(distance) / float(resolution)
    # guard against degenerate boxes and absurd grids
    nx = int(np.ceil((x2 - x1 + 2 * pad) / cell)) + 2
    ny = int(np.ceil((y2 - y1 + 2 * pad) / cell)) + 2
    max_cells = 4_000_000
    if nx * ny > max_cells:
        factor = np.sqrt(nx * ny / max_cells)
        cell *= factor
        nx = int(np.ceil((x2 - x1 + 2 * pad) / cell)) + 2
        ny = int(np.ceil((y2 - y1 + 2 * pad) / cell)) + 2
    xs = x1 - pad + np.arange(nx) * cell
    ys = y1 - pad + np.arange(ny) * cell
    gx, gy = np.meshgrid(xs, ys)

    dist = _distance_field(gx.ravel(), gy.ravel(), segments).reshape(gy.shape)

    if polys:
        inside = _inside_field(gx.ravel(), gy.ravel(), polys).reshape(gy.shape)
        signed = np.where(inside, -dist, dist)
    else:
        signed = dist

    # result region: signed distance <= distance (for erosion: distance < 0)
    field = signed - distance
    rings = _marching_squares(field, xs, ys)
    return _rings_to_polygons(rings)


def _point_buffer(cx, cy, radius, resolution):
    n = max(resolution * 4, 8)
    theta = np.linspace(0, 2 * np.pi, n + 1)
    return Polygon(
        np.column_stack([cx + radius * np.cos(theta), cy + radius * np.sin(theta)])
    )


def _collect_segments(geom):
    """(N, 2, 2) array of all boundary segments."""
    segs = []
    for coords in _linework(geom):
        if len(coords) >= 2:
            segs.append(np.stack([coords[:-1], coords[1:]], axis=1))
    pts = []
    if isinstance(geom, Point):
        pts = [(geom.x, geom.y)]
    elif isinstance(geom, (MultiPoint, GeometryCollection)):
        from dask_geomodeling_tpu_torch.geo.geometry import _points_of

        pts = _points_of(geom)
    for px, py in pts:
        segs.append(np.array([[[px, py], [px, py]]]))
    if not segs:
        return np.zeros((0, 2, 2))
    return np.concatenate(segs, axis=0)


def _distance_field(px, py, segments, chunk=262144):
    """Exact distance from points to the nearest segment (vectorized)."""
    a = segments[:, 0]  # (S, 2)
    d = segments[:, 1] - segments[:, 0]  # (S, 2)
    len2 = (d**2).sum(axis=1)  # (S,)
    len2 = np.where(len2 == 0, 1.0, len2)
    out = np.empty(px.shape, dtype=float)
    for lo in range(0, len(px), chunk):
        hi = min(lo + chunk, len(px))
        qx = px[lo:hi, None] - a[None, :, 0]  # (P, S)
        qy = py[lo:hi, None] - a[None, :, 1]
        t = np.clip((qx * d[None, :, 0] + qy * d[None, :, 1]) / len2[None, :], 0, 1)
        ex = qx - t * d[None, :, 0]
        ey = qy - t * d[None, :, 1]
        out[lo:hi] = np.sqrt((ex**2 + ey**2).min(axis=1))
    return out


def _inside_field(px, py, polys):
    inside = np.zeros(px.shape, dtype=bool)
    for poly in polys:
        for ring, is_hole in [(poly.shell, False)] + [
            (h, True) for h in poly.holes
        ]:
            x, y = ring[:-1, 0], ring[:-1, 1]
            x2, y2 = ring[1:, 0], ring[1:, 1]
            with np.errstate(divide="ignore", invalid="ignore"):
                slope = np.where(y2 == y, np.inf, (x2 - x) / (y2 - y))
            crossings = np.zeros(px.shape, dtype=np.int64)
            for i in range(len(x)):
                cond = (y[i] > py) != (y2[i] > py)
                if not cond.any():
                    continue
                xi = (py - y[i]) * slope[i] + x[i]
                crossings += (cond & (px < xi)).astype(np.int64)
            inside ^= (crossings % 2).astype(bool)
    return inside


_EDGE_LOOKUP = {
    # case -> list of (edge_in, edge_out); edges: 0=bottom 1=right 2=top 3=left
    1: [(3, 0)], 2: [(0, 1)], 3: [(3, 1)], 4: [(1, 2)],
    5: [(3, 2), (1, 0)], 6: [(0, 2)], 7: [(3, 2)], 8: [(2, 3)],
    9: [(2, 0)], 10: [(0, 3), (2, 1)], 11: [(2, 1)], 12: [(1, 3)],
    13: [(1, 0)], 14: [(0, 3)],
}


def _marching_squares(field, xs, ys):
    """Extract closed contours of field <= 0 via marching squares."""
    neg = field <= 0
    ny, nx = field.shape
    # cell case index from its 4 corners (bit order: bl, br, tr, tl)
    bl = neg[:-1, :-1]
    br = neg[:-1, 1:]
    tr = neg[1:, 1:]
    tl = neg[1:, :-1]
    case = (
        bl.astype(np.int8)
        + (br.astype(np.int8) << 1)
        + (tr.astype(np.int8) << 2)
        + (tl.astype(np.int8) << 3)
    )

    def interp(v0, v1):
        denom = v1 - v0
        t = np.where(denom == 0, 0.5, -v0 / np.where(denom == 0, 1.0, denom))
        return np.clip(t, 0.0, 1.0)

    # gather directed boundary edgelets per cell, keyed for stitching
    segs = {}
    cells = np.argwhere((case > 0) & (case < 15))
    for cy, cx in cells:
        c = case[cy, cx]
        v = (
            field[cy, cx],
            field[cy, cx + 1],
            field[cy + 1, cx + 1],
            field[cy + 1, cx],
        )

        def edge_point(edge):
            if edge == 0:  # bottom: between corners 0,1
                t = interp(v[0], v[1])
                return (xs[cx] + t * (xs[cx + 1] - xs[cx]), ys[cy])
            if edge == 1:  # right: corners 1,2
                t = interp(v[1], v[2])
                return (xs[cx + 1], ys[cy] + t * (ys[cy + 1] - ys[cy]))
            if edge == 2:  # top: corners 3,2
                t = interp(v[3], v[2])
                return (xs[cx] + t * (xs[cx + 1] - xs[cx]), ys[cy + 1])
            t = interp(v[0], v[3])  # left: corners 0,3
            return (xs[cx], ys[cy] + t * (ys[cy + 1] - ys[cy]))

        for e_in, e_out in _EDGE_LOOKUP[c]:
            p = edge_point(e_in)
            q = edge_point(e_out)
            segs[((cy, cx, e_in))] = (p, q, _edge_key(cy, cx, e_out))

    # stitch: follow (cell, edge) -> neighbor (cell, edge)
    rings = []
    used = set()
    for start in list(segs.keys()):
        if start in used:
            continue
        chain = []
        key = start
        guard = 0
        while key in segs and key not in used and guard <= len(segs):
            guard += 1
            used.add(key)
            p, q, nxt = segs[key]
            if not chain:
                chain.append(p)
            chain.append(q)
            key = nxt
        if len(chain) >= 4 and np.allclose(chain[0], chain[-1], atol=1e-9):
            rings.append(np.array(chain))
        elif len(chain) >= 3:
            chain.append(chain[0])
            rings.append(np.array(chain))
    return rings


def _edge_key(cy, cx, edge_out):
    """The matching (cell, edge_in) key of the neighbor across edge_out."""
    if edge_out == 0:
        return (cy - 1, cx, 2)
    if edge_out == 1:
        return (cy, cx + 1, 3)
    if edge_out == 2:
        return (cy + 1, cx, 0)
    return (cy, cx - 1, 1)


def _rings_to_polygons(rings):
    if not rings:
        return Polygon()
    # classify by nesting depth tested at a VERTEX of each ring: marching-
    # squares contours never touch, so a vertex of ring i is strictly
    # inside or outside every other ring (the vertex MEAN can fall outside
    # concave rings, and interior sample points can land in nested rings)
    points = [tuple(ring[0]) for ring in rings]
    depths = []
    for i, ring in enumerate(rings):
        px, py = points[i]
        depths.append(
            sum(
                1
                for j, other in enumerate(rings)
                if j != i and _point_in_ring(px, py, other)
            )
        )
    exteriors = [i for i, d in enumerate(depths) if d % 2 == 0]
    holes = [i for i, d in enumerate(depths) if d % 2 == 1]
    polys = []
    for i in exteriors:
        shell = rings[i] if _ring_area(rings[i]) > 0 else rings[i][::-1]
        my_holes = []
        for j in holes:
            px, py = points[j]
            # a hole belongs to its IMMEDIATE parent: the exterior exactly
            # one level up (an island's lake would otherwise also punch
            # through the outermost shell)
            if depths[j] == depths[i] + 1 and _point_in_ring(px, py, rings[i]):
                hole = rings[j] if _ring_area(rings[j]) < 0 else rings[j][::-1]
                my_holes.append(hole)
        polys.append(Polygon(shell, my_holes))
    if len(polys) == 1:
        return polys[0]
    return MultiPolygon(polys)
