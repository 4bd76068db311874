"""Planar boolean overlay: intersection / union / difference.

A copy of dask_geomodeling_tpu/geo/_overlay.py (numpy only), importing the
port's geometry engine; it gives the same float64 bits.

Replaces shapely/GEOS set operations used throughout the reference
(e.g. reference geometry/set_operations.py:60-118 and
geometry/parallelize.py tile clipping). Matches GEOS semantics for valid
inputs; results on invalid (self-intersecting) polygons are undefined,
as in GEOS.

Algorithm (robust for polygons with holes, including shared edges):

1. Split every boundary edge of A at its intersections with B's edges (and
   vice versa), producing fragments.
2. A fragment lies on the boundary of the result iff the result-region
   membership ``R(p) = inA(p) <op> inB(p)`` differs between the two sides of
   the fragment (sampled a small epsilon along the fragment normal).  This
   uniform rule handles collinear shared edges and tangencies without
   special cases.
3. Deduplicate fragments and stitch them into closed rings; build the ring
   containment tree to assign exteriors and holes.

Non-areal inputs: points are classified directly; linestrings are clipped by
splitting at polygon boundaries and keeping inside fragments.
"""
import numpy as np

from dask_geomodeling_tpu_torch.geo.geometry import (
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    _point_in_ring,
    _points_of,
    _polygonize,
    _ring_area,
)

_OPS_VEC = {
    "intersection": lambda a, b: a & b,
    "union": lambda a, b: a | b,
    "difference": lambda a, b: a & ~b,
}

# point-count x edge-count product per vectorized even-odd chunk
_BATCH_CELL_BUDGET = 4_000_000


def _edge_arrays(rings):
    """Concatenate all ring edges into (starts, ends) arrays."""
    starts = np.concatenate([np.asarray(r)[:-1] for r in rings])
    ends = np.concatenate([np.asarray(r)[1:] for r in rings])
    return starts, ends


def _even_odd_batch(pts, starts, ends):
    """Vectorized even-odd test of ``pts`` (n, 2) against the union of
    rings given as concatenated edge arrays; returns a bool mask."""
    m = max(len(starts), 1)
    out = np.empty(len(pts), dtype=bool)
    chunk = max(1, _BATCH_CELL_BUDGET // m)
    x1, y1 = starts[:, 0][None, :], starts[:, 1][None, :]
    x2, y2 = ends[:, 0][None, :], ends[:, 1][None, :]
    slope_den = np.where(y2 == y1, np.inf, y2 - y1)
    for lo in range(0, len(pts), chunk):
        px = pts[lo : lo + chunk, 0][:, None]
        py = pts[lo : lo + chunk, 1][:, None]
        crossing = ((y1 > py) != (y2 > py)) & (
            px < (x2 - x1) * (py - y1) / slope_den + x1
        )
        out[lo : lo + chunk] = (
            np.count_nonzero(crossing, axis=1) % 2
        ).astype(bool)
    return out


def overlay(a, b, op):
    """Compute the boolean overlay of two geometries."""
    if op not in _OPS_VEC:
        raise ValueError("Unknown overlay op: %s" % op)
    polys_a = _polygonize(a)
    polys_b = _polygonize(b)

    # non-areal subjects: points / lines against polygons
    if not polys_a and (_points_of(a) or _is_lineal(a)):
        return _overlay_nonareal(a, polys_b, op)
    if not polys_b and op == "intersection" and (_points_of(b) or _is_lineal(b)):
        return _overlay_nonareal(b, polys_a, "intersection")

    # empty shortcuts
    if not polys_a:
        if op == "union":
            return b
        return Polygon()
    if not polys_b:
        if op == "intersection":
            return Polygon()
        return a if len(polys_a) > 1 or isinstance(a, MultiPolygon) else polys_a[0]

    rings_a = [np.asarray(r, dtype=float) for p in polys_a for r in p._rings()]
    rings_b = [np.asarray(r, dtype=float) for p in polys_b for r in p._rings()]

    # Work in a local frame centered on the operands: precision becomes
    # relative to FEATURE size instead of absolute coordinate magnitude.
    # Unit-scale features at an offset of 1e7 (routine for projected CRS)
    # would otherwise see the snap tolerance at 1e-5 of a unit, destroying
    # slivers and near-tangencies.  The integer shift subtracts exactly
    # (Sterbenz) for same-magnitude coordinates and within one ulp else.
    ab1 = np.asarray(a.bounds, dtype=float)
    bb1 = np.asarray(b.bounds, dtype=float)
    lo = np.minimum(ab1[:2], bb1[:2])
    hi = np.maximum(ab1[2:], bb1[2:])
    shift = np.round((lo + hi) / 2.0)
    rings_a = [r - shift for r in rings_a]
    rings_b = [r - shift for r in rings_b]

    # scale = half-extent of the joint bounds in the local frame
    scale = float(np.max(hi - lo)) / 2.0 or 1.0
    # snap tolerance: well above the ~1e-16*scale float noise of the
    # intersection math, well below resolvable feature separations (was
    # 1e-9*scale, which made near-tangent boundaries at large coordinate
    # offsets unresolvable and lost whole result rings)
    eps = 1e-12 * scale

    frags = _split_mutual(rings_a, rings_b)

    # cluster fragment endpoints within eps so shared-edge duplicates and
    # near-coincident intersection points get ONE identity (plain grid
    # snapping breaks when two points within eps straddle a cell border)
    endpoints = [pt for frag in frags for pt in frag]
    labels, reps = _cluster_points(endpoints, eps)

    # non-degenerate fragments in snapped coordinates
    pairs = []
    for idx in range(len(frags)):
        kp, kq = labels[2 * idx], labels[2 * idx + 1]
        if kp != kq:  # else collapses under snapping
            pairs.append((kp, kq))
    if not pairs:
        return Polygon()
    pair_arr = np.asarray(pairs)
    rep_arr = np.asarray(reps)
    p = rep_arr[pair_arr[:, 0]]
    q = rep_arr[pair_arr[:, 1]]
    mid = (p + q) / 2.0
    d = q - p
    norm = np.hypot(d[:, 0], d[:, 1])
    unit_n = np.column_stack([-d[:, 1], d[:, 0]]) / norm[:, None]

    # sample result-region membership just off each fragment midpoint;
    # never farther than a quarter of the fragment itself.  A boundary of
    # the other polygon running nearly tangent within the offset (e.g. the
    # far wall of a sliver thinner than the offset) makes both samples
    # agree spuriously -- shrink all the way down to the snap tolerance
    # before concluding a fragment is not on the result boundary.  All
    # still-undecided fragments are sampled per ladder stage in ONE
    # vectorized even-odd pass.
    rule_v = _OPS_VEC[op]
    ea1, ea2 = _edge_arrays(rings_a)
    eb1, eb2 = _edge_arrays(rings_b)
    floor_off = 8.0 * eps
    off = np.minimum(norm / 4.0, np.maximum(floor_off, norm / 4.0e3))
    undecided = np.arange(len(pairs))
    kept = {}
    dropped = []
    while len(undecided):
        sel_mid = mid[undecided]
        step = unit_n[undecided] * off[undecided][:, None]
        pts = np.concatenate([sel_mid + step, sel_mid - step])
        in_a = _even_odd_batch(pts, ea1, ea2)
        in_b = _even_odd_batch(pts, eb1, eb2)
        res = rule_v(in_a, in_b)
        nsel = len(undecided)
        left, right = res[:nsel], res[nsel:]
        differs = left != right
        for i in np.nonzero(differs)[0]:
            gi = undecided[i]
            kp, kq = pairs[gi]
            if right[i]:  # orient so the result interior is on the left
                kp, kq = kq, kp
            kept[(kp, kq)] = None
        at_floor = off[undecided] <= floor_off
        for gi in undecided[~differs & at_floor]:
            dropped.append(pairs[gi])
        undecided = undecided[~differs & ~at_floor]
        off[undecided] = np.maximum(off[undecided] / 8.0, floor_off)

    rings = _stitch(list(kept), reps, eps, dropped)
    return _assemble([r + shift for r in rings])


def _cluster_points(points, eps):
    """Union-find clustering of points within ``eps``; returns (labels,
    representatives) where labels[i] indexes into representatives."""
    pts = np.asarray(points, dtype=float)
    n = len(pts)
    parent = list(range(n))

    def find(i):
        while parent[i] != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    cells = {}
    inv_eps = 1.0 / eps if eps > 0 else 1.0
    for i, (x, y) in enumerate(pts):
        cells.setdefault(
            (int(np.floor(x * inv_eps)), int(np.floor(y * inv_eps))), []
        ).append(i)
    for (cx, cy), members in cells.items():
        for dx in (0, 1):
            for dy in (-1, 0, 1):
                if dx == 0 and dy < 0:
                    continue  # each unordered cell pair once
                other = cells.get((cx + dx, cy + dy))
                if other is None:
                    continue
                same_cell = dx == 0 and dy == 0
                for i in members:
                    for j in other:
                        # visit each pair once: i<j within a cell; every
                        # cross-cell pair arrives exactly once already
                        if same_cell and i >= j:
                            continue
                        if (
                            abs(pts[i, 0] - pts[j, 0]) <= eps
                            and abs(pts[i, 1] - pts[j, 1]) <= eps
                        ):
                            ri, rj = find(i), find(j)
                            if ri != rj:
                                parent[rj] = ri
    label_of_root = {}
    labels = []
    reps = []
    for i in range(n):
        root = find(i)
        if root not in label_of_root:
            label_of_root[root] = len(reps)
            reps.append((float(pts[root, 0]), float(pts[root, 1])))
        labels.append(label_of_root[root])
    return labels, reps


def _is_lineal(geom):
    return isinstance(geom, (LineString, MultiLineString)) or (
        isinstance(geom, GeometryCollection)
        and any(isinstance(g, (LineString, MultiLineString)) for g in geom.geoms)
    )


def _overlay_nonareal(geom, polys, op):
    """Overlay of a point/line subject with an areal geometry.

    ``intersection`` keeps the parts inside, ``difference`` the parts
    outside (lines split at the polygon boundary either way); ``union``
    is the areal geometry plus the outside parts, as a collection.
    """

    def inside(px, py):
        return any(p.contains_point(px, py) for p in polys)

    def collect(keep):
        pts = [Point(px, py) for px, py in _points_of(geom) if keep(px, py)]
        lines = []
        for part in _lines_of(geom):
            lines.extend(_clip_line(part, polys, keep))
        if pts and not lines:
            return pts[0] if len(pts) == 1 else MultiPoint(pts)
        if lines and not pts:
            return lines[0] if len(lines) == 1 else MultiLineString(lines)
        if pts and lines:
            return GeometryCollection(pts + lines)
        return Polygon()  # empty

    if op == "intersection":
        return collect(inside)
    if op == "difference":
        return collect(lambda px, py: not inside(px, py))
    if op == "union":
        outside = collect(lambda px, py: not inside(px, py))
        if isinstance(outside, Polygon) and outside.is_empty:
            parts = list(polys)
        else:
            lineal = (
                list(outside.geoms)
                if isinstance(outside, (MultiPoint, MultiLineString, GeometryCollection))
                else [outside]
            )
            parts = list(polys) + lineal
        if len(parts) == 1:
            return parts[0]
        return GeometryCollection(parts)
    raise NotImplementedError("Unsupported non-areal overlay: %s" % op)


def _lines_of(geom):
    if isinstance(geom, LineString):
        return [geom.coordinates]
    if isinstance(geom, MultiLineString):
        return [g.coordinates for g in geom.geoms]
    if isinstance(geom, GeometryCollection):
        return [c for g in geom.geoms for c in _lines_of(g)]
    return []


def _clip_line(coords, polys, inside):
    """Clip a linestring's coordinates to the inside of polygons."""
    rings = [r for p in polys for r in p._rings()]
    pieces = []
    current = []
    for i in range(len(coords) - 1):
        p, q = coords[i], coords[i + 1]
        ts = [0.0, 1.0]
        for ring in rings:
            ts.extend(_edge_intersections(p, q, ring))
        ts = sorted(set(np.clip(ts, 0.0, 1.0)))
        for t0, t1 in zip(ts[:-1], ts[1:]):
            if t1 - t0 < 1e-12:
                continue
            mid_t = (t0 + t1) / 2.0
            mx, my = p + (q - p) * mid_t
            a = p + (q - p) * t0
            b = p + (q - p) * t1
            if inside(mx, my):
                if current and np.allclose(current[-1], a):
                    current.append(b)
                else:
                    if len(current) >= 2:
                        pieces.append(LineString(np.array(current)))
                    current = [a, b]
    if len(current) >= 2:
        pieces.append(LineString(np.array(current)))
    return pieces


def _edge_intersections(p, q, ring):
    """Parameters t in (0, 1) where segment p->q crosses ring edges."""
    ts = []
    d = q - p
    a = ring[:-1]
    b = ring[1:]
    e = b - a
    denom = d[0] * e[:, 1] - d[1] * e[:, 0]
    diff = a - p
    with np.errstate(divide="ignore", invalid="ignore"):
        t = (diff[:, 0] * e[:, 1] - diff[:, 1] * e[:, 0]) / denom
        u = (diff[:, 0] * d[1] - diff[:, 1] * d[0]) / denom
    valid = (np.abs(denom) > 1e-15) & (t > 1e-12) & (t < 1 - 1e-12) & (u >= -1e-12) & (
        u <= 1 + 1e-12
    )
    ts.extend(t[valid].tolist())
    # collinear overlaps: project the other edge's endpoints onto p->q
    denom_len = d[0] ** 2 + d[1] ** 2
    if denom_len > 0:
        collinear = np.abs(denom) <= 1e-15
        if collinear.any():
            for idx in np.nonzero(collinear)[0]:
                for pt in (a[idx], b[idx]):
                    cross = d[0] * (pt[1] - p[1]) - d[1] * (pt[0] - p[0])
                    if abs(cross) < 1e-9 * np.sqrt(denom_len):
                        tt = ((pt[0] - p[0]) * d[0] + (pt[1] - p[1]) * d[1]) / denom_len
                        if 1e-12 < tt < 1 - 1e-12:
                            ts.append(float(tt))
    return ts


def _split_mutual(rings_a, rings_b):
    """Split every edge of A's rings at intersections with B's rings and
    vice versa, computing each crossing point ONCE and sharing it between
    both sides' fragments.

    Two independent computations of the same crossing (the old
    split-A-by-B then split-B-by-A) diverge by ~1e-16*scale/sin(angle) --
    unbounded for shallow sliver crossings -- and divergence beyond the
    endpoint-cluster tolerance breaks ring stitching.  Sharing the point
    makes both sides bit-identical by construction.
    """
    edges_a = [
        (ring[i], ring[i + 1])
        for ring in rings_a
        for i in range(len(ring) - 1)
    ]
    edges_b = [
        (ring[i], ring[i + 1])
        for ring in rings_b
        for i in range(len(ring) - 1)
    ]
    cuts_a = [[] for _ in edges_a]
    cuts_b = [[] for _ in edges_b]
    tol = 1e-12
    for i, (p, q) in enumerate(edges_a):
        d = q - p
        len_d2 = d[0] ** 2 + d[1] ** 2
        if len_d2 == 0:
            continue
        for j, (r, s) in enumerate(edges_b):
            e = s - r
            denom = d[0] * e[1] - d[1] * e[0]
            diff0, diff1 = r[0] - p[0], r[1] - p[1]
            if abs(denom) > 1e-15:
                t = (diff0 * e[1] - diff1 * e[0]) / denom
                u = (diff0 * d[1] - diff1 * d[0]) / denom
                if -tol <= t <= 1 + tol and -tol <= u <= 1 + tol:
                    point = (p[0] + t * d[0], p[1] + t * d[1])
                    if tol < t < 1 - tol:
                        cuts_a[i].append((t, point))
                    if tol < u < 1 - tol:
                        cuts_b[j].append((u, point))
            else:
                # parallel: collinear overlaps split each edge at the
                # other's endpoints (the endpoints themselves are the
                # shared points, exact on both sides)
                cross = d[0] * diff1 - d[1] * diff0
                if abs(cross) > 1e-9 * np.sqrt(len_d2) * max(
                    1.0, np.hypot(e[0], e[1])
                ):
                    continue
                len_e2 = e[0] ** 2 + e[1] ** 2
                for pt in (r, s):
                    tt = (
                        (pt[0] - p[0]) * d[0] + (pt[1] - p[1]) * d[1]
                    ) / len_d2
                    if tol < tt < 1 - tol:
                        cuts_a[i].append((tt, (float(pt[0]), float(pt[1]))))
                if len_e2 > 0:
                    for pt in (p, q):
                        uu = (
                            (pt[0] - r[0]) * e[0] + (pt[1] - r[1]) * e[1]
                        ) / len_e2
                        if tol < uu < 1 - tol:
                            cuts_b[j].append(
                                (uu, (float(pt[0]), float(pt[1])))
                            )
    frags = []
    for edges, cuts in ((edges_a, cuts_a), (edges_b, cuts_b)):
        for (p, q), edge_cuts in zip(edges, cuts):
            chain = [(0.0, (float(p[0]), float(p[1])))]
            chain += sorted(edge_cuts)
            chain.append((1.0, (float(q[0]), float(q[1]))))
            for (t0, pt0), (t1, pt1) in zip(chain[:-1], chain[1:]):
                if t1 - t0 < tol:
                    continue
                frags.append((pt0, pt1))
    return frags


def _stitch(fragments, reps, eps, dropped=()):
    """Stitch directed fragments (pairs of cluster labels into ``reps``)
    into closed rings.

    At a multi-way vertex (e.g. two result parts pinching at a point) the
    walk picks the outgoing fragment making the tightest turn that keeps
    the interior-on-the-left face closed: the first outgoing direction
    encountered rotating CLOCKWISE from the reversed incoming direction
    (standard planar face traversal).

    A dead end (a fragment lost to degenerate tangency classification)
    degrades gracefully: ``dropped`` fragments were classified as not on
    the result boundary but still connect the arrangement graph, so the
    walk first tries the shortest hop-path through them to a node where
    it can resume (these passages are sub-resolution, e.g. the walls of a
    collapsed sliver).  Failing that, bridge to the nearest unused
    fragment start within ``8 * eps``, else abandon just this chain
    instead of poisoning the remaining rings."""
    start_map = {}
    for idx, (kp, kq) in enumerate(fragments):
        start_map.setdefault(kp, []).append(idx)
    drop_adj = {}
    for kp, kq in dropped:
        drop_adj.setdefault(kp, set()).add(kq)
        drop_adj.setdefault(kq, set()).add(kp)
    used = [False] * len(fragments)
    rings = []
    for i in range(len(fragments)):
        if used[i]:
            continue
        chain = [fragments[i][0], fragments[i][1]]
        used[i] = True
        guard = 0
        while guard <= len(fragments):
            guard += 1
            head = chain[-1]
            candidates = [j for j in start_map.get(head, []) if not used[j]]
            if not candidates and drop_adj:
                path = _drop_path(head, drop_adj, start_map, used, chain[0])
                if path:
                    chain.extend(path)
                    if chain[-1] == chain[0]:
                        break
                    head = chain[-1]
                    candidates = [
                        j for j in start_map.get(head, []) if not used[j]
                    ]
            if not candidates:
                # bridge a snap-tolerance gap to the nearest unused start
                hx, hy = reps[head]
                best = None
                best_d = 8.0 * eps
                for j, frag in enumerate(fragments):
                    if used[j] or frag[0] == head:
                        continue
                    sx, sy = reps[frag[0]]
                    d = np.hypot(sx - hx, sy - hy)
                    if d < best_d:
                        best, best_d = j, d
                if best is None:
                    break
                candidates = [best]
            if len(candidates) == 1:
                j = candidates[0]
            else:
                px, py = reps[chain[-2]]
                hx, hy = reps[head]
                a_in = np.arctan2(py - hy, px - hx)  # reversed incoming

                def cw_angle(idx_):
                    tx, ty = reps[fragments[idx_][1]]
                    a_out = np.arctan2(ty - hy, tx - hx)
                    return (a_in - a_out) % (2.0 * np.pi) or 2.0 * np.pi

                j = min(candidates, key=cw_angle)
            used[j] = True
            if fragments[j][0] != chain[-1]:
                chain.append(fragments[j][0])  # bridged gap
            chain.append(fragments[j][1])
            if chain[-1] == chain[0]:
                break
        if len(chain) >= 4 and chain[-1] == chain[0]:
            ring = np.array([reps[k] for k in chain])
            if abs(_ring_area(ring)) > 0.0:
                rings.append(ring)
    return rings


def _drop_path(head, drop_adj, start_map, used, ring_start):
    """Shortest hop-path from ``head`` through dropped (non-boundary)
    fragments to a node where the boundary walk can resume: one with an
    unused outgoing kept fragment, or the ring start (closing the ring).
    Returns the node path EXCLUDING ``head``, or None."""
    if head not in drop_adj:
        return None
    prev = {head: None}
    queue = [head]
    goal = None
    while queue and goal is None:
        next_queue = []
        for node in queue:
            for nxt in drop_adj.get(node, ()):
                if nxt in prev:
                    continue
                prev[nxt] = node
                if nxt == ring_start or any(
                    not used[j] for j in start_map.get(nxt, ())
                ):
                    goal = nxt
                    break
                next_queue.append(nxt)
            if goal is not None:
                break
        queue = next_queue
    if goal is None:
        return None
    path = []
    node = goal
    while node != head:
        path.append(node)
        node = prev[node]
    path.reverse()
    return path


def _assemble(rings):
    """Build (Multi)Polygon from stitched rings.

    Fragments were oriented with the result interior on the LEFT, so a
    stitched ring is an exterior iff counter-clockwise (positive signed
    area) and a hole iff clockwise -- no point-in-ring depth guessing,
    which misfires when rings touch at vertices."""
    if not rings:
        return Polygon()
    exteriors = []
    holes = []
    for ring in rings:
        (exteriors if _ring_area(ring) > 0 else holes).append(ring)
    if not exteriors:
        return Polygon()
    # assign each hole to the smallest exterior containing it (nesting:
    # island-in-lake holes belong to the inner exterior)
    ext_areas = [_ring_area(r) for r in exteriors]
    hole_lists = [[] for _ in exteriors]
    for hole in holes:
        px, py = _interior_probe(hole)
        best = None
        for i, ext in enumerate(exteriors):
            if _point_in_ring(px, py, ext) and (
                best is None or ext_areas[i] < ext_areas[best]
            ):
                best = i
        if best is not None:
            hole_lists[best].append(hole)
    polys = [
        Polygon(ext, hl) for ext, hl in zip(exteriors, hole_lists)
    ]
    if len(polys) == 1:
        return polys[0]
    return MultiPolygon(polys)


def _interior_probe(ring):
    """A point just inside the area enclosed by ``ring`` (for a clockwise
    hole ring, the cavity is to the RIGHT of travel)."""
    seg = np.diff(ring, axis=0)
    lengths = np.hypot(seg[:, 0], seg[:, 1])
    i = int(np.argmax(lengths))
    mx, my = (ring[i] + ring[i + 1]) / 2.0
    ux, uy = seg[i] / lengths[i]
    side = -1.0 if _ring_area(ring) > 0 else 1.0  # left for CCW, right for CW
    off = 1e-9 * max(1.0, abs(mx), abs(my), lengths[i])
    # right normal of (ux, uy) is (uy, -ux)
    return mx + side * -uy * off, my + side * ux * off
