"""MapInfo Interchange Format (MIF/MID) reader and writer: the port's
copy of dask_geomodeling_tpu/io/mapinfo.py on the pandas-free frame.

The MIF header (Version/Delimiter/Columns/CoordSys), the geometry
section (Point, Multipoint, Line, Pline [Multiple], Region, Rect, none)
and the MID attribute rows.  Binary ``.tab`` files are out of scope.

CoordSys: ``Earth Projection 1, <datum>`` (longlat) reads as EPSG:4326;
any other CoordSys line is kept verbatim as the frame's ``crs``.  A
geographic frame writes ``CoordSys Earth Projection 1, 104``, a frame
whose crs is a CoordSys line writes that line, and any other (EPSG:28992
among them) writes ``CoordSys NonEarth Units "m"``, which reads back as
that verbatim string: a GeometryFileSource over such a file then fails
to reproject, in both packages.
"""
import csv
import os

import numpy as np

__all__ = ["read_mif", "write_mif"]


def _parse_coordsys(line):
    body = line.split(None, 1)[1].strip() if " " in line else ""
    parts = [p.strip() for p in body.replace(",", " ").split()]
    if (len(parts) >= 3 and parts[0].lower() == "earth"
            and parts[1].lower() == "projection" and parts[2] == "1"):
        return "EPSG:4326"
    return line.strip() or "EPSG:4326"


def _coords(tokens):
    return [(float(tokens[k]), float(tokens[k + 1])) for k in range(0, len(tokens), 2)]


def _point_in_ring(point, ring):
    """Even-odd crossing test of ``point`` against a coordinate ring."""
    x, y = point
    inside = False
    for (x1, y1), (x2, y2) in zip(ring, ring[1:] + ring[:1]):
        if (y1 > y) != (y2 > y):
            x_cross = x1 + (y - y1) * (x2 - x1) / (y2 - y1)
            if x < x_cross:
                inside = not inside
    return inside


def _region_to_geometry(rings):
    """MIF Region rings -> Polygon/MultiPolygon by even-odd containment:
    a ring inside an odd number of others is a hole of its innermost
    container, otherwise a part's exterior (GDAL's grouping)."""
    from dask_geomodeling_tpu_torch.geo.geometry import MultiPolygon, Polygon

    if len(rings) == 1:
        return Polygon(rings[0])
    containers = []
    for index, ring in enumerate(rings):
        containers.append([other for other in range(len(rings))
                           if other != index and _point_in_ring(ring[0], rings[other])])
    exteriors = [i for i, inside in enumerate(containers) if len(inside) % 2 == 0]
    holes_of = {i: [] for i in exteriors}
    for index, inside in enumerate(containers):
        if len(inside) % 2 == 1:
            parents = [i for i in inside if i in holes_of]
            if parents:
                parent = max(parents, key=lambda i: len(containers[i]))
                holes_of[parent].append(rings[index])
    parts = [Polygon(rings[i], holes_of[i] or None) for i in exteriors]
    if len(parts) == 1:
        return parts[0]
    return MultiPolygon(parts)


_MIF_TYPES = {
    "integer": "int64",
    "smallint": "int64",
    "float": "float64",
    "decimal": "float64",
    "char": "object",
    "date": "object",
    "logical": "bool",
}


def _read_header(lines):
    """(position of the first geometry line, delimiter, [(name, type)],
    crs) of a MIF file's lines."""
    pos = 0
    delimiter = "\t"
    columns = []
    crs = "EPSG:4326"
    while pos < len(lines):
        stripped = lines[pos].strip()
        lowered = stripped.lower()
        if lowered.startswith("delimiter"):
            quoted = stripped.split(None, 1)[1].strip()
            delimiter = quoted.strip("\"'") or "\t"
        elif lowered.startswith("coordsys"):
            crs = _parse_coordsys(stripped)
        elif lowered.startswith("columns"):
            count = int(stripped.split()[1])
            for _ in range(count):
                pos += 1
                name, ctype = lines[pos].split(None, 1)
                base = ctype.split("(")[0].strip().lower()
                columns.append((name, _MIF_TYPES.get(base, "object")))
        elif lowered == "data":
            pos += 1
            break
        pos += 1
    return pos, delimiter, columns, crs


def _read_geometries(lines, pos):
    from dask_geomodeling_tpu_torch.geo.geometry import (
        LineString,
        MultiLineString,
        MultiPoint,
        Point,
        box,
    )

    geometries = []

    def read_points(count):
        nonlocal pos
        points = []
        while len(points) < count:
            points.extend(_coords(lines[pos].split()))
            pos += 1
        return points

    def read_counted_sections(n_sections):
        nonlocal pos
        rings = []
        for _ in range(n_sections):
            count = int(lines[pos].split()[0])
            pos += 1
            rings.append(read_points(count))
        return rings

    while pos < len(lines):
        tokens = lines[pos].split()
        pos += 1
        if not tokens:
            continue
        kind = tokens[0].lower()
        if kind == "point":
            geometries.append(Point(float(tokens[1]), float(tokens[2])))
        elif kind == "multipoint":
            geometries.append(MultiPoint([Point(*p) for p in read_points(int(tokens[1]))]))
        elif kind == "line":
            geometries.append(LineString([(float(tokens[1]), float(tokens[2])),
                                          (float(tokens[3]), float(tokens[4]))]))
        elif kind == "pline":
            if len(tokens) >= 3 and tokens[1].lower() == "multiple":
                parts = read_counted_sections(int(tokens[2]))
                geometries.append(MultiLineString([LineString(p) for p in parts]))
            else:
                # the count may sit on this line or the next
                if len(tokens) > 1:
                    count = int(tokens[1])
                else:
                    count = int(lines[pos].split()[0])
                    pos += 1
                geometries.append(LineString(read_points(count)))
        elif kind == "region":
            geometries.append(_region_to_geometry(read_counted_sections(int(tokens[1]))))
        elif kind == "rect":
            x1, y1, x2, y2 = (float(v) for v in tokens[1:5])
            geometries.append(box(min(x1, x2), min(y1, y2), max(x1, x2), max(y1, y2)))
        elif kind == "none":
            geometries.append(None)
        # styling clauses (Pen/Brush/Symbol/Smooth/Center) are skipped
    return geometries


def _read_mid(path, delimiter, columns):
    """The MID sidecar's rows, typed by the MIF's Columns."""
    base, _ = os.path.splitext(path)
    mid = next((base + ext for ext in (".mid", ".MID") if os.path.exists(base + ext)), None)
    rows = []
    if mid is None:
        return rows
    with open(mid, newline="", errors="replace") as handle:
        for values in csv.reader(handle, delimiter=delimiter, quotechar='"'):
            if not values:
                continue
            row = {}
            for (name, ctype), value in zip(columns, values):
                value = value.strip()
                if ctype == "int64":
                    row[name] = int(value) if value else 0
                elif ctype == "float64":
                    row[name] = float(value) if value else np.nan
                elif ctype == "bool":
                    row[name] = value.upper() in ("T", "TRUE", "1")
                else:
                    row[name] = value
            rows.append(row)
    return rows


def read_mif(path):
    """Read a MIF (+ optional MID) file into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame

    with open(path, errors="replace") as stream:
        lines = stream.read().splitlines()
    pos, delimiter, columns, crs = _read_header(lines)
    geometries = _read_geometries(lines, pos)
    if not columns:
        return GeoDataFrame(geometry=geometries, crs=crs)
    rows = _read_mid(path, delimiter, columns)
    if rows:
        table = GeoDataFrame.from_records(rows)
    else:
        table = GeoDataFrame({name: np.empty(0, dtype=ctype) for name, ctype in columns})
    if len(table) != len(geometries):
        raise ValueError("Length of values (%d) does not match length of index (%d)"
                         % (len(geometries), len(table)))
    return GeoDataFrame(table, geometry=geometries, crs=crs)


def _mif_column_type(values):
    kind = values.dtype.kind
    if kind == "b":
        return "Logical"
    if kind in "iu":
        return "Integer"
    if kind == "f":
        return "Float"
    return "Char(254)"


def _ring_lines(rings):
    out = ["Region %d" % len(rings)]
    for ring in rings:
        out.append("%d" % len(ring))
        out += ["%.10g %.10g" % (x, y) for x, y in ring]
    return out


def _geometry_section(geom):
    if geom is None:
        return ["None"]
    kind = geom.geom_type
    if kind == "Point":
        return ["Point %.10g %.10g" % (geom.x, geom.y)]
    if kind == "MultiPoint":
        pts = list(geom.geoms)
        return ["Multipoint %d" % len(pts)] + ["%.10g %.10g" % (p.x, p.y) for p in pts]
    if kind == "LineString":
        coords = list(geom.coords)
        return ["Pline %d" % len(coords)] + ["%.10g %.10g" % (x, y) for x, y in coords]
    if kind == "MultiLineString":
        parts = list(geom.geoms)
        out = ["Pline Multiple %d" % len(parts)]
        for part in parts:
            coords = list(part.coords)
            out.append("%d" % len(coords))
            out += ["%.10g %.10g" % (x, y) for x, y in coords]
        return out
    if kind == "Polygon":
        return _ring_lines([list(geom.exterior.coords)]
                           + [list(ring.coords) for ring in geom.interiors])
    if kind == "MultiPolygon":
        rings = []
        for poly in geom.geoms:
            rings.append(list(poly.exterior.coords))
            rings.extend(list(r.coords) for r in poly.interiors)
        return _ring_lines(rings)
    raise NotImplementedError("MIF cannot store %s" % kind)


def _mid_cell(value):
    if isinstance(value, str):
        return value
    if isinstance(value, (bool, np.bool_)):
        return "T" if value else "F"
    if value is None or (isinstance(value, float) and np.isnan(value)):
        return ""
    return str(value)


def write_mif(frame, path):
    """Write a GeoDataFrame as MIF + MID."""
    crs = getattr(frame, "crs", None) or "EPSG:4326"
    try:
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        earth = get_sr(crs).is_geographic
    except Exception:
        earth = False
    if earth:
        coordsys = "CoordSys Earth Projection 1, 104"
    elif str(crs).lower().startswith("coordsys"):
        coordsys = str(crs)
    else:
        coordsys = 'CoordSys NonEarth Units "m"'

    fields = [c for c in frame.columns if c != "geometry"]
    lines = ["Version 300", 'Charset "Neutral"', 'Delimiter ","', coordsys,
             "Columns %d" % len(fields)]
    for name in fields:
        lines.append("  %s %s" % (name, _mif_column_type(frame[name])))
    lines.append("Data")
    lines.append("")
    for geom in frame.geometry:
        lines.extend(_geometry_section(geom))
    with open(path, "w") as stream:
        stream.write("\n".join(lines) + "\n")

    base, _ = os.path.splitext(path)
    with open(base + ".mid", "w", newline="") as f:
        writer = csv.writer(f, delimiter=",", quotechar='"', quoting=csv.QUOTE_MINIMAL)
        for _, row in frame.iterrows():
            writer.writerow([_mid_cell(row[name]) for name in fields])
