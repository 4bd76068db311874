"""WKT / WKB / GeoJSON serialization for the geometry engine.

Counterpart of dask_geomodeling_tpu/geo/_wkt.py, copied: it replaces
shapely.wkt/wkb for GeometryWKTSource and RasterizeWKT.
"""
import re
import struct

import numpy as np

from dask_geomodeling_tpu_torch.geo.geometry import (
    Geometry,
    GeometryCollection,
    LineString,
    MultiLineString,
    MultiPoint,
    MultiPolygon,
    Point,
    Polygon,
    WKTReadingError,
)

_WKB_CODES = {
    "Point": 1,
    "LineString": 2,
    "Polygon": 3,
    "MultiPoint": 4,
    "MultiLineString": 5,
    "MultiPolygon": 6,
    "GeometryCollection": 7,
}
_WKB_TYPES = {v: k for k, v in _WKB_CODES.items()}


def _fmt_num(v):
    v = float(v)  # numpy scalars would otherwise leak their repr
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _fmt_coords(arr):
    return ", ".join("{} {}".format(_fmt_num(x), _fmt_num(y)) for x, y in arr)


def dumps(geom):
    """Geometry -> WKT string."""
    t = geom.geom_type.upper()
    if geom.is_empty:
        return "{} EMPTY".format(t)
    if isinstance(geom, Point):
        return "POINT ({} {})".format(_fmt_num(geom.x), _fmt_num(geom.y))
    if isinstance(geom, LineString):
        return "{} ({})".format(
            "LINESTRING" if geom.geom_type != "LinearRing" else "LINEARRING",
            _fmt_coords(geom.coordinates),
        )
    if isinstance(geom, Polygon):
        rings = ["({})".format(_fmt_coords(r)) for r in geom._rings()]
        return "POLYGON ({})".format(", ".join(rings))
    if isinstance(geom, MultiPoint):
        return "MULTIPOINT ({})".format(
            ", ".join("({} {})".format(_fmt_num(p.x), _fmt_num(p.y)) for p in geom)
        )
    if isinstance(geom, MultiLineString):
        return "MULTILINESTRING ({})".format(
            ", ".join("({})".format(_fmt_coords(g.coordinates)) for g in geom)
        )
    if isinstance(geom, MultiPolygon):
        polys = []
        for p in geom:
            rings = ["({})".format(_fmt_coords(r)) for r in p._rings()]
            polys.append("({})".format(", ".join(rings)))
        return "MULTIPOLYGON ({})".format(", ".join(polys))
    if isinstance(geom, GeometryCollection):
        return "GEOMETRYCOLLECTION ({})".format(
            ", ".join(dumps(g) for g in geom.geoms)
        )
    raise TypeError("Cannot serialize %r" % type(geom))


# --- WKT parsing: tokenizing nested parentheses ---

_TYPE_RE = re.compile(r"^\s*([A-Za-z]+)\s*(.*)$", re.S)


def loads(text):
    """WKT string -> Geometry."""
    match = _TYPE_RE.match(text)
    if not match:
        raise WKTReadingError("Invalid WKT: %r" % text[:60])
    gtype = match.group(1).upper()
    rest = match.group(2).strip()
    if rest.upper().startswith("EMPTY"):
        return {
            "POINT": Point(float("nan"), float("nan")),
            "LINESTRING": LineString([]),
            "POLYGON": Polygon(),
            "MULTIPOINT": MultiPoint(),
            "MULTILINESTRING": MultiLineString(),
            "MULTIPOLYGON": MultiPolygon(),
            "GEOMETRYCOLLECTION": GeometryCollection(),
        }[gtype]
    body = _parse_parens(rest)
    try:
        if gtype == "POINT":
            return Point(*_parse_coord_list(body)[0])
        if gtype in ("LINESTRING", "LINEARRING"):
            return LineString(_parse_coord_list(body))
        if gtype == "POLYGON":
            rings = [_parse_coord_list(r) for r in _split_nested(body)]
            return Polygon(rings[0], rings[1:])
        if gtype == "MULTIPOINT":
            body2 = body.replace("(", "").replace(")", "")
            return MultiPoint([Point(*c) for c in _parse_coord_list(body2)])
        if gtype == "MULTILINESTRING":
            return MultiLineString(
                [LineString(_parse_coord_list(s)) for s in _split_nested(body)]
            )
        if gtype == "MULTIPOLYGON":
            polys = []
            for poly_body in _split_nested(body):
                rings = [_parse_coord_list(r) for r in _split_nested(poly_body)]
                polys.append(Polygon(rings[0], rings[1:]))
            return MultiPolygon(polys)
        if gtype == "GEOMETRYCOLLECTION":
            return GeometryCollection([loads(s) for s in _split_toplevel(body)])
    except (ValueError, IndexError) as e:
        raise WKTReadingError("Invalid WKT: {}".format(e))
    raise WKTReadingError("Unsupported WKT type: %s" % gtype)


def _parse_parens(text):
    """Strip one level of outer parentheses."""
    text = text.strip()
    if not text.startswith("("):
        raise WKTReadingError("Expected '(' in WKT")
    depth = 0
    for i, ch in enumerate(text):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                return text[1:i]
    raise WKTReadingError("Unbalanced parentheses in WKT")


def _split_nested(body):
    """Split '(...), (...)' into the inner bodies."""
    parts = []
    depth = 0
    start = None
    for i, ch in enumerate(body):
        if ch == "(":
            if depth == 0:
                start = i + 1
            depth += 1
        elif ch == ")":
            depth -= 1
            if depth == 0:
                parts.append(body[start:i])
    return parts


def _split_toplevel(body):
    """Split a geometry collection body on top-level commas."""
    parts = []
    depth = 0
    start = 0
    for i, ch in enumerate(body):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(body[start:i])
            start = i + 1
    parts.append(body[start:])
    return [p.strip() for p in parts if p.strip()]


def _parse_coord_list(body):
    coords = []
    for pair in body.split(","):
        vals = pair.split()
        if len(vals) < 2:
            raise WKTReadingError("Invalid coordinate: %r" % pair)
        coords.append((float(vals[0]), float(vals[1])))
    return coords


# --- WKB ---


def dumps_wkb(geom):
    """Geometry -> ISO WKB bytes (little-endian, 2D)."""
    out = bytearray()
    _wkb_write(geom, out)
    return bytes(out)


def _wkb_write(geom, out):
    out += b"\x01"  # little endian
    code = _WKB_CODES[geom.geom_type if geom.geom_type != "LinearRing" else "LineString"]
    out += struct.pack("<I", code)
    if isinstance(geom, Point):
        out += struct.pack("<dd", geom.x, geom.y)
    elif isinstance(geom, LineString):
        out += struct.pack("<I", len(geom.coordinates))
        out += np.asarray(geom.coordinates, "<f8").tobytes()
    elif isinstance(geom, Polygon):
        rings = [] if geom.is_empty else geom._rings()
        out += struct.pack("<I", len(rings))
        for ring in rings:
            out += struct.pack("<I", len(ring))
            out += np.asarray(ring, "<f8").tobytes()
    else:  # multi / collection
        out += struct.pack("<I", len(geom.geoms))
        for g in geom.geoms:
            _wkb_write(g, out)


def loads_wkb(data):
    """ISO WKB bytes -> Geometry."""
    geom, _ = _wkb_read(memoryview(data), 0)
    return geom


def _wkb_read(buf, pos):
    little = buf[pos] == 1
    fmt = "<" if little else ">"
    (code,) = struct.unpack_from(fmt + "I", buf, pos + 1)
    pos += 5
    # EWKB (PostGIS) dimensionality/SRID flags...
    has_z = bool(code & 0x80000000)
    has_m = bool(code & 0x40000000)
    if code & 0x20000000:
        pos += 4  # skip the embedded SRID
    base = code & 0x0FFFFFFF
    # ...and ISO WKB type offsets (1000=Z, 2000=M, 3000=ZM)
    iso = (base % 0x20000000) // 1000
    if iso in (1, 3):
        has_z = True
    if iso in (2, 3):
        has_m = True
    base = base % 1000
    dims = 2 + has_z + has_m
    stride = 8 * dims
    gtype = _WKB_TYPES.get(base)
    if gtype is None:
        raise WKTReadingError("Unsupported WKB geometry code: %d" % code)
    if gtype == "Point":
        coords = struct.unpack_from(fmt + "d" * dims, buf, pos)
        return Point(coords[0], coords[1]), pos + stride
    if gtype == "LineString":
        (n,) = struct.unpack_from(fmt + "I", buf, pos)
        pos += 4
        arr = np.frombuffer(buf, dtype=fmt + "f8", count=n * dims, offset=pos)
        return LineString(arr.reshape(n, dims)[:, :2].copy()), pos + n * stride
    if gtype == "Polygon":
        (nrings,) = struct.unpack_from(fmt + "I", buf, pos)
        pos += 4
        rings = []
        for _ in range(nrings):
            (n,) = struct.unpack_from(fmt + "I", buf, pos)
            pos += 4
            arr = np.frombuffer(buf, dtype=fmt + "f8", count=n * dims, offset=pos)
            rings.append(arr.reshape(n, dims)[:, :2].copy())
            pos += n * stride
        if not rings:
            return Polygon(), pos
        return Polygon(rings[0], rings[1:]), pos
    # multi / collection
    (n,) = struct.unpack_from(fmt + "I", buf, pos)
    pos += 4
    geoms = []
    for _ in range(n):
        g, pos = _wkb_read(buf, pos)
        geoms.append(g)
    cls = {
        "MultiPoint": MultiPoint,
        "MultiLineString": MultiLineString,
        "MultiPolygon": MultiPolygon,
        "GeometryCollection": GeometryCollection,
    }[gtype]
    return cls(geoms), pos


# --- GeoJSON (__geo_interface__) ---


def to_geo_interface(geom):
    """Geometry -> __geo_interface__ dict."""
    t = geom.geom_type
    if isinstance(geom, Point):
        return {"type": t, "coordinates": (geom.x, geom.y)}
    if isinstance(geom, LineString):
        return {"type": "LineString", "coordinates": [tuple(c) for c in geom.coordinates]}
    if isinstance(geom, Polygon):
        return {
            "type": t,
            "coordinates": [[tuple(c) for c in r] for r in ([] if geom.is_empty else geom._rings())],
        }
    if isinstance(geom, MultiPoint):
        return {"type": t, "coordinates": [(p.x, p.y) for p in geom]}
    if isinstance(geom, MultiLineString):
        return {
            "type": t,
            "coordinates": [[tuple(c) for c in g.coordinates] for g in geom],
        }
    if isinstance(geom, MultiPolygon):
        return {
            "type": t,
            "coordinates": [
                [[tuple(c) for c in r] for r in p._rings()] for p in geom
            ],
        }
    if isinstance(geom, GeometryCollection):
        return {
            "type": t,
            "geometries": [to_geo_interface(g) for g in geom.geoms],
        }
    raise TypeError("Cannot serialize %r" % type(geom))
