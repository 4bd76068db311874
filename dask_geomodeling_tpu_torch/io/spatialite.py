"""SpatiaLite vector databases (.sqlite): the port's copy of
dask_geomodeling_tpu/io/spatialite.py on the pandas-free frame.

Geometries use SpatiaLite's own BLOB encoding: a ``0x00`` start byte,
an endianness flag, the SRID, an MBR, a ``0x7C`` marker, then the
geometry as a class-type int plus WKB-layout coordinates (collection
members are prefixed with a ``0x69`` entity marker), terminated by
``0xFE``.  Layer discovery rides the ``geometry_columns`` metadata
table (both the legacy ``type`` text and the 4.x ``geometry_type``
int schemas are accepted on read; writes emit the 4.x schema, the same
tables and rows as the JAX writer, with an ``idx_<table>_<column>``
R-tree).  The SRID comes from the port's CRS layer (``crs_to_srs``,
``get_sr``).
"""
import os
import sqlite3
import struct

import numpy as np

__all__ = ["read_spatialite", "write_spatialite", "parse_blob", "make_blob"]

_TYPES = {
    1: "Point", 2: "LineString", 3: "Polygon",
    4: "MultiPoint", 5: "MultiLineString", 6: "MultiPolygon",
    7: "GeometryCollection",
}
_CODES = {v: k for k, v in _TYPES.items()}


def _parse_body(buf, pos, code, order):
    """GeoJSON-style mapping for one geometry body at ``pos``."""
    if code >= 1000000:
        # compressed classes (f32 delta coordinates) are a different
        # wire layout, not a dimensioned variant of the plain classes
        raise NotImplementedError("SpatiaLite compressed geometry class %d" % code)
    base = code % 1000
    extra = {1000: 1, 2000: 1, 3000: 2}.get(code - base, 0)  # z/m slots
    kind = _TYPES.get(base)
    if kind is None:
        raise NotImplementedError("SpatiaLite geometry class %d" % code)

    def read_point():
        nonlocal pos
        values = struct.unpack_from(order + "%dd" % (2 + extra), buf, pos)
        pos += 8 * (2 + extra)
        return list(values[:2])

    def read_count():
        nonlocal pos
        (n,) = struct.unpack_from(order + "i", buf, pos)
        pos += 4
        return n

    if kind == "Point":
        return {"type": kind, "coordinates": read_point()}, pos
    if kind == "LineString":
        coords = [read_point() for _ in range(read_count())]
        return {"type": kind, "coordinates": coords}, pos
    if kind == "Polygon":
        rings = []
        for _ in range(read_count()):
            rings.append([read_point() for _ in range(read_count())])
        return {"type": kind, "coordinates": rings}, pos
    # collections: n entities, each 0x69 + class-type int + body
    members = []
    for _ in range(read_count()):
        if buf[pos] != 0x69:
            raise IOError("SpatiaLite blob: missing entity marker")
        (member_code,) = struct.unpack_from(order + "i", buf, pos + 1)
        member, pos = _parse_body(buf, pos + 5, member_code, order)
        members.append(member)
    if kind == "GeometryCollection":
        return {"type": kind, "geometries": members}, pos
    return {"type": kind, "coordinates": [m["coordinates"] for m in members]}, pos


def parse_blob(blob):
    """Decode a SpatiaLite geometry BLOB into a geometry object."""
    from dask_geomodeling_tpu_torch.geo.geometry import shape

    if not blob or len(blob) < 44 or blob[0] != 0x00 or blob[38] != 0x7C:
        raise IOError("Not a SpatiaLite geometry blob")
    order = "<" if blob[1] == 1 else ">"
    (code,) = struct.unpack_from(order + "i", blob, 39)
    try:
        mapping, _ = _parse_body(blob, 43, code, order)
    except struct.error:
        raise IOError("Truncated SpatiaLite geometry blob")
    return shape(mapping)


def _body_bytes(mapping):
    kind = mapping["type"]
    out = bytearray()

    def put_point(point):
        out.extend(struct.pack("<2d", float(point[0]), float(point[1])))

    if kind == "Point":
        put_point(mapping["coordinates"])
    elif kind == "LineString":
        out.extend(struct.pack("<i", len(mapping["coordinates"])))
        for point in mapping["coordinates"]:
            put_point(point)
    elif kind == "Polygon":
        out.extend(struct.pack("<i", len(mapping["coordinates"])))
        for ring in mapping["coordinates"]:
            out.extend(struct.pack("<i", len(ring)))
            for point in ring:
                put_point(point)
    elif kind in ("MultiPoint", "MultiLineString", "MultiPolygon"):
        member_kind = kind[5:]
        out.extend(struct.pack("<i", len(mapping["coordinates"])))
        for coordinates in mapping["coordinates"]:
            out.append(0x69)
            out.extend(struct.pack("<i", _CODES[member_kind]))
            out.extend(_body_bytes({"type": member_kind, "coordinates": coordinates}))
    elif kind == "GeometryCollection":
        members = mapping["geometries"]
        out.extend(struct.pack("<i", len(members)))
        for member in members:
            out.append(0x69)
            out.extend(struct.pack("<i", _CODES[member["type"]]))
            out.extend(_body_bytes(member))
    else:
        raise NotImplementedError("Cannot write %s to SpatiaLite" % kind)
    return bytes(out)


def make_blob(geom, srid):
    """Encode a geometry as a SpatiaLite BLOB (little-endian, 2D)."""
    mapping = geom.__geo_interface__
    x1, y1, x2, y2 = geom.bounds
    head = bytearray(b"\x00\x01")
    head.extend(struct.pack("<i", srid))
    head.extend(struct.pack("<4d", x1, y1, x2, y2))
    head.append(0x7C)
    head.extend(struct.pack("<i", _CODES[mapping["type"]]))
    head.extend(_body_bytes(mapping))
    head.append(0xFE)
    return bytes(head)


def _srid_of(crs):
    from dask_geomodeling_tpu_torch.geo import crs_to_srs

    srs = crs_to_srs(crs) if crs else None
    if srs and srs.upper().startswith("EPSG:"):
        return int(srs.split(":")[1])
    return 0


def read_spatialite(path, layer=None):
    """Read one table of a SpatiaLite database into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.geo.features import Index
    from dask_geomodeling_tpu_torch.io.vectorfile import _frame, _index_values

    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    try:
        try:
            tables = con.execute(
                "SELECT f_table_name, f_geometry_column, srid FROM geometry_columns"
            ).fetchall()
        except sqlite3.OperationalError:
            raise IOError("No geometry_columns table in '%s'" % path)
        if not tables:
            raise IOError("No feature tables in '%s'" % path)
        if layer is None:
            chosen = tables[0]
        else:
            matching = [t for t in tables if t["f_table_name"] == layer]
            if not matching:
                raise IOError("Layer '%s' not found in '%s'" % (layer, path))
            chosen = matching[0]
        table = chosen["f_table_name"]
        geom_col = chosen["f_geometry_column"]
        srid = chosen["srid"]

        # identifier-quote the table name (a crafted geometry_columns row
        # with an embedded '"' must fail cleanly, not change the query)
        rows = con.execute('SELECT * FROM "{}"'.format(table.replace('"', '""'))).fetchall()
        geometries, records, fids = [], [], []
        for row in rows:
            row = dict(row)
            if "fid" in row:
                fids.append(row.pop("fid"))
            elif "PK_UID" in row:
                fids.append(row.pop("PK_UID"))
            else:
                fids.append(len(fids))
            blob = row.pop(geom_col)
            geometries.append(parse_blob(blob) if blob else None)
            records.append(row)
        frame = _frame(records, geometries, "EPSG:%d" % srid if srid else None)
        frame.index = Index(_index_values(fids), name="fid")
        return frame
    finally:
        con.close()


def write_spatialite(frame, path, layer=None):
    """Write a GeoDataFrame as a (4.x-schema) SpatiaLite table."""
    from dask_geomodeling_tpu_torch.geo import get_sr
    from dask_geomodeling_tpu_torch.io.vectorfile import _sql_value

    table = layer or "layer"
    srid = _srid_of(frame.crs)
    geometry_column = frame._geometry_column_name or "geometry"
    if os.path.exists(path):
        os.remove(path)
    con = sqlite3.connect(path)
    try:
        con.execute(
            "CREATE TABLE spatial_ref_sys (srid INTEGER PRIMARY KEY, "
            "auth_name TEXT, auth_srid INTEGER, ref_sys_name TEXT, "
            "proj4text TEXT, srtext TEXT)"
        )
        if srid:
            sr = get_sr("EPSG:%d" % srid)
            con.execute("INSERT INTO spatial_ref_sys VALUES (?,?,?,?,?,?)",
                        (srid, "epsg", srid, sr.name, "", sr.ExportToWkt()))
        con.execute(
            "CREATE TABLE geometry_columns (f_table_name TEXT, "
            "f_geometry_column TEXT, geometry_type INTEGER, "
            "coord_dimension INTEGER, srid INTEGER, "
            "spatial_index_enabled INTEGER)"
        )
        fields = [c for c in frame.columns if c != geometry_column]
        columns = ", ".join('"%s"' % f for f in ["fid"] + fields + [geometry_column])
        con.execute('CREATE TABLE "{}" ({})'.format(table, ", ".join(
            ["fid INTEGER PRIMARY KEY"] + ['"%s"' % f for f in fields]
            + ['"%s" BLOB' % geometry_column])))
        geometries = frame[geometry_column].values
        kinds = {type(g).__name__ for g in geometries if g is not None}
        code = _CODES[kinds.pop()] if len(kinds) == 1 else 0
        con.execute("INSERT INTO geometry_columns VALUES (?,?,?,?,?,?)",
                    (table, geometry_column, code, 2, srid, 1))
        # the SpatiaLite spatial index convention: an R-tree named
        # idx_<table>_<column> keyed by ROWID, flagged above with
        # spatial_index_enabled = 1
        con.execute('CREATE VIRTUAL TABLE "idx_{}_{}" USING '
                    "rtree(pkid, xmin, xmax, ymin, ymax)".format(table, geometry_column))
        # the frame index becomes the fid only when it can (unique ints);
        # otherwise fids are sequential, like the GPKG writer
        index_as_fid = frame.index.is_unique and all(
            isinstance(idx, (int, np.integer)) for idx in frame.index)
        placeholders = ", ".join("?" * (2 + len(fields)))
        insert = 'INSERT INTO "{}" ({}) VALUES ({})'.format(table, columns, placeholders)
        index_rows = []
        for i, (idx, row) in enumerate(frame.iterrows(), start=1):
            geom = row[geometry_column]
            fid = int(idx) if index_as_fid else i
            values = ([fid] + [_sql_value(row[f]) for f in fields]
                      + [make_blob(geom, srid) if geom is not None else None])
            con.execute(insert, values)
            bounds = geom.bounds if geom is not None else ()
            if len(bounds) == 4:  # null/empty geometries have no envelope
                minx, miny, maxx, maxy = bounds
                index_rows.append((fid, minx, maxx, miny, maxy))
        con.executemany('INSERT INTO "idx_{}_{}" VALUES (?,?,?,?,?)'.format(
            table, geometry_column), index_rows)
        con.commit()
    finally:
        con.close()
