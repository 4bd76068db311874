"""ESRI Shapefile codec (.shp / .shx / .dbf).

Counterpart of dask_geomodeling_tpu/io/shapefile.py on the port's
pandas-free frame: the same files (field types, widths and decimals from
the columns' dtypes), the same frames back.  Supports the geometry types
this framework produces — Point, PolyLine, Polygon (with multi-parts and
holes) — and DBF attribute columns of text/number/bool/date type; a date
reads back as a datetime64[us] column.  The CRS is written as a .prj
with the WKT of the frame's CRS.
"""
import datetime
import os
import struct

import numpy as np

from dask_geomodeling_tpu_torch.geo.features import is_null

__all__ = ["read_shapefile", "write_shapefile"]

# DBF language-driver ids -> codecs (dBase/ESRI spec subset, the OGR
# fallback when no .cpg sidecar declares the encoding)
_LDID_ENCODINGS = {
    0x01: "cp437", 0x02: "cp850", 0x03: "cp1252", 0x08: "cp865",
    0x09: "cp437", 0x0A: "cp850", 0x0B: "cp437", 0x0D: "cp437",
    0x0E: "cp850", 0x0F: "cp437", 0x10: "cp850", 0x13: "cp932",
    0x17: "cp865", 0x18: "cp437", 0x19: "cp437", 0x1A: "cp850",
    0x1B: "cp437", 0x1C: "cp863", 0x1D: "cp850", 0x1F: "cp852",
    0x22: "cp852", 0x23: "cp852", 0x24: "cp860", 0x25: "cp850",
    0x26: "cp866", 0x37: "cp850", 0x40: "cp852", 0x4D: "cp936",
    0x4E: "cp949", 0x4F: "cp950", 0x50: "cp874", 0x57: "cp1252",
    0x58: "cp1252", 0x59: "cp1252", 0x64: "cp852", 0x65: "cp866",
    0x66: "cp865", 0x67: "cp861", 0x6A: "cp737", 0x6B: "cp857",
    0x6C: "cp863", 0x78: "cp950", 0x79: "cp949", 0x7A: "cp936",
    0x7B: "cp932", 0x7C: "cp874", 0x86: "cp737", 0x87: "cp852",
    0x88: "cp857", 0xC8: "cp1250", 0xC9: "cp1251", 0xCA: "cp1254",
    0xCB: "cp1253", 0xCC: "cp1257",
}

_SHAPE_NULL = 0
_SHAPE_POINT = 1
_SHAPE_POLYLINE = 3
_SHAPE_POLYGON = 5


def _rings_of(geom):
    from dask_geomodeling_tpu_torch.geo.geometry import (
        LineString,
        MultiLineString,
        MultiPolygon,
        Point,
        Polygon,
    )

    if geom is None or geom.is_empty:
        return _SHAPE_NULL, []
    if isinstance(geom, Point):
        return _SHAPE_POINT, [(geom.x, geom.y)]
    if isinstance(geom, LineString):
        return _SHAPE_POLYLINE, [np.asarray(geom.coordinates)]
    if isinstance(geom, MultiLineString):
        return _SHAPE_POLYLINE, [np.asarray(g.coordinates) for g in geom.geoms]
    if isinstance(geom, Polygon):
        return _SHAPE_POLYGON, _oriented_rings(geom)
    if isinstance(geom, MultiPolygon):
        rings = []
        for poly in geom.geoms:
            rings.extend(_oriented_rings(poly))
        return _SHAPE_POLYGON, rings
    raise TypeError("Cannot write %r to a shapefile" % geom.geom_type)


def _oriented_rings(poly):
    """Shapefile convention: outer rings clockwise, holes counter-clockwise."""
    from dask_geomodeling_tpu_torch.geo.geometry import _ring_area

    rings = []
    shell = np.asarray(poly.shell)
    if _ring_area(shell) > 0:
        shell = shell[::-1]
    rings.append(shell)
    for hole in poly.holes:
        hole = np.asarray(hole)
        if _ring_area(hole) < 0:
            hole = hole[::-1]
        rings.append(hole)
    return rings


def _encode_record(shape_type, parts):
    if shape_type == _SHAPE_NULL:
        return struct.pack("<i", _SHAPE_NULL)
    if shape_type == _SHAPE_POINT:
        x, y = parts[0]
        return struct.pack("<idd", _SHAPE_POINT, x, y)
    all_points = np.concatenate(parts)
    bbox = (
        all_points[:, 0].min(),
        all_points[:, 1].min(),
        all_points[:, 0].max(),
        all_points[:, 1].max(),
    )
    out = struct.pack("<i4d", shape_type, *bbox)
    out += struct.pack("<ii", len(parts), len(all_points))
    offset = 0
    for part in parts:
        out += struct.pack("<i", offset)
        offset += len(part)
    out += np.asarray(all_points, "<f8").tobytes()
    return out


def _dbf_fields(frame, columns):
    fields = []
    for col in columns:
        series = frame[col]
        kind = series.dtype.kind
        if kind == "b":
            fields.append((col, "L", 1, 0))
        elif kind in "iu":
            width = max(
                [len(str(int(v))) for v in series if not is_null(v)] + [1]
            )
            fields.append((col, "N", min(max(width, 10), 20), 0))
        elif kind == "f":
            fields.append((col, "N", 24, 8))
        elif kind == "M":
            fields.append((col, "D", 8, 0))  # DBF date: YYYYMMDD
        else:
            # DBF character widths count BYTES; size for the UTF-8 encoding
            width = max(
                [len(str(v).encode("utf-8")) for v in series if v is not None]
                + [1]
            )
            fields.append((col, "C", min(width, 254), 0))
    return fields


def _date_text(value):
    """YYYYMMDD of a date cell: a datetime or date (a datetime64 column's
    cells as ``iterrows`` gives them), or a numpy datetime64."""
    if isinstance(value, np.datetime64):
        return str(value.astype("datetime64[D]")).replace("-", "")
    return value.strftime("%Y%m%d")


def _dbf_text(text, width):
    """UTF-8 bytes padded/truncated to ``width`` without split chars."""
    raw = text.encode("utf-8")
    if len(raw) > width:
        raw = raw[:width].decode("utf-8", "ignore").encode("utf-8")
    return raw.ljust(width)


def write_shapefile(frame, path):
    """Write a GeoDataFrame to ``path`` (.shp; .shx/.dbf/.prj beside it)."""
    base = os.path.splitext(path)[0]
    geom_col = frame._geometry_column_name or "geometry"
    columns = [c for c in frame.columns if c != geom_col]
    geometries = list(frame[geom_col])

    records = []
    shape_type = _SHAPE_NULL
    for geom in geometries:
        st, parts = _rings_of(geom)
        if st != _SHAPE_NULL:
            if shape_type != _SHAPE_NULL and st != shape_type:
                raise ValueError(
                    "Shapefiles cannot mix geometry types (%d vs %d); "
                    "split the frame or use GeoPackage/GeoJSON"
                    % (shape_type, st)
                )
            shape_type = st
        records.append(_encode_record(st, parts))

    # .shp + .shx
    offsets = []
    content_length = 0
    for record in records:
        offsets.append(50 + content_length // 2)
        content_length += 8 + len(record)

    if geometries and any(g is not None and not g.is_empty for g in geometries):
        pts = np.concatenate(
            [
                np.vstack(g._all_coords())
                for g in geometries
                if g is not None and not g.is_empty
            ]
        )
        bbox = (pts[:, 0].min(), pts[:, 1].min(), pts[:, 0].max(), pts[:, 1].max())
    else:
        bbox = (0.0, 0.0, 0.0, 0.0)

    def header(file_length_words):
        return (
            struct.pack(">i5ii", 9994, 0, 0, 0, 0, 0, file_length_words)
            + struct.pack("<ii", 1000, shape_type)
            + struct.pack("<4d", *bbox)
            + struct.pack("<4d", 0, 0, 0, 0)
        )

    with open(base + ".shp", "wb") as f:
        f.write(header(50 + content_length // 2))
        for i, record in enumerate(records):
            f.write(struct.pack(">ii", i + 1, len(record) // 2))
            f.write(record)

    with open(base + ".shx", "wb") as f:
        f.write(header(50 + 4 * len(records)))
        for offset, record in zip(offsets, records):
            f.write(struct.pack(">ii", offset, len(record) // 2))

    # .dbf
    fields = _dbf_fields(frame, columns)
    record_size = 1 + sum(w for _, _, w, _ in fields)
    header_size = 32 + 32 * len(fields) + 1
    now = datetime.date.today()
    with open(base + ".dbf", "wb") as f:
        f.write(
            struct.pack(
                "<BBBBIHH20x",
                3,
                now.year - 1900,
                now.month,
                now.day,
                len(records),
                header_size,
                record_size,
            )
        )
        for name, ftype, width, decimals in fields:
            f.write(
                struct.pack(
                    "<11sc4xBB14x",
                    name.encode()[:10].ljust(11, b"\x00"),
                    ftype.encode(),
                    width,
                    decimals,
                )
            )
        f.write(b"\x0d")
        for _, row in frame.iterrows():
            f.write(b" ")
            for name, ftype, width, decimals in fields:
                value = row[name]
                null = value is None or (
                    not isinstance(value, (list, tuple, np.ndarray))
                    and is_null(value)
                )
                if ftype == "L":
                    text = "?" if null else ("T" if value else "F")
                elif ftype == "N":
                    if null:
                        text = ""
                    elif decimals:
                        text = "%.*f" % (decimals, value)
                    else:
                        text = str(int(value))
                    if len(text) > width:
                        raise ValueError(
                            "Value %r does not fit DBF field %s (N/%d)"
                            % (value, name, width)
                        )
                    text = text.rjust(width)
                elif ftype == "D":
                    text = "" if null else _date_text(value)
                else:
                    text = "" if null else str(value)
                f.write(_dbf_text(text, width))
        f.write(b"\x1a")

    # .cpg: declare the DBF text encoding, as OGR does
    with open(base + ".cpg", "w") as f:
        f.write("UTF-8")

    # .prj
    if getattr(frame, "crs", None):
        from dask_geomodeling_tpu_torch.geo.crs import get_sr

        with open(base + ".prj", "w") as f:
            f.write(get_sr(frame.crs).ExportToWkt())


def read_shapefile(path):
    """Read a shapefile into a GeoDataFrame."""
    from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
    from dask_geomodeling_tpu_torch.geo.geometry import (
        LineString,
        MultiLineString,
        MultiPolygon,
        Point,
        Polygon,
        _ring_area,
    )

    base = os.path.splitext(path)[0]
    geometries = []
    with open(base + ".shp", "rb") as f:
        f.seek(24)
        (file_length,) = struct.unpack(">i", f.read(4))
        f.seek(100)
        end = file_length * 2
        while f.tell() < end:
            _, length = struct.unpack(">ii", f.read(8))
            record = f.read(length * 2)
            (shape_type,) = struct.unpack("<i", record[:4])
            if shape_type == _SHAPE_NULL:
                geometries.append(None)
            elif shape_type == _SHAPE_POINT:
                x, y = struct.unpack("<dd", record[4:20])
                geometries.append(Point(x, y))
            elif shape_type in (_SHAPE_POLYLINE, _SHAPE_POLYGON):
                n_parts, n_points = struct.unpack("<ii", record[36:44])
                parts = struct.unpack("<%di" % n_parts, record[44 : 44 + 4 * n_parts])
                coords = np.frombuffer(
                    record, "<f8", count=n_points * 2, offset=44 + 4 * n_parts
                ).reshape(n_points, 2)
                pieces = [
                    coords[parts[i] : (parts[i + 1] if i + 1 < n_parts else n_points)]
                    for i in range(n_parts)
                ]
                if shape_type == _SHAPE_POLYLINE:
                    geometries.append(
                        LineString(pieces[0])
                        if len(pieces) == 1
                        else MultiLineString([LineString(p) for p in pieces])
                    )
                else:
                    # clockwise rings are shells, counter-clockwise are holes
                    polys = []
                    for piece in pieces:
                        if _ring_area(np.asarray(piece)) <= 0:  # shell
                            polys.append(Polygon(piece))
                        elif polys:
                            polys[-1].holes.append(
                                np.asarray(piece, dtype=float)
                            )
                        else:
                            polys.append(Polygon(piece))
                    geometries.append(
                        polys[0] if len(polys) == 1 else MultiPolygon(polys)
                    )
            else:
                raise NotImplementedError(
                    "Shapefile shape type %d" % shape_type
                )

    # .dbf — text encoding, OGR precedence: the .cpg sidecar, then the
    # DBF header's language driver id (byte 29), then legacy cp1252
    encoding = None
    if os.path.exists(base + ".cpg"):
        with open(base + ".cpg") as stream:
            declared = stream.read().strip()
        declared = {"ANSI 1252": "cp1252"}.get(declared, declared)
        try:
            b"".decode(declared)
            encoding = declared
        except LookupError:
            pass  # unknown codepage label: fall through to the LDID
    records = []
    with open(base + ".dbf", "rb") as f:
        head = f.read(32)
        if encoding is None:
            encoding = _LDID_ENCODINGS.get(head[29], "cp1252")
        n_records, header_size, record_size = struct.unpack("<IHH", head[4:12])
        fields = []
        while True:
            descriptor = f.read(1)
            if descriptor == b"\x0d":
                break
            descriptor += f.read(31)
            name = descriptor[:11].split(b"\x00")[0].decode()
            ftype = descriptor[11:12].decode()
            width = descriptor[16]
            decimals = descriptor[17]
            fields.append((name, ftype, width, decimals))
        for _ in range(n_records):
            raw = f.read(record_size)
            if not raw:
                continue
            # soft-deleted rows ('*' flag) still occupy a .shp geometry
            # slot: parse them anyway so attributes stay aligned with
            # geometries (skipping would shift every later row)
            pos = 1
            record = {}
            for name, ftype, width, decimals in fields:
                text = raw[pos : pos + width].decode(encoding, "replace").strip()
                pos += width
                if ftype == "L":
                    record[name] = text in ("T", "t", "Y", "y")
                elif ftype == "N":
                    if not text:
                        record[name] = None
                    elif decimals:
                        record[name] = float(text)
                    else:
                        record[name] = int(text)
                elif ftype in ("F", "O"):  # float / double fields
                    record[name] = float(text) if text else None
                elif ftype == "D":  # date: YYYYMMDD
                    if len(text) == 8 and text.isdigit():
                        record[name] = np.datetime64(
                            "%s-%s-%s" % (text[:4], text[4:6], text[6:8]), "us"
                        )
                    else:
                        record[name] = np.datetime64("NaT", "us")
                else:
                    record[name] = text
            records.append(record)

    crs = None
    if os.path.exists(base + ".prj"):
        from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt

        try:
            with open(base + ".prj") as stream:
                crs = get_epsg_or_wkt(stream.read())
        except Exception:
            crs = None

    if records and records[0]:
        frame = GeoDataFrame(
            GeoDataFrame.from_records(records), geometry=geometries, crs=crs
        )
    else:
        frame = GeoDataFrame(geometry=geometries, crs=crs)
    frame.index.name = "fid"
    return frame
