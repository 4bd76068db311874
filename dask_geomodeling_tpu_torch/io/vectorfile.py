"""Vector file I/O: the formats that need only the stdlib and numpy.

Counterpart of dask_geomodeling_tpu/io/vectorfile.py, on the port's
pandas-free frame (geo/features.py); each reader and writer is a copy that
gives the same frames and writes the same files:

- GeoJSON (.geojson / .json) and GeoJSON sequences (.geojsonl /
  .ndjson): stdlib json, the same text (key order, float repr, NaN as
  the JAX writer writes it);
- GeoPackage (.gpkg): stdlib sqlite3 with the gpkg_* metadata tables,
  the GP geometry blob and a populated ``gpkg_rtree_index`` (SQLite's
  R-tree module; a build of SQLite without it fails the write, no file
  without an index is written); a bbox read goes through that index;
- ESRI Shapefile (.shp + .shx/.dbf/.prj/.cpg): io/shapefile.py;
- CSV (.csv): a WKT geometry column, numeric-looking columns typed as
  pandas' ``to_numeric`` types them (``_to_numeric``);
- GML (.gml): OGR-style GML 2.1.2 (GML3 accepted on read), columns typed
  as pandas' ``astype(int64)`` then ``astype(float64)`` type them;
- KML (.kml) and KMZ (.kmz, the zipped ``doc.kml``): Placemarks, always
  EPSG:4326, ExtendedData typed by ``_to_numeric``;
- GPX (.gpx): layers ``waypoints``, ``routes`` and ``tracks``, always
  EPSG:4326;
- zipped datasets (.zip / .shp.zip): the contained dataset is read
  (shapefiles win ties); a zipped shapefile is written;
- TopoJSON (io/topojson.py), SpatiaLite (io/spatialite.py), MapInfo
  MIF/MID (io/mapinfo.py), DXF (io/dxf.py), FlatGeobuf (.fgb,
  io/flatgeobuf.py, with its packed Hilbert R-tree; no ``flatbuffers``
  package needed) and OSM XML (io/osm.py, read only: writing ``.osm``
  raises).

GeoParquet raises NotImplementedError naming the JAX module that reads
it: it needs ``pyarrow``, which the card machine does not have.

API: ``read_vector``, ``read_vector_info``, ``write_vector``,
``gpkg_rtree_name`` and ``supported_extensions``.
"""
import json
import os
import re
import sqlite3
import struct

import numpy as np

from dask_geomodeling_tpu_torch.geo import _wkt
from dask_geomodeling_tpu_torch.geo.features import (
    GeoDataFrame,
    Index,
    _infer,
    _objects,
    is_null,
)
from dask_geomodeling_tpu_torch.geo.geometry import shape

__all__ = [
    "read_vector",
    "read_vector_info",
    "write_vector",
    "gpkg_rtree_name",
    "supported_extensions",
]

supported_extensions = {
    "geojson", "json", "geojsonl", "ndjson", "gpkg", "shp", "csv", "gml", "kml", "kmz",
    "gpx", "zip", "topojson", "sqlite", "mif", "dxf", "osm", "fgb",
}

#: extensions the JAX package reads and writes and the port does not, and
#: where the JAX package handles each
_UNPORTED = {
    "parquet": "io/vectorfile.py (_read_parquet; it needs pyarrow, which the card machine lacks)",
    "geoparquet": "io/vectorfile.py (_read_parquet; it needs pyarrow, which the card machine "
                  "lacks)",
}


def _format_of(path):
    ext = os.path.splitext(path)[1].lstrip(".").lower()
    if ext in _UNPORTED:
        raise NotImplementedError(
            "the '%s' vector format is not ported: dask_geomodeling_tpu/%s handles it"
            % (ext, _UNPORTED[ext])
        )
    if ext not in supported_extensions:
        raise NotImplementedError("Unsupported vector format: '{}'".format(ext))
    return ext


def _index_values(labels):
    """An index's values as pandas types them: integers int64, anything
    else an object array."""
    return _infer(list(labels)) if labels else np.empty(0, np.int64)


def _frame(records, geometries, crs):
    """A frame of the records' columns (pandas' from_records typing) and
    a geometry column after them."""
    return _frame_of_table(GeoDataFrame.from_records(records) if records else None,
                           geometries, crs)


def _frame_of_table(table, geometries, crs):
    """A frame of an attribute table (or None) and a geometry column
    after its columns."""
    if table is None or not table.columns:
        return GeoDataFrame(geometry=geometries, crs=crs)
    return GeoDataFrame(table, geometry=geometries, crs=crs)


# --- GeoJSON ---


def _frame_from_features(features, crs="EPSG:4326"):
    geometries = []
    records = []
    ids = []
    for i, feature in enumerate(features):
        geometries.append(shape(feature["geometry"]))
        records.append(feature.get("properties") or {})
        ids.append(feature.get("id", i))
    frame = _frame(records, geometries, crs)
    frame.index = Index(_index_values(ids), name="fid" if any(ids) else None)
    return frame


def _read_geojson(path):
    with open(path) as f:
        collection = json.load(f)
    frame = _frame_from_features(collection.get("features", []))
    # the legacy (pre-RFC 7946) named-crs member, honoured like OGR:
    # {"crs": {"type": "name", "properties": {"name": "urn:...EPSG::x"}}}
    crs = collection.get("crs")
    if isinstance(crs, dict):
        name = (crs.get("properties") or {}).get("name")
        if name:
            try:
                from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt

                frame.crs = get_epsg_or_wkt(str(name))
            except Exception:
                pass  # unknown identifier: keep the RFC 7946 default
    return frame


def _read_geojsonl(path):
    with open(path) as f:
        features = [json.loads(line) for line in f if line.strip()]
    return _frame_from_features(features)


def _write_geojsonl(frame, path):
    with open(path, "w") as f:
        for feature in _geojson_features(frame):
            f.write(json.dumps(feature))
            f.write("\n")


def _geojson_features(frame):
    geometry_column = frame._geometry_column_name or "geometry"
    for idx, row in frame.iterrows():
        geom = row[geometry_column]
        yield {
            "type": "Feature",
            "id": _jsonify(idx),
            "geometry": geom.__geo_interface__ if geom is not None else None,
            "properties": {
                k: _jsonify(v) for k, v in row.items() if k != geometry_column
            },
        }


def _write_geojson(frame, path):
    features = list(_geojson_features(frame))
    with open(path, "w") as f:
        json.dump({"type": "FeatureCollection", "features": features}, f)


def _jsonify(value):
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value) if np.isfinite(value) else None
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, (list, dict, str, int, float, bool)) or value is None:
        return value
    if is_null(value):
        return None
    return str(value)


# --- GeoPackage ---

_GPKG_INIT = """
CREATE TABLE IF NOT EXISTS gpkg_spatial_ref_sys (
  srs_name TEXT NOT NULL, srs_id INTEGER PRIMARY KEY,
  organization TEXT NOT NULL, organization_coordsys_id INTEGER NOT NULL,
  definition TEXT NOT NULL, description TEXT);
CREATE TABLE IF NOT EXISTS gpkg_contents (
  table_name TEXT PRIMARY KEY, data_type TEXT NOT NULL,
  identifier TEXT UNIQUE, description TEXT DEFAULT '',
  last_change DATETIME DEFAULT (strftime('%Y-%m-%dT%H:%M:%fZ','now')),
  min_x DOUBLE, min_y DOUBLE, max_x DOUBLE, max_y DOUBLE,
  srs_id INTEGER);
CREATE TABLE IF NOT EXISTS gpkg_geometry_columns (
  table_name TEXT NOT NULL, column_name TEXT NOT NULL,
  geometry_type_name TEXT NOT NULL, srs_id INTEGER NOT NULL,
  z TINYINT NOT NULL, m TINYINT NOT NULL,
  CONSTRAINT pk_geom_cols PRIMARY KEY (table_name, column_name));
"""


def _gpkg_blob(geom, srs_id):
    """Encode a geometry as a GeoPackage geometry blob (no envelope)."""
    header = b"GP" + bytes([0, 0b00000001]) + struct.pack("<i", srs_id)
    return header + _wkt.dumps_wkb(geom)


def _gpkg_parse_blob(blob):
    if blob[:2] != b"GP":
        raise ValueError("Not a GeoPackage geometry blob")
    flags = blob[3]
    envelope_code = (flags >> 1) & 0b111
    envelope_sizes = {0: 0, 1: 32, 2: 48, 3: 48, 4: 64}
    offset = 8 + envelope_sizes.get(envelope_code, 0)
    return _wkt.loads_wkb(blob[offset:])


def _srs_id_of(crs):
    from dask_geomodeling_tpu_torch.geo.crs import get_sr

    sr = get_sr(crs or "EPSG:4326")
    return sr.code or 0


def _write_gpkg(frame, path, layer):
    geom_col = frame._geometry_column_name or "geometry"
    srs_id = _srs_id_of(getattr(frame, "crs", None))
    attr_cols = [c for c in frame.columns if c != geom_col]

    con = sqlite3.connect(path)
    try:
        con.executescript(_GPKG_INIT)
        con.execute("PRAGMA application_id = 1196444487")  # 'GPKG'
        con.execute("PRAGMA user_version = 10200")
        con.execute(
            "INSERT OR IGNORE INTO gpkg_spatial_ref_sys VALUES (?,?,?,?,?,?)",
            ("epsg:%d" % srs_id, srs_id, "EPSG", srs_id, "undefined", None),
        )

        col_defs = ", ".join('"%s"' % c for c in attr_cols)
        con.execute(
            'CREATE TABLE "{layer}" (fid INTEGER PRIMARY KEY, geom BLOB{cols})'.format(
                layer=layer, cols=(", " + col_defs) if attr_cols else ""
            )
        )
        bounds = frame.geometry.total_bounds if len(frame) else [None] * 4
        con.execute(
            "INSERT INTO gpkg_contents (table_name, data_type, identifier, "
            "min_x, min_y, max_x, max_y, srs_id) VALUES (?,?,?,?,?,?,?,?)",
            (layer, "features", layer, *[
                float(b) if b is not None and not is_null(b) else None
                for b in bounds
            ], srs_id),
        )
        con.execute(
            "INSERT INTO gpkg_geometry_columns VALUES (?,?,?,?,0,0)",
            (layer, "geom", "GEOMETRY", srs_id),
        )

        placeholders = ",".join("?" * (2 + len(attr_cols)))
        # fid is an INTEGER PRIMARY KEY: only a unique integer index can
        # serve as it; otherwise fall back to sequential fids
        index_as_fid = frame.index.is_unique and all(
            isinstance(idx, (int, np.integer)) for idx in frame.index
        )
        rows = []
        for i, (idx, row) in enumerate(frame.iterrows(), start=1):
            geom = row[geom_col]
            blob = _gpkg_blob(geom, srs_id) if geom is not None else None
            fid = idx if index_as_fid else i
            rows.append(
                (int(fid), blob)
                + tuple(_sql_value(row[c]) for c in attr_cols)
            )
        con.executemany(
            'INSERT INTO "{layer}" VALUES ({ph})'.format(
                layer=layer, ph=placeholders
            ),
            rows,
        )
        _write_gpkg_rtree(con, layer, "geom", frame, rows)
        con.commit()
    finally:
        con.close()


def _write_gpkg_rtree(con, layer, geom_col, frame, rows):
    """The gpkg_rtree_index extension: a populated SQLite R-tree over
    the feature envelopes plus the spec's maintenance triggers, so
    readers (incl. GDAL/QGIS and this module's bbox path) can answer
    spatial queries without scanning the table."""
    rtree = "rtree_%s_%s" % (layer, geom_col)
    con.execute(
        'CREATE VIRTUAL TABLE "%s" USING rtree(id, minx, maxx, miny, maxy)'
        % rtree
    )
    entries = []
    geometries = frame.geometry.values
    for row, geom in zip(rows, geometries):
        bounds = geom.bounds if geom is not None else ()
        if len(bounds) != 4:
            continue  # null/empty geometries have no envelope to index
        minx, miny, maxx, maxy = bounds
        entries.append((row[0], minx, maxx, miny, maxy))
    con.executemany(
        'INSERT INTO "%s" VALUES (?,?,?,?,?)' % rtree, entries
    )
    con.execute(
        "CREATE TABLE IF NOT EXISTS gpkg_extensions (table_name TEXT, "
        "column_name TEXT, extension_name TEXT NOT NULL, definition TEXT "
        "NOT NULL, scope TEXT NOT NULL)"
    )
    con.execute(
        "INSERT INTO gpkg_extensions VALUES (?,?,?,?,?)",
        (layer, geom_col, "gpkg_rtree_index",
         "http://www.geopackage.org/spec120/#extension_rtree",
         "write-only"),
    )
    # the spec's maintenance triggers (they call the GPKG SQL functions,
    # available in GDAL/spatialite sessions that edit such files)
    t = '"%s"' % layer
    r = '"%s"' % rtree
    c = '"%s"' % geom_col
    con.executescript(
        """
        CREATE TRIGGER "{rt}_insert" AFTER INSERT ON {t}
          WHEN (NEW.{c} NOT NULL AND NOT ST_IsEmpty(NEW.{c}))
        BEGIN
          INSERT OR REPLACE INTO {r} VALUES (NEW.fid,
            ST_MinX(NEW.{c}), ST_MaxX(NEW.{c}),
            ST_MinY(NEW.{c}), ST_MaxY(NEW.{c}));
        END;
        CREATE TRIGGER "{rt}_update1" AFTER UPDATE OF {c} ON {t}
          WHEN OLD.fid = NEW.fid AND
               (NEW.{c} NOTNULL AND NOT ST_IsEmpty(NEW.{c}))
        BEGIN
          INSERT OR REPLACE INTO {r} VALUES (NEW.fid,
            ST_MinX(NEW.{c}), ST_MaxX(NEW.{c}),
            ST_MinY(NEW.{c}), ST_MaxY(NEW.{c}));
        END;
        CREATE TRIGGER "{rt}_update2" AFTER UPDATE OF {c} ON {t}
          WHEN OLD.fid = NEW.fid AND
               (NEW.{c} ISNULL OR ST_IsEmpty(NEW.{c}))
        BEGIN
          DELETE FROM {r} WHERE id = OLD.fid;
        END;
        CREATE TRIGGER "{rt}_update3" AFTER UPDATE ON {t}
          WHEN OLD.fid != NEW.fid AND
               (NEW.{c} NOTNULL AND NOT ST_IsEmpty(NEW.{c}))
        BEGIN
          DELETE FROM {r} WHERE id = OLD.fid;
          INSERT OR REPLACE INTO {r} VALUES (NEW.fid,
            ST_MinX(NEW.{c}), ST_MaxX(NEW.{c}),
            ST_MinY(NEW.{c}), ST_MaxY(NEW.{c}));
        END;
        CREATE TRIGGER "{rt}_update4" AFTER UPDATE ON {t}
          WHEN OLD.fid != NEW.fid AND
               (NEW.{c} ISNULL OR ST_IsEmpty(NEW.{c}))
        BEGIN
          DELETE FROM {r} WHERE id IN (OLD.fid, NEW.fid);
        END;
        CREATE TRIGGER "{rt}_delete" AFTER DELETE ON {t}
          WHEN OLD.{c} NOT NULL
        BEGIN
          DELETE FROM {r} WHERE id = OLD.fid;
        END;
        """.format(rt=rtree, t=t, r=r, c=c)
    )


def _sql_value(value):
    if isinstance(value, (np.integer,)):
        return int(value)
    if isinstance(value, (np.floating,)):
        return float(value)
    if isinstance(value, np.bool_):
        return bool(value)
    if isinstance(value, (list, dict)):
        return json.dumps(value)
    if value is not None and not isinstance(value, (str, bytes)) and is_null(value):
        return None
    return value


def gpkg_rtree_name(path, layer=None):
    """The layer's gpkg_rtree_index table name, or None (cheap probe)."""
    try:
        con = sqlite3.connect(path)
        try:
            row = con.execute(
                "SELECT table_name, column_name FROM gpkg_geometry_columns"
                + ("" if layer is None else " WHERE table_name = ?"),
                () if layer is None else (layer,),
            ).fetchone()
            if row is None:
                return None
            candidate = "rtree_%s_%s" % (row[0], row[1])
            present = con.execute(
                "SELECT 1 FROM sqlite_master WHERE name = ?", (candidate,)
            ).fetchone()
            return candidate if present else None
        finally:
            con.close()
    except sqlite3.Error:
        return None


def _read_gpkg(path, layer=None, bbox=None, bbox_projection=None):
    """``bbox`` (with its ``bbox_projection``) answers through the
    gpkg_rtree_index when the file carries one: only matching rows are
    fetched and decoded."""
    con = sqlite3.connect(path)
    con.row_factory = sqlite3.Row
    try:
        contents = con.execute(
            "SELECT table_name, srs_id FROM gpkg_contents "
            "WHERE data_type = 'features'"
        ).fetchall()
        if not contents:
            raise IOError("No feature layers in '{}'".format(path))
        if layer is None:
            table, srs_id = contents[0]["table_name"], contents[0]["srs_id"]
        else:
            matches = [c for c in contents if c["table_name"] == layer]
            if not matches:
                raise IOError("Layer '{}' not found in '{}'".format(layer, path))
            table, srs_id = matches[0]["table_name"], matches[0]["srs_id"]
        geom_col = con.execute(
            "SELECT column_name FROM gpkg_geometry_columns WHERE table_name = ?",
            (table,),
        ).fetchone()["column_name"]

        rtree = None
        if bbox is not None:
            candidate = "rtree_%s_%s" % (table, geom_col)
            present = con.execute(
                "SELECT 1 FROM sqlite_master WHERE name = ?", (candidate,)
            ).fetchone()
            if present:
                rtree = candidate
        if rtree is not None:
            if bbox_projection is not None and srs_id:
                from dask_geomodeling_tpu_torch.geo.crs import (
                    get_projection,
                    transform_extent,
                )

                file_crs = "EPSG:%d" % srs_id
                try:
                    same = (
                        get_projection(bbox_projection).upper()
                        == get_projection(file_crs).upper()
                    )
                except Exception:
                    same = False
                if not same:
                    bbox = transform_extent(
                        bbox, bbox_projection, file_crs
                    )
            rows = con.execute(
                'SELECT t.* FROM "{t}" t JOIN "{r}" r ON t.rowid = r.id '
                "WHERE r.maxx >= ? AND r.minx <= ? AND r.maxy >= ? AND "
                "r.miny <= ? ORDER BY t.rowid".format(t=table, r=rtree),
                (bbox[0], bbox[2], bbox[1], bbox[3]),
            ).fetchall()
        else:
            rows = con.execute('SELECT * FROM "{}"'.format(table)).fetchall()
        geometries = []
        records = []
        fids = []
        for row in rows:
            row = dict(row)
            fids.append(row.pop("fid", len(fids)))
            blob = row.pop(geom_col)
            geometries.append(_gpkg_parse_blob(blob) if blob else None)
            records.append(row)
        crs = "EPSG:%d" % srs_id if srs_id else None
        frame = _frame(records, geometries, crs)
        frame.index = Index(_index_values(fids), name="fid")
        return frame
    finally:
        con.close()


# --- CSV with a WKT geometry column (OGR CSV driver conventions) ---

_CSV_GEOMETRY_COLUMNS = ("geometry", "wkt", "WKT", "the_geom")


#: powers of ten as C double literals (pandas' ``precise_xstrtod`` table)
_POWERS = [float("1e%d" % k) for k in range(309)]
_ASCII_SPACE = " \t\n\r\f\v"
_INT64 = (-(2**63), 2**63 - 1)
_UINT64_MAX = 2**64 - 1


def _xstrtod(text):
    """pandas' ``precise_xstrtod`` of one string: (value, maybe_int), or
    None where pandas fails to parse it.  At most 17 significant digits
    count, accumulated in a double and scaled by a power of ten, so a
    value of more digits (0.30000000000000004) reads as pandas reads it,
    not correctly rounded."""
    p, n = 0, len(text)
    while p < n and text[p] in _ASCII_SPACE:
        p += 1
    negative = p < n and text[p] == "-"
    if p < n and text[p] in "+-":
        p += 1
    number, exponent, digits, decimals, maybe_int = 0.0, 0, 0, 0, True
    while p < n and "0" <= text[p] <= "9":
        if digits < 17:
            number = number * 10.0 + (ord(text[p]) - 48)
            digits += 1
        else:
            exponent += 1
        p += 1
    if p < n and text[p] == ".":
        maybe_int = False
        p += 1
        while digits < 17 and p < n and "0" <= text[p] <= "9":
            number = number * 10.0 + (ord(text[p]) - 48)
            p += 1
            digits += 1
            decimals += 1
        while p < n and "0" <= text[p] <= "9":
            p += 1
        exponent -= decimals
    if digits == 0:
        return None
    if negative:
        number = -number
    if p < n and text[p] in "eE":
        maybe_int = False
        p += 1
        minus = p < n and text[p] == "-"
        if p < n and text[p] in "+-":
            p += 1
        count = power = 0
        while count < 17 and p < n and "0" <= text[p] <= "9":
            power = power * 10 + ord(text[p]) - 48
            count += 1
            p += 1
        exponent += -power if minus else power
        if count == 0:
            p -= 1
    if exponent > 308:
        number = float("-inf") if number < 0 else float("inf")
    elif exponent > 0:
        number *= _POWERS[exponent]
    elif exponent < -616:
        number = 0.0
    elif exponent < -308:
        number = number / _POWERS[-308 - exponent] / _POWERS[308]
    else:
        number /= _POWERS[-exponent]
    while p < n and text[p] in _ASCII_SPACE:
        p += 1
    return (number, maybe_int) if p == n else None


def _floatify(text):
    """pandas' ``floatify``: ``_xstrtod`` with its spellings of infinity;
    ValueError where pandas raises one."""
    parsed = _xstrtod(text)
    if parsed is not None:
        return parsed
    if text.lower() in ("inf", "+inf", "infinity", "+infinity"):
        return float("inf"), False
    if text.lower() in ("-inf", "-infinity"):
        return float("-inf"), False
    raise ValueError("Unable to parse string %r" % text)


def _to_numeric(cells):
    """A column of text cells (None, NaN or "" for a missing one) as
    pandas 3.0.3's ``to_numeric`` types it (``maybe_convert_numeric``):
    float64 where any cell is missing or not an integer, int64 or uint64
    for integers, an object column of Python ints for integers outside
    both; None where a cell is no number or an integer above int64 meets
    a negative or missing one (the column stays text)."""
    floats, ints = [], []
    missing = signed = unsigned = huge = floating = False
    for cell in cells:
        if is_null(cell) or cell == "":
            missing = floating = True
            floats.append(np.nan)
            ints.append(None)
            continue
        try:
            value, maybe_int = _floatify(cell)
        except ValueError:
            return None
        floats.append(value)
        if not maybe_int:
            floating = True
            ints.append(None)
            continue
        integer = int(cell)
        ints.append(integer)
        signed = signed or _INT64[0] <= integer < 0
        unsigned = unsigned or _INT64[1] < integer <= _UINT64_MAX
        huge = huge or not _INT64[0] <= integer <= _UINT64_MAX
    if unsigned and (missing or signed):
        return None
    if floating:
        return np.array(floats, dtype=float)
    if huge:
        return _objects(ints)
    return np.array(ints, dtype=np.uint64 if unsigned else np.int64)


def _astype_number(cells):
    """pandas' ``astype(np.int64)`` of a column of text cells, else its
    ``astype(np.float64)`` (Python's ``int`` and ``float`` of each cell),
    else None (the column stays text).  A missing cell fails the integer
    cast; an integer beyond int64 raises OverflowError, as pandas does,
    unless an earlier cell failed it."""
    if not any(is_null(cell) for cell in cells):
        try:
            ints = []
            for cell in cells:
                integer = int(cell)
                if not _INT64[0] <= integer <= _INT64[1]:
                    raise OverflowError("Python int too large to convert to C long")
                ints.append(integer)
            return np.array(ints, dtype=np.int64)
        except (ValueError, TypeError):
            pass
    try:
        return np.array([np.nan if is_null(cell) else float(cell) for cell in cells], dtype=float)
    except (ValueError, TypeError):
        return None


def _read_csv(path):
    import csv as _csv

    from dask_geomodeling_tpu_torch.geo.geometry import from_wkt

    with open(path, newline="") as f:
        rows = list(_csv.DictReader(f))
    if not rows:
        return GeoDataFrame(geometry=[], crs=None)
    geometry_column = next(
        (c for c in _CSV_GEOMETRY_COLUMNS if c in rows[0]), None
    )
    if geometry_column is None:
        raise IOError("No WKT geometry column in '{}'".format(path))
    geometries = [
        from_wkt(wkt) if (wkt := row.pop(geometry_column)) else None
        for row in rows
    ]
    frame = GeoDataFrame.from_records(rows)
    # numeric-looking columns come back typed, like OGR's CSV driver
    _type_columns(frame, _to_numeric)
    return GeoDataFrame(frame, geometry=geometries, crs=None)


def _type_columns(frame, caster):
    """Replace each column the caster types (a number array, or None to
    keep the column)."""
    for column in frame.columns:
        numbers = caster(frame[column].values.tolist())
        if numbers is not None:
            frame[column] = numbers


def _write_csv(frame, path):
    import csv as _csv

    geometry_column = frame._geometry_column_name or "geometry"
    fields = [c for c in frame.columns if c != geometry_column]
    with open(path, "w", newline="") as f:
        writer = _csv.writer(f)
        writer.writerow(["geometry"] + fields)
        for _, row in frame.iterrows():
            geom = row[geometry_column]
            writer.writerow(
                [geom.wkt if geom is not None else ""]
                + [_jsonify(row[c]) for c in fields]
            )


# --- GML (OGR-style GML 2.1.2 FeatureCollection; GML3 accepted on read) ---


def _gml_local(tag):
    return tag.rsplit("}", 1)[-1]


def _gml_ring_coords(element):
    """Coordinate list from the first coordinates/posList/pos descendant."""
    for child in element.iter():
        name = _gml_local(child.tag)
        if name == "coordinates":
            return [tuple(float(v) for v in pair.split(",")) for pair in child.text.split()]
        if name == "posList":
            flat = [float(v) for v in child.text.split()]
            # honor srsDimension (3D posLists are common); z is dropped
            dim = int(child.get("srsDimension", 2))
            return list(zip(flat[0::dim], flat[1::dim]))
        if name == "pos":
            return [tuple(float(v) for v in child.text.split()[:2])]
    raise ValueError("GML element without coordinates: %s" % element.tag)


_GML_MULTI = {
    "MultiPoint": "MultiPoint",
    "MultiLineString": "MultiLineString",
    "MultiCurve": "MultiLineString",
    "MultiPolygon": "MultiPolygon",
    "MultiSurface": "MultiPolygon",
}


def _gml_members(element):
    return [
        _gml_geometry(child[0])
        for child in element
        if _gml_local(child.tag).endswith("Member") and len(child)
    ]


def _gml_geometry(element):
    """A gml geometry element -> __geo_interface__ dict."""
    name = _gml_local(element.tag)
    if name == "Point":
        return {"type": "Point", "coordinates": _gml_ring_coords(element)[0]}
    if name in ("LineString", "Curve"):
        return {"type": "LineString", "coordinates": _gml_ring_coords(element)}
    if name in ("Polygon", "Surface"):
        shell, holes = None, []
        for boundary in element.iter():
            bname = _gml_local(boundary.tag)
            if bname in ("outerBoundaryIs", "exterior"):
                shell = _gml_ring_coords(boundary)
            elif bname in ("innerBoundaryIs", "interior"):
                holes.append(_gml_ring_coords(boundary))
        return {"type": "Polygon", "coordinates": [shell] + holes}
    if name in _GML_MULTI:
        return {"type": _GML_MULTI[name],
                "coordinates": [p["coordinates"] for p in _gml_members(element)]}
    if name == "MultiGeometry":
        return {"type": "GeometryCollection", "geometries": _gml_members(element)}
    raise ValueError("Unsupported GML geometry: %s" % name)


_GML_GEOMETRY_NAMES = {"Point", "LineString", "Curve", "Polygon", "Surface",
                       "MultiGeometry"} | set(_GML_MULTI)


def _read_gml(path):
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    geometries, records, ids, crs = [], [], [], None
    for member in root.iter():
        if _gml_local(member.tag) not in ("featureMember", "member"):
            continue
        for feature in member:
            geom, properties = None, {}
            fid = feature.attrib.get("fid") or feature.attrib.get(
                "{http://www.opengis.net/gml}id")
            for prop in feature:
                geom_children = [c for c in prop if _gml_local(c.tag) in _GML_GEOMETRY_NAMES]
                if geom_children:
                    crs = geom_children[0].attrib.get("srsName", crs)
                    geom = shape(_gml_geometry(geom_children[0]))
                else:
                    properties[_gml_local(prop.tag)] = prop.text
            geometries.append(geom)
            records.append(properties)
            ids.append(fid if fid is not None else len(ids))
    table = GeoDataFrame.from_records(records) if records else None
    if table is not None:
        # no .xsd schema handling: sniff numeric columns like OGR does
        _type_columns(table, _astype_number)
    if crs:
        # srsName carries any identifier syntax (plain EPSG:, OGC URNs,
        # opengis URLs): normalize to the canonical form when parseable
        try:
            from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt

            crs = get_epsg_or_wkt(crs)
        except Exception:
            pass
    frame = _frame_of_table(table, geometries, crs or "EPSG:4326")
    frame.index = Index(_index_values(ids))
    return frame


def _gml_coordinates(coords):
    return "<gml:coordinates>%s</gml:coordinates>" % " ".join(
        "%.17g,%.17g" % (x, y) for x, y in coords)


def _gml_geom_str(geo, srs=None):
    srs_attr = ' srsName="%s"' % srs if srs else ""
    kind = geo["type"]
    if kind == "Point":
        return "<gml:Point%s>%s</gml:Point>" % (srs_attr, _gml_coordinates([geo["coordinates"]]))
    if kind == "LineString":
        return "<gml:LineString%s>%s</gml:LineString>" % (
            srs_attr, _gml_coordinates(geo["coordinates"]))
    if kind == "Polygon":
        parts = []
        for i, ring in enumerate(geo["coordinates"]):
            boundary = "outerBoundaryIs" if i == 0 else "innerBoundaryIs"
            parts.append("<gml:%s><gml:LinearRing>%s</gml:LinearRing></gml:%s>"
                         % (boundary, _gml_coordinates(ring), boundary))
        return "<gml:Polygon%s>%s</gml:Polygon>" % (srs_attr, "".join(parts))
    if kind in ("MultiPoint", "MultiLineString", "MultiPolygon"):
        single = kind[5:]
        member = {"MultiPoint": "pointMember", "MultiLineString": "lineStringMember",
                  "MultiPolygon": "polygonMember"}[kind]
        parts = ["<gml:%s>%s</gml:%s>"
                 % (member, _gml_geom_str({"type": single, "coordinates": c}), member)
                 for c in geo["coordinates"]]
        return "<gml:%s%s>%s</gml:%s>" % (kind, srs_attr, "".join(parts), kind)
    if kind == "GeometryCollection":
        parts = ["<gml:geometryMember>%s</gml:geometryMember>" % _gml_geom_str(g)
                 for g in geo["geometries"]]
        return "<gml:MultiGeometry%s>%s</gml:MultiGeometry>" % (srs_attr, "".join(parts))
    raise ValueError("Unsupported geometry type: %s" % kind)


def _gml_name(name):
    """The layer's XML element name: characters XML refuses become "_",
    and a name that starts with neither a letter nor "_" gets a leading
    "_".  (The JAX writer takes the file's stem as it is: a sink's
    partial named after a request token that starts with a digit is GML
    that no XML parser reads.)"""
    name = re.sub(r"[^\w.\-]", "_", name)
    return name if name[:1].isalpha() or name[:1] == "_" else "_" + name


def _write_gml(frame, path, layer=None):
    from xml.sax.saxutils import escape

    name = _gml_name(layer or os.path.splitext(os.path.basename(path))[0])
    geometry_column = frame._geometry_column_name or "geometry"
    crs = getattr(frame, "crs", None)
    parts = [
        '<?xml version="1.0" encoding="utf-8" ?>',
        "<ogr:FeatureCollection",
        '     xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"',
        '     xmlns:ogr="http://ogr.maptools.org/"',
        '     xmlns:gml="http://www.opengis.net/gml">',
    ]
    for i, (_, row) in enumerate(frame.iterrows()):
        parts.append("  <gml:featureMember>")
        parts.append('    <ogr:%s fid="%s.%s">' % (name, name, i))
        geom = row[geometry_column]
        if geom is not None:
            parts.append("      <ogr:geometryProperty>%s</ogr:geometryProperty>"
                         % _gml_geom_str(geom.__geo_interface__, crs))
        for key, value in row.items():
            value = _jsonify(value)
            if key == geometry_column or value is None:
                continue
            parts.append("      <ogr:%s>%s</ogr:%s>" % (key, escape(str(value)), key))
        parts.append("    </ogr:%s>" % name)
        parts.append("  </gml:featureMember>")
    parts.append("</ogr:FeatureCollection>")
    with open(path, "w") as f:
        f.write("\n".join(parts))


# --- KML (Placemarks, always WGS84 lon/lat per the OGC spec) ---


def _kml_coords(text):
    pts = []
    for token in (text or "").split():
        parts = token.split(",")
        pts.append((float(parts[0]), float(parts[1])))
    return pts


def _kml_geometry(element):
    from dask_geomodeling_tpu_torch.geo.geometry import (
        GeometryCollection,
        LineString,
        Point,
        Polygon,
    )

    local = _gml_local(element.tag)
    if local == "Point":
        (pt,) = _kml_coords(element.findtext("{*}coordinates"))
        return Point(*pt)
    if local == "LineString":
        return LineString(_kml_coords(element.findtext("{*}coordinates")))
    if local == "Polygon":
        outer = _kml_coords(
            element.find("{*}outerBoundaryIs/{*}LinearRing").findtext("{*}coordinates"))
        holes = [_kml_coords(ring.findtext("{*}coordinates"))
                 for ring in element.findall("{*}innerBoundaryIs/{*}LinearRing")]
        return Polygon(outer, holes)
    if local == "MultiGeometry":
        return GeometryCollection([_kml_geometry(child) for child in element])
    raise NotImplementedError("Unsupported KML geometry: %s" % local)


def _read_kml(path):
    import xml.etree.ElementTree as ET

    root = ET.parse(path).getroot()
    geometries, records, ids = [], [], []
    placemarks = [el for el in root.iter() if _gml_local(el.tag) == "Placemark"]
    for i, placemark in enumerate(placemarks):
        record = {}
        geometry = None
        for child in placemark:
            local = _gml_local(child.tag)
            if local in ("name", "description"):
                record[local] = child.text
            elif local == "ExtendedData":
                for data in child.findall("{*}Data"):
                    record[data.get("name")] = data.findtext("{*}value")
            elif local in ("Point", "LineString", "Polygon", "MultiGeometry"):
                geometry = _kml_geometry(child)
        if geometry is None:
            continue
        geometries.append(geometry)
        records.append(record)
        ids.append(placemark.get("id", i))
    table = GeoDataFrame.from_records(records) if records else None
    if table is not None:
        # KML ExtendedData values are untyped text; recover numbers the
        # way OGR's KML driver does
        _type_columns(table, _to_numeric)
    frame = _frame_of_table(table, geometries, "EPSG:4326")
    frame.index = Index(_index_values(ids), name="fid" if any(ids) else None)
    return frame


def _kml_geom_str(geom):
    kind = type(geom).__name__

    def coords(pts):
        return " ".join("%s,%s" % (repr(float(x)), repr(float(y))) for x, y in pts)

    if kind == "Point":
        return "<Point><coordinates>%s</coordinates></Point>" % coords(list(geom.coords))
    if kind == "LineString":
        return "<LineString><coordinates>%s</coordinates></LineString>" % coords(
            list(geom.coords))
    if kind == "Polygon":
        parts = ["<outerBoundaryIs><LinearRing><coordinates>%s</coordinates>"
                 "</LinearRing></outerBoundaryIs>" % coords(list(geom.exterior.coords))]
        for ring in geom.interiors:
            parts.append("<innerBoundaryIs><LinearRing><coordinates>%s</coordinates>"
                         "</LinearRing></innerBoundaryIs>" % coords(list(ring.coords)))
        return "<Polygon>%s</Polygon>" % "".join(parts)
    geoms = getattr(geom, "geoms", None)
    if geoms is not None:
        return "<MultiGeometry>%s</MultiGeometry>" % "".join(_kml_geom_str(g) for g in geoms)
    raise NotImplementedError("Cannot write %s to KML" % kind)


def _kml_document(frame):
    """The complete KML document for a frame, as a string."""
    from xml.sax.saxutils import escape

    geometry_column = frame._geometry_column_name or "geometry"
    rows = []
    for idx, row in frame.iterrows():
        fields = "".join(
            '<Data name="%s"><value>%s</value></Data>'
            % (escape(str(k)), escape(str(_jsonify(v))))
            for k, v in row.items()
            if k != geometry_column
        )
        geom = row[geometry_column]
        rows.append('<Placemark id="%s"><ExtendedData>%s</ExtendedData>%s</Placemark>'
                    % (escape(str(idx)), fields, "" if geom is None else _kml_geom_str(geom)))
    return ('<?xml version="1.0" encoding="UTF-8"?>'
            '<kml xmlns="http://www.opengis.net/kml/2.2">'
            "<Document>%s</Document></kml>" % "".join(rows))


def _write_kml(frame, path):
    with open(path, "w") as f:
        f.write(_kml_document(frame))


# --- zipped containers: KMZ and zipped shapefiles (OGR's /vsizip role) ---


def _read_kmz(path):
    import zipfile

    with zipfile.ZipFile(path) as bundle:
        names = [n for n in bundle.namelist() if n.lower().endswith(".kml")]
        if not names:
            raise IOError("No .kml document in '{}'".format(path))
        # the KMZ spec's main document is doc.kml at the archive root
        names.sort(key=lambda n: (os.path.basename(n).lower() != "doc.kml", n))
        with bundle.open(names[0]) as f:
            return _read_kml(f)


def _write_kmz(frame, path):
    import zipfile

    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as bundle:
        bundle.writestr("doc.kml", _kml_document(frame))


def _read_zip(path, layer=None):
    """Read a zipped vector dataset (typically a zipped shapefile).

    ``layer`` selects by file stem when the archive holds several
    datasets; shapefiles win ties, matching OGR's /vsizip behaviour.  The
    members are extracted into a temporary folder (``extractall`` drops
    absolute and ``..`` parts of member names) and only regular files
    inside it are read.
    """
    import tempfile
    import zipfile

    with zipfile.ZipFile(path) as bundle, tempfile.TemporaryDirectory() as tmp:
        bundle.extractall(tmp)
        inside = os.path.realpath(tmp) + os.sep
        candidates = []
        for dirpath, _, files in os.walk(tmp):
            if "__MACOSX" in dirpath.split(os.sep):
                continue
            for name in files:
                if name.startswith("."):  # hidden / AppleDouble sidecars
                    continue
                candidate = os.path.join(dirpath, name)
                if not os.path.realpath(candidate).startswith(inside):
                    continue
                ext = os.path.splitext(name)[1].lstrip(".").lower()
                if ext in supported_extensions and ext != "zip":
                    candidates.append(candidate)
        # 'layer' selects a dataset by file stem when the archive holds
        # several; otherwise it passes through to the inner reader (e.g.
        # a layer of a zipped GeoPackage)
        inner_layer = None
        if layer is not None and candidates:
            by_stem = [c for c in candidates
                       if os.path.splitext(os.path.basename(c))[0] == layer]
            if by_stem:
                candidates = by_stem
            elif len(candidates) == 1:
                inner_layer = layer
            else:
                raise IOError("No dataset named '{}' in '{}'".format(layer, path))
        if not candidates:
            raise IOError("No readable vector dataset in '{}'".format(path))
        candidates.sort(key=lambda c: (not c.lower().endswith(".shp"), c))
        return read_vector(candidates[0], inner_layer)


def _write_zip(frame, path):
    """Write a zipped shapefile (.zip / .shp.zip)."""
    import tempfile
    import zipfile

    from dask_geomodeling_tpu_torch.io.shapefile import write_shapefile

    stem = os.path.basename(path)
    for suffix in (".zip", ".shp"):
        if stem.lower().endswith(suffix):
            stem = stem[: -len(suffix)]
    with tempfile.TemporaryDirectory() as tmp:
        write_shapefile(frame, os.path.join(tmp, (stem or "layer") + ".shp"))
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as bundle:
            for name in sorted(os.listdir(tmp)):
                bundle.write(os.path.join(tmp, name), name)


# --- GPX (waypoints/routes/tracks; always EPSG:4326 per the spec) ---


_GPX_LAYERS = ("waypoints", "routes", "tracks")


def _gpx_points(element, tag):
    """(lon, lat) pairs of all <tag> descendants, document order."""
    return [(float(pt.get("lon")), float(pt.get("lat")))
            for pt in element.iter() if _gml_local(pt.tag) == tag]


def _gpx_fields(element, record):
    """Copy simple child text fields (name/desc/cmt/type/ele...) in."""
    for child in element:
        local = _gml_local(child.tag)
        if local in ("name", "desc", "cmt", "type", "sym", "src") and (child.text or "").strip():
            record[local] = child.text.strip()
        elif local == "ele" and (child.text or "").strip():
            record["ele"] = float(child.text)


def _read_gpx(path, layer=None):
    """Read a GPX file: ``layer`` is one of OGR's GPX layers
    ``waypoints``/``routes``/``tracks``; the default concatenates all
    three with a ``layer`` column."""
    import xml.etree.ElementTree as ET

    if layer is not None and layer not in _GPX_LAYERS:
        raise ValueError("Unknown GPX layer '{}' (expected one of {})".format(layer, _GPX_LAYERS))
    root = ET.parse(path).getroot()
    geometries, records = [], []

    def want(name):
        return layer is None or layer == name

    for element in root:
        local = _gml_local(element.tag)
        record = {}
        if local == "wpt" and want("waypoints"):
            record["layer"] = "waypoints"
            _gpx_fields(element, record)
            geometries.append(shape({"type": "Point", "coordinates": (
                float(element.get("lon")), float(element.get("lat")))}))
            records.append(record)
        elif local == "rte" and want("routes"):
            points = _gpx_points(element, "rtept")
            if len(points) < 2:
                continue
            record["layer"] = "routes"
            _gpx_fields(element, record)
            geometries.append(shape({"type": "LineString", "coordinates": points}))
            records.append(record)
        elif local == "trk" and want("tracks"):
            segments = [_gpx_points(seg, "trkpt") for seg in element
                        if _gml_local(seg.tag) == "trkseg"]
            segments = [s for s in segments if len(s) >= 2]
            if not segments:
                continue
            record["layer"] = "tracks"
            _gpx_fields(element, record)
            geometries.append(shape({"type": "MultiLineString", "coordinates": segments}))
            records.append(record)
    if layer is not None:
        for record in records:
            record.pop("layer", None)
    return _frame(records, geometries, "EPSG:4326")


def _write_gpx(frame, path):
    """Write points as waypoints and (multi)linestrings as tracks;
    polygons raise, columns beyond GPX's simple fields are dropped."""
    from xml.sax.saxutils import escape

    geometry_column = frame._geometry_column_name or "geometry"
    lines = ['<?xml version="1.0" encoding="UTF-8"?>']
    lines.append('<gpx version="1.1" creator="dask_geomodeling_tpu" '
                 'xmlns="http://www.topografix.com/GPX/1/1">')

    def fields(row, with_ele):
        # <ele> is valid on waypoints only; trkType has no ele child
        keys = ("name", "cmt", "desc", "src", "sym", "type")
        if with_ele:
            keys = ("ele",) + keys
        return "".join("<%s>%s</%s>" % (key, escape(str(row[key])), key)
                       for key in keys if key in row and not is_null(row[key]))

    def trkseg(coords):
        return "<trkseg>%s</trkseg>" % "".join(
            '<trkpt lat="%s" lon="%s"></trkpt>' % (repr(float(y)), repr(float(x)))
            for x, y in coords)

    for _, row in frame.iterrows():
        geom = row[geometry_column]
        if geom is None:
            continue
        kind = type(geom).__name__
        if kind == "Point":
            (x, y), = list(geom.coords)
            lines.append('<wpt lat="%s" lon="%s">%s</wpt>'
                         % (repr(float(y)), repr(float(x)), fields(row, True)))
        elif kind == "LineString":
            lines.append("<trk>%s%s</trk>" % (fields(row, False), trkseg(list(geom.coords))))
        elif kind == "MultiLineString":
            segs = "".join(trkseg(list(g.coords)) for g in geom.geoms)
            lines.append("<trk>%s%s</trk>" % (fields(row, False), segs))
        else:
            raise ValueError("GPX cannot represent '%s' geometries" % kind)
    lines.append("</gpx>")
    with open(path, "w") as f:
        f.write("\n".join(lines))


# --- public API ---


def read_vector(path, layer=None):
    """Read a vector file into a GeoDataFrame (crs attribute set)."""
    fmt = _format_of(path)
    if fmt == "fgb":
        from dask_geomodeling_tpu_torch.io.flatgeobuf import read_flatgeobuf

        return read_flatgeobuf(path)
    if fmt == "mif":
        from dask_geomodeling_tpu_torch.io.mapinfo import read_mif

        return read_mif(path)
    if fmt == "dxf":
        from dask_geomodeling_tpu_torch.io.dxf import read_dxf

        return read_dxf(path)
    if fmt in ("geojson", "json"):
        return _read_geojson(path)
    if fmt in ("geojsonl", "ndjson"):
        return _read_geojsonl(path)
    if fmt == "shp":
        from dask_geomodeling_tpu_torch.io.shapefile import read_shapefile

        return read_shapefile(path)
    if fmt == "gml":
        return _read_gml(path)
    if fmt == "kml":
        return _read_kml(path)
    if fmt == "kmz":
        return _read_kmz(path)
    if fmt == "topojson":
        from dask_geomodeling_tpu_torch.io.topojson import read_topojson

        return read_topojson(path, layer)
    if fmt == "sqlite":
        from dask_geomodeling_tpu_torch.io.spatialite import read_spatialite

        return read_spatialite(path, layer)
    if fmt == "zip":
        return _read_zip(path, layer)
    if fmt == "csv":
        return _read_csv(path)
    if fmt == "gpx":
        return _read_gpx(path, layer)
    if fmt == "osm":
        from dask_geomodeling_tpu_torch.io.osm import read_osm

        return read_osm(path, layer)
    return _read_gpkg(path, layer)


def read_vector_info(path, layer=None):
    """Return {'fields': [...], 'crs': str} without loading all features."""
    fmt = _format_of(path)
    if fmt != "gpkg":
        from dask_geomodeling_tpu_torch.runtime.pipeline import read_vector_cached

        frame = read_vector_cached(path, layer)
        fields = [c for c in frame.columns if c != "geometry"]
        return {"fields": fields, "crs": frame.crs}
    con = sqlite3.connect(path)
    try:
        contents = con.execute(
            "SELECT table_name, srs_id FROM gpkg_contents "
            "WHERE data_type = 'features'"
        ).fetchall()
        if not contents:
            raise IOError("No feature layers in '{}'".format(path))
        table, srs_id = contents[0] if layer is None else next(
            c for c in contents if c[0] == layer
        )
        cols = con.execute('PRAGMA table_info("{}")'.format(table)).fetchall()
        fields = [c[1] for c in cols if c[1] not in ("fid", "geom")]
        return {"fields": fields, "crs": "EPSG:%d" % srs_id if srs_id else None}
    finally:
        con.close()


def write_vector(frame, path, layer=None):
    """Write a GeoDataFrame to a vector file (format from the extension).
    OSM is read only: an ``.osm`` path raises (the JAX package writes a
    GeoPackage under that name)."""
    fmt = _format_of(path)
    if fmt in ("geojson", "json"):
        _write_geojson(frame, path)
    elif fmt in ("geojsonl", "ndjson"):
        _write_geojsonl(frame, path)
    elif fmt == "shp":
        from dask_geomodeling_tpu_torch.io.shapefile import write_shapefile

        write_shapefile(frame, path)
    elif fmt == "gml":
        _write_gml(frame, path, layer)
    elif fmt == "kml":
        _write_kml(frame, path)
    elif fmt == "kmz":
        _write_kmz(frame, path)
    elif fmt == "topojson":
        from dask_geomodeling_tpu_torch.io.topojson import write_topojson

        write_topojson(frame, path, layer)
    elif fmt == "sqlite":
        from dask_geomodeling_tpu_torch.io.spatialite import write_spatialite

        write_spatialite(frame, path, layer)
    elif fmt == "zip":
        _write_zip(frame, path)
    elif fmt == "csv":
        _write_csv(frame, path)
    elif fmt == "gpx":
        _write_gpx(frame, path)
    elif fmt == "fgb":
        from dask_geomodeling_tpu_torch.io.flatgeobuf import write_flatgeobuf

        write_flatgeobuf(frame, path, layer or "layer")
    elif fmt == "mif":
        from dask_geomodeling_tpu_torch.io.mapinfo import write_mif

        write_mif(frame, path)
    elif fmt == "dxf":
        from dask_geomodeling_tpu_torch.io.dxf import write_dxf

        write_dxf(frame, path)
    elif fmt == "osm":
        raise NotImplementedError(
            "OSM XML is read only: no writer for '%s' (the OSM layers come from "
            "the OpenStreetMap tools)" % path)
    else:
        if os.path.exists(path):
            os.remove(path)
        _write_gpkg(frame, path, layer or "layer")
