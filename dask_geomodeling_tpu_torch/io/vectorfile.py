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
- CSV (.csv): a WKT geometry column, numeric-looking columns typed.

Every other extension the JAX package reads raises NotImplementedError
naming the JAX module that reads it.  FlatGeobuf needs the ``flatbuffers``
runtime and GeoParquet ``pyarrow``, which the card machine does not have.

API: ``read_vector``, ``read_vector_info``, ``write_vector``,
``gpkg_rtree_name`` and ``supported_extensions``.
"""
import json
import os
import sqlite3
import struct

import numpy as np

from dask_geomodeling_tpu_torch.geo import _wkt
from dask_geomodeling_tpu_torch.geo.features import (
    GeoDataFrame,
    Index,
    _infer,
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

supported_extensions = {"geojson", "json", "geojsonl", "ndjson", "gpkg", "shp", "csv"}

#: extensions the JAX package reads and writes and the port does not, and
#: where the JAX package handles each
_UNPORTED = {
    "gml": "io/vectorfile.py (_read_gml, _write_gml)",
    "kml": "io/vectorfile.py (_read_kml, _write_kml)",
    "kmz": "io/vectorfile.py (_read_kmz, _write_kmz)",
    "gpx": "io/vectorfile.py (_read_gpx, _write_gpx)",
    "zip": "io/vectorfile.py (_read_zip, _write_zip)",
    "topojson": "io/topojson.py",
    "sqlite": "io/spatialite.py",
    "mif": "io/mapinfo.py",
    "dxf": "io/dxf.py",
    "osm": "io/osm.py",
    "fgb": "io/flatgeobuf.py (it needs the flatbuffers runtime, which the card machine lacks)",
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
    frame = GeoDataFrame.from_records(records) if records else None
    if frame is None or not frame.columns:
        return GeoDataFrame(geometry=geometries, crs=crs)
    return GeoDataFrame(frame, geometry=geometries, crs=crs)


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


def _number(text):
    """One cell of CSV text as pandas' to_numeric parses it: an int, a
    float (inf and infinity too, not nan), None (NaN) for an empty cell;
    ValueError for anything else (nan, underscores, non-ASCII digits)."""
    text = text.strip()
    if not text:
        return None
    if not text.isascii() or "_" in text or text.lstrip("+-").lower() == "nan":
        raise ValueError(text)
    try:
        return int(text)
    except ValueError:
        return float(text)


def _to_numeric(texts):
    """A column of CSV text as pandas' to_numeric types it: all integers
    int64, else numbers (an empty cell NaN) float64; None when a cell is
    not a number (the column stays text)."""
    try:
        numbers = [_number(text) for text in texts]
    except ValueError:
        return None
    if all(isinstance(n, int) for n in numbers):
        try:
            return np.array(numbers, dtype=np.int64)
        except OverflowError:
            return None
    return np.array([np.nan if n is None else n for n in numbers], dtype=float)


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
    for column in frame.columns:
        numbers = _to_numeric(frame[column].tolist())
        if numbers is not None:
            frame[column] = numbers
    return GeoDataFrame(frame, geometry=geometries, crs=None)


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


# --- public API ---


def read_vector(path, layer=None):
    """Read a vector file into a GeoDataFrame (crs attribute set)."""
    fmt = _format_of(path)
    if fmt in ("geojson", "json"):
        return _read_geojson(path)
    if fmt in ("geojsonl", "ndjson"):
        return _read_geojsonl(path)
    if fmt == "shp":
        from dask_geomodeling_tpu_torch.io.shapefile import read_shapefile

        return read_shapefile(path)
    if fmt == "csv":
        return _read_csv(path)
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
    """Write a GeoDataFrame to a vector file (format from the extension)."""
    fmt = _format_of(path)
    if fmt in ("geojson", "json"):
        _write_geojson(frame, path)
    elif fmt in ("geojsonl", "ndjson"):
        _write_geojsonl(frame, path)
    elif fmt == "shp":
        from dask_geomodeling_tpu_torch.io.shapefile import write_shapefile

        write_shapefile(frame, path)
    elif fmt == "csv":
        _write_csv(frame, path)
    else:
        if os.path.exists(path):
            os.remove(path)
        _write_gpkg(frame, path, layer or "layer")
