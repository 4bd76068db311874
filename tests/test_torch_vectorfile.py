"""The port's vector files (io/vectorfile.py, io/shapefile.py) and its
vector read cache, held on the CPU to the JAX package's.

Each ported format round-trips, and each package reads the other's
files to the same frame.  GeoJSON, GeoJSON sequences, CSV and the
Shapefile's five files are byte-identical to the JAX writer's; a
GeoPackage's contents are equal (its schema, every row, the geometry
blobs, the gpkg_* tables but the write time, the R-tree entries).  Then
the R-tree bbox read, unicode text and special floats, the DBF code pages
and date fields of tests/test_geometry_sources_sinks.py, the unported
extensions (GeoParquet; FlatGeobuf is in tests/test_torch_flatgeobuf.py,
the other formats in tests/test_torch_vector_formats.py), and the read
cache's stamp.
"""
import os
import sqlite3
import unittest.mock as mock

import numpy as np
import pandas as pd
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo.features import GeoDataFrame as JaxGeoDataFrame
from dask_geomodeling_tpu.io import vectorfile as jax_vectorfile
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
from dask_geomodeling_tpu_torch.geometry import GeometryFileSource
from dask_geomodeling_tpu_torch.io import vectorfile
from dask_geomodeling_tpu_torch.runtime import pipeline

PORTED = ["geojson", "json", "geojsonl", "ndjson", "gpkg", "shp", "csv"]
BYTE_IDENTICAL = ["geojson", "geojsonl", "csv"]

#: one of each geometry type the ported formats write (a shapefile takes
#: one type: polygons)
WKTS = [
    "POLYGON ((135000 456000, 135010.5 456000, 135010.5 456012.25, 135000 456000))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2))",
    "MULTIPOLYGON (((0 0, 4 0, 4 4, 0 4, 0 0)), ((6 6, 9 6, 9 9, 6 9, 6 6)))",
    "POINT (135010.5 455990.25)",
    "LINESTRING (0 0, 10 0, 10 10, 3.3 7.1)",
]
COLUMNS = {
    "count": [3, -7, 12, 0, 2**40],
    "value": [1.5, float("nan"), -0.0, 1e300, float("inf")],
    "label": ["café", None, "中文", 'a,b"c', ""],
    "flag": [True, False, True, False, True],
    "maybe": [True, None, False, True, None],
}
SHP_COLUMNS = {
    "count": [3, -7, 12],
    "value": [1.5, float("nan"), -0.0],
    "label": ["café", None, "中文 text"],
    "flag": [True, False, True],
}


def frames(columns=COLUMNS, wkts=WKTS, crs="EPSG:28992", index=None):
    """(port frame, JAX frame) of the same columns and geometries."""
    n = len(wkts)
    columns = {k: v[:n] for k, v in columns.items()}
    ref = JaxGeoDataFrame(pd.DataFrame(columns), geometry=[jax_geometry.from_wkt(w) for w in wkts],
                          crs=crs)
    port = GeoDataFrame({k: list(v) for k, v in columns.items()},
                        geometry=[geometry.from_wkt(w) for w in wkts], crs=crs)
    if index is not None:
        from dask_geomodeling_tpu_torch.geo.features import Index

        ref.index = pd.Index(index, name="fid")
        port.index = Index(np.asarray(index), name="fid")
    return port, ref


def assert_same_read(port, ref):
    """A frame the port read against the one the JAX package read."""
    assert port.columns == list(ref.columns)
    assert port.crs == ref.crs
    assert port.index.name == ref.index.name
    assert port.index.values.tolist() == ref.index.tolist()
    for column in ref.columns:
        if column == ref._geometry_column_name:
            assert [None if g is None else g.wkb for g in port[column]] == \
                [None if g is None else g.wkb for g in ref[column]]
            continue
        assert repr(port[column].tolist()) == repr(ref[column].tolist()), column
        dtype = ref[column].dtype
        if isinstance(dtype, np.dtype) and dtype != object:
            assert port[column].dtype.kind == dtype.kind, column


def _family(path):
    base = os.path.splitext(path)[0]
    return {ext: open(base + ext, "rb").read() for ext in
            (".shp", ".shx", ".dbf", ".prj", ".cpg") if os.path.exists(base + ext)}


def gpkg_contents(path):
    """Everything a GeoPackage holds, but gpkg_contents' write time."""
    con = sqlite3.connect(path)
    try:
        schema = sorted(con.execute(
            "SELECT type, name, tbl_name, sql FROM sqlite_master").fetchall(), key=repr)
        tables = {}
        for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type = 'table' "
                                   "OR (type = 'table' AND sql LIKE '%VIRTUAL%')"):
            if name.startswith("sqlite_") or "_node" in name or "_parent" in name \
                    or "_rowid" in name:
                continue
            cursor = con.execute('SELECT * FROM "%s"' % name)
            names = [d[0] for d in cursor.description]
            rows = [tuple(v for k, v in zip(names, row) if k != "last_change")
                    for row in cursor.fetchall()]
            tables[name] = (names, rows)
        pragmas = [con.execute("PRAGMA %s" % p).fetchone() for p in
                   ("application_id", "user_version")]
        return schema, tables, pragmas
    finally:
        con.close()


# --- round trips, both directions ---


@pytest.mark.parametrize("ext", PORTED)
def test_round_trip_across_packages(tmp_path, ext):
    columns = SHP_COLUMNS if ext == "shp" else COLUMNS
    wkts = WKTS[:3] if ext == "shp" else WKTS
    port, ref = frames(columns, wkts)
    ours, theirs = str(tmp_path / ("port." + ext)), str(tmp_path / ("jax." + ext))
    vectorfile.write_vector(port, ours)
    jax_vectorfile.write_vector(ref, theirs)
    for path in (ours, theirs):
        assert_same_read(vectorfile.read_vector(path), jax_vectorfile.read_vector(path))
    back = vectorfile.read_vector(ours)
    assert len(back) == len(wkts)
    assert back.geometry.values[0].equals(geometry.from_wkt(wkts[0]))


@pytest.mark.parametrize("ext", BYTE_IDENTICAL)
@pytest.mark.parametrize("index", [None, [4, 9, 2, 7, 11]])
def test_text_files_are_byte_identical(tmp_path, ext, index):
    port, ref = frames(index=index)
    vectorfile.write_vector(port, str(tmp_path / ("port." + ext)))
    jax_vectorfile.write_vector(ref, str(tmp_path / ("jax." + ext)))
    assert (tmp_path / ("port." + ext)).read_bytes() == (tmp_path / ("jax." + ext)).read_bytes()


@pytest.mark.parametrize("crs", ["EPSG:28992", "EPSG:4326", None])
def test_shapefile_is_byte_identical(tmp_path, crs):
    port, ref = frames(SHP_COLUMNS, WKTS[:3], crs=crs)
    vectorfile.write_vector(port, str(tmp_path / "port.shp"))
    jax_vectorfile.write_vector(ref, str(tmp_path / "jax.shp"))
    ours, theirs = _family(str(tmp_path / "port.shp")), _family(str(tmp_path / "jax.shp"))
    assert sorted(ours) == sorted(theirs)
    for ext in theirs:
        assert ours[ext] == theirs[ext], ext


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_shapefile_points_and_lines_byte_identical(tmp_path, kind):
    wkts = (["POINT (1 2)", "POINT (3.5 -4)"] if kind == "points"
            else ["LINESTRING (0 0, 1 1)", "MULTILINESTRING ((0 0, 1 1), (2 2, 3 1))"])
    port, ref = frames({"n": [1, 2]}, wkts)
    vectorfile.write_vector(port, str(tmp_path / "port.shp"))
    jax_vectorfile.write_vector(ref, str(tmp_path / "jax.shp"))
    assert _family(str(tmp_path / "port.shp")) == _family(str(tmp_path / "jax.shp"))


@pytest.mark.parametrize("index", [None, [4, 9, 2, 7, 11], [1, 1, 2, 3, 5]])
def test_geopackage_contents_equal(tmp_path, index):
    port, ref = frames(index=index)
    vectorfile.write_vector(port, str(tmp_path / "port.gpkg"), layer="pand")
    jax_vectorfile.write_vector(ref, str(tmp_path / "jax.gpkg"), layer="pand")
    assert gpkg_contents(str(tmp_path / "port.gpkg")) == gpkg_contents(str(tmp_path / "jax.gpkg"))
    assert vectorfile.gpkg_rtree_name(str(tmp_path / "port.gpkg"), "pand") == "rtree_pand_geom"


def test_geopackage_info_and_layers(tmp_path):
    port, ref = frames()
    path = str(tmp_path / "layers.gpkg")
    vectorfile.write_vector(port, path, layer="pand")
    assert vectorfile.read_vector_info(path, "pand") == jax_vectorfile.read_vector_info(path,
                                                                                        "pand")
    with pytest.raises(IOError, match="not found"):
        vectorfile.read_vector(path, layer="other")
    assert_same_read(vectorfile.read_vector(path, layer="pand"),
                     jax_vectorfile.read_vector(path, layer="pand"))


# --- the R-tree bbox read ---


@pytest.mark.parametrize("bbox, projection", [
    ((135005, 456005, 135020, 456020), "EPSG:28992"),
    ((-1, -1, 5, 5), "EPSG:28992"),
    ((0, 0, 0, 0), "EPSG:28992"),
    ((3.31, 52.0, 3.32, 52.1), "EPSG:4326"),
    ((1e9, 1e9, 1e9 + 1, 1e9 + 1), "EPSG:28992"),
])
def test_rtree_bbox_read(tmp_path, bbox, projection):
    rng = np.random.RandomState(3)
    centres = rng.uniform(-50, 50, size=(60, 2)) + (135000, 456000)
    wkts = [geometry.box(x, y, x + rng.uniform(1, 20), y + rng.uniform(1, 20)).wkt
            for x, y in centres] + WKTS
    port, _ = frames({"n": list(range(len(wkts)))}, wkts)
    path = str(tmp_path / "indexed.gpkg")
    vectorfile.write_vector(port, path, layer="pand")
    ours = vectorfile._read_gpkg(path, "pand", bbox=bbox, bbox_projection=projection)
    theirs = jax_vectorfile._read_gpkg(path, "pand", bbox=bbox, bbox_projection=projection)
    assert_same_read(ours, theirs)
    whole = vectorfile.read_vector(path, "pand")
    if projection == "EPSG:28992":  # the index's envelopes: the same rows as a bounds scan
        bounds = np.array([g.bounds for g in whole.geometry.values])
        touch = ~((bounds[:, 2] < bbox[0]) | (bounds[:, 0] > bbox[2])
                  | (bounds[:, 3] < bbox[1]) | (bounds[:, 1] > bbox[3]))
        assert sorted(ours.index.values.tolist()) == sorted(
            whole.index.values[touch].tolist())


# --- unicode, special floats, DBF code pages and dates ---


@pytest.mark.parametrize("ext", PORTED)
def test_unicode_and_special_floats(tmp_path, ext):
    values = {"label": ["café", "中文", "Ø​x"], "x": [-1.5, 0.0, 2.5e-300]}
    if ext != "shp":
        values["x"] = [-np.inf, np.inf, np.nan]
    port, ref = frames(values, WKTS[:3])
    path = str(tmp_path / ("uni." + ext))
    vectorfile.write_vector(port, path)
    result = vectorfile.read_vector(path)
    assert result["label"].tolist() == values["label"]
    assert_same_read(result, jax_vectorfile.read_vector(path))
    if ext == "shp":  # 8 decimals in the DBF
        assert result["x"].tolist() == [-1.5, 0.0, 0.0]
    elif ext == "csv":  # 'nan' is no number to pandas' to_numeric: text, as in the JAX reader
        assert result["x"].tolist() == ["-inf", "inf", "nan"]
    else:
        assert repr(result["x"].tolist()) == repr(values["x"])


def _dbf_with(tmp_path, text):
    path = str(tmp_path / "enc.shp")
    frame = GeoDataFrame({"geometry": [geometry.Point(1, 1)], "name": [text]}, crs="EPSG:4326")
    vectorfile.write_vector(frame, path)
    return os.path.splitext(path)[0]


def _patch(path, replace=None, ldid=None):
    with open(path, "rb") as f:
        raw = f.read()
    if replace is not None:
        raw = raw.replace(*replace)
    if ldid is not None:
        raw = raw[:29] + bytes([ldid]) + raw[30:]
    with open(path, "wb") as f:
        f.write(raw)


@pytest.mark.parametrize("case", ["ldid_fallback", "cpg_wins_over_ldid", "default_cp1252",
                                  "ansi_1252_cpg"])
def test_dbf_code_pages(tmp_path, case):
    """OGR's precedence, as tests/test_geometry_sources_sinks.py holds the
    JAX reader to it: the .cpg sidecar, then the DBF's language driver
    id, then cp1252."""
    text = "Жук" if case == "ldid_fallback" else "café"
    base = _dbf_with(tmp_path, text)
    if case == "ldid_fallback":
        os.remove(base + ".cpg")
        _patch(base + ".dbf", (text.encode("utf-8"), text.encode("cp1251") + b"   "), 0xC9)
    elif case == "cpg_wins_over_ldid":
        _patch(base + ".dbf", ldid=0xC9)
    elif case == "default_cp1252":
        os.remove(base + ".cpg")
        _patch(base + ".dbf", (text.encode("utf-8"), text.encode("cp1252") + b" "))
    else:
        with open(base + ".cpg", "w") as f:
            f.write("ANSI 1252")
        _patch(base + ".dbf", (text.encode("utf-8"), text.encode("cp1252") + b" "))
    result = vectorfile.read_vector(base + ".shp")
    assert result["name"].tolist() == [text]
    assert_same_read(result, jax_vectorfile.read_vector(base + ".shp"))


def test_dbf_date_and_float_fields(tmp_path):
    path = str(tmp_path / "typed.shp")
    frame = GeoDataFrame(
        {"geometry": [geometry.Point(1, 1), geometry.Point(2, 2), geometry.Point(3, 3)],
         "when": [np.datetime64("2026-08-17"), np.datetime64("1999-12-31"), None],
         "name": ["a", "b", "c"]},
        crs="EPSG:4326",
    )
    assert frame["when"].dtype.kind == "M"
    vectorfile.write_vector(frame, path)
    ref = JaxGeoDataFrame(
        {"geometry": [jax_geometry.Point(1, 1), jax_geometry.Point(2, 2),
                      jax_geometry.Point(3, 3)],
         "when": pd.to_datetime(["2026-08-17", "1999-12-31", None]), "name": ["a", "b", "c"]},
        crs="EPSG:4326",
    )
    jax_vectorfile.write_vector(ref, str(tmp_path / "jax_typed.shp"))
    assert _family(path) == _family(str(tmp_path / "jax_typed.shp"))
    back = vectorfile.read_vector(path)
    assert back["when"].values.tolist()[:2] == [
        np.datetime64("2026-08-17", "us").item(), np.datetime64("1999-12-31", "us").item()]
    assert np.isnat(back["when"].values[2])
    jax_back = jax_vectorfile.read_vector(path)
    assert [None if pd.isna(t) else t.to_pydatetime() for t in jax_back["when"]] == \
        back["when"].values.tolist()
    # a foreign F-type field: patch the descriptor of a numeric column
    frame2 = GeoDataFrame({"geometry": [geometry.Point(1, 1)], "v": [2.5]}, crs="EPSG:4326")
    vectorfile.write_vector(frame2, str(tmp_path / "f.shp"))
    dbf = str(tmp_path / "f.dbf")
    with open(dbf, "rb") as f:
        raw = bytearray(f.read())
    assert raw[32 + 11: 32 + 12] == b"N"
    raw[32 + 11] = ord("F")
    with open(dbf, "wb") as f:
        f.write(bytes(raw))
    assert vectorfile.read_vector(str(tmp_path / "f.shp"))["v"].tolist() == [2.5]


def test_dbf_value_too_wide_raises_as_the_jax_writer(tmp_path):
    port, ref = frames({"value": [1e300, 1.0, 2.0]}, WKTS[:3])
    for module, frame in ((vectorfile, port), (jax_vectorfile, ref)):
        with pytest.raises(ValueError, match="does not fit"):
            module.write_vector(frame, str(tmp_path / "wide.shp"))


def test_csv_numeric_columns_and_legacy_crs(tmp_path):
    csv = tmp_path / "typed.csv"
    csv.write_text('geometry,a,b,c,d\n"POINT (1 2)",1,1.5,x,1e3\n"POINT (3 4)",2,nan,y,7\n'
                   ',3,inf,,-2\n')
    assert_same_read(vectorfile.read_vector(str(csv)), jax_vectorfile.read_vector(str(csv)))
    legacy = tmp_path / "legacy.geojson"
    legacy.write_text('{"type": "FeatureCollection", "crs": {"type": "name", "properties": '
                      '{"name": "urn:ogc:def:crs:EPSG::28992"}}, "features": [{"type": '
                      '"Feature", "geometry": {"type": "Point", "coordinates": [155000.0, '
                      '463000.0]}, "properties": {"v": 1, "w": null}}]}')
    assert vectorfile.read_vector(str(legacy)).crs == "EPSG:28992"
    assert_same_read(vectorfile.read_vector(str(legacy)), jax_vectorfile.read_vector(str(legacy)))


@pytest.mark.parametrize("ext", ["parquet", "geoparquet"])
def test_unported_extensions_raise_naming_their_module(tmp_path, ext):
    port, _ = frames()
    path = str(tmp_path / ("x." + ext))
    for call in (lambda: vectorfile.write_vector(port, path),
                 lambda: vectorfile.read_vector(path)):
        with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/"):
            call()
    with pytest.raises(NotImplementedError, match="card machine lacks"):
        vectorfile.read_vector(path)
    with pytest.raises(NotImplementedError, match="Unsupported"):
        vectorfile.read_vector(str(tmp_path / "x.xyz"))


# --- the read cache ---


@pytest.fixture
def root(tmp_path):
    pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path)}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        yield tmp_path


def test_read_cache_is_validated_by_stamp(root):
    """A file parses once per stamp, whatever the projection asked, and a
    rewrite is parsed again; layers are cached apart."""
    port, _ = frames(crs="EPSG:4326", wkts=[geometry.box(0.1 * i, 0, 0.1 * i + 0.05, 0.5).wkt
                                            for i in range(5)])
    path = root / "cached.gpkg"
    vectorfile.write_vector(port, str(path), layer="a")
    source = GeometryFileSource("cached.gpkg", layer="a")
    calls = []
    real = vectorfile.read_vector

    def counting(p, layer=None):
        calls.append((p, layer))
        return real(p, layer=layer)

    request = dict(mode="intersects", geometry=geometry.box(-1, -1, 11, 11),
                   projection="EPSG:4326")
    with mock.patch.object(vectorfile, "read_vector", counting):
        first = source.get_data(device="cpu", **request)
        second = source.get_data(device="cpu", **request)
        third = source.get_data(device="cpu", **dict(
            request, projection="EPSG:3857", geometry=geometry.box(-1e7, -1e7, 1e7, 1e7)))
    assert len(calls) == 1
    assert len(first["features"]) == len(second["features"]) == len(third["features"]) == 5
    assert third["features"].geometry.values[1].bounds[0] > 10000
    assert first["features"].crs == "EPSG:4326"  # the cached frame kept its crs
    vectorfile.write_vector(port.iloc[[0, 1]], str(root / "cached.gpkg"), layer="a")
    with mock.patch.object(vectorfile, "read_vector", counting):
        fourth = source.get_data(device="cpu", **request)
        pipeline.read_vector_cached(str(root / "cached.gpkg"), "a")
    assert len(calls) == 2 and len(fourth["features"]) == 2
    pipeline.clear_read_cache()
    with mock.patch.object(vectorfile, "read_vector", counting):
        pipeline.read_vector_cached(str(root / "cached.gpkg"), "a")
        pipeline.read_vector_cached(str(root / "cached.gpkg"), None)
    assert calls[2:] == [(str(root / "cached.gpkg"), "a"), (str(root / "cached.gpkg"), None)]
