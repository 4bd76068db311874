"""The port's GML, KML, KMZ, GPX, zipped, TopoJSON, SpatiaLite, MapInfo
MIF/MID, DXF and OSM codecs (io/vectorfile.py, io/topojson.py,
io/spatialite.py, io/mapinfo.py, io/dxf.py, io/osm.py), held on the CPU
to the JAX package's.

Each format round-trips across the packages in both directions (each
package reads the other's file to the same frame: columns, dtypes, index,
crs, geometries bitwise).  GML, KML, GPX, TopoJSON, MIF+MID and DXF files
are byte-identical to the JAX writer's, the members of KMZ and zip
archives too, and a SpatiaLite file's contents are equal.  GML's column
typing (pandas' ``astype``) and KML's (``to_numeric``) are held to pandas
3.0.3 with hypothesis.  Then every case of tests/test_mapinfo_dxf.py and
tests/test_osm.py, and the format cases of
tests/test_geometry_sources_sinks.py, each run once in each package: the
same files come out and the same frames are read.  pandas is imported
here only as the JAX package's frame and as the typing yardstick.
"""
import json
import os
import sqlite3
import struct
import types
import zipfile
from datetime import datetime

import numpy as np
import pandas as pd
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo.features import GeoDataFrame as JaxGeoDataFrame
from dask_geomodeling_tpu.io import dxf as jax_dxf
from dask_geomodeling_tpu.io import mapinfo as jax_mapinfo
from dask_geomodeling_tpu.io import osm as jax_osm
from dask_geomodeling_tpu.io import spatialite as jax_spatialite
from dask_geomodeling_tpu.io import vectorfile as jax_vectorfile
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import geometry as port_blocks
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, Index
from dask_geomodeling_tpu_torch.io import dxf, mapinfo, osm, spatialite, vectorfile
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_vectorfile import _family, assert_same_read, gpkg_contents

NEW_FORMATS = ["gml", "kml", "kmz", "gpx", "zip", "topojson", "sqlite", "mif", "dxf"]

POLYGONS = [
    "POLYGON ((135000 456000, 135010.5 456000, 135010.5 456012.25, 135000 456000))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2))",
    "MULTIPOLYGON (((0 0, 4 0, 4 4, 0 4, 0 0)), ((6 6, 9 6, 9 9, 6 9, 6 6)))",
    "POLYGON ((0.1 0.2, 0.30000000000000004 0.2, 0.3 0.7, 0.1 0.2))",
]
MIXED = POLYGONS[:3] + ["POINT (135010.5 455990.25)", "LINESTRING (0 0, 10 0, 10 10, 3.3 7.1)"]
TRACKS = ["POINT (4.3 52.1)", "LINESTRING (4 52, 4.1 52.1, 4.25 52.05)",
          "MULTILINESTRING ((4 52, 4.1 52.1), (4.2 52.2, 4.3 52.3, 4.4 52.2))",
          "POINT (-0.5 1e-05)"]
COLUMNS = {
    "count": [3, -7, 12, 0, 2**40],
    "value": [1.5, float("nan"), -0.0, 0.30000000000000004, float("inf")],
    "label": ["café", None, "中文", 'a,b"c <&>', ""],
    "flag": [True, False, True, False, True],
}
GPX_COLUMNS = {"name": ["home", None, "run", "b <&>"], "ele": [2.5, 1.0, np.nan, -3.0],
               "desc": ["x", "y", "z", "w"], "other": [1, 2, 3, 4]}
DXF_COLUMNS = {"Layer": ["roads", "water", "0", "walls", "area"]}
SHP_COLUMNS = {"count": [3, -7, 12, 5], "value": [1.5, float("nan"), -0.0, 2.0],
               "label": ["café", None, "中文 text", "x"]}

#: (columns, geometries, crs) each format writes: GPX holds points and
#: lines, a shapefile one geometry type
CONTENT = {
    "gml": (COLUMNS, MIXED, "EPSG:28992"),
    "kml": (COLUMNS, MIXED, "EPSG:4326"),
    "kmz": (COLUMNS, MIXED, "EPSG:4326"),
    "gpx": (GPX_COLUMNS, TRACKS, "EPSG:4326"),
    "zip": (SHP_COLUMNS, POLYGONS, "EPSG:28992"),
    "topojson": (COLUMNS, MIXED, "EPSG:4326"),
    "sqlite": (COLUMNS, MIXED, "EPSG:28992"),
    "mif": (COLUMNS, MIXED, "EPSG:4326"),
    "dxf": (DXF_COLUMNS, MIXED, None),
}


def frames(columns, wkts, crs, index=None):
    """(port frame, JAX frame) of the same columns and geometries."""
    n = len(wkts)
    columns = {k: list(v)[:n] for k, v in columns.items()}
    ref = JaxGeoDataFrame(pd.DataFrame(columns) if columns else None,
                          geometry=[jax_geometry.from_wkt(w) for w in wkts], crs=crs)
    port = GeoDataFrame(columns or None, geometry=[geometry.from_wkt(w) for w in wkts], crs=crs)
    if index is not None:
        ref.index = pd.Index(index, name="fid")
        port.index = Index(np.asarray(index), name="fid")
    return port, ref


def members(path):
    """A zip archive's members and their bytes (the archive's own bytes
    carry timestamps, and so does a GeoPackage: its contents stand in)."""
    import tempfile

    out = {}
    with zipfile.ZipFile(path) as bundle:
        for name in sorted(bundle.namelist()):
            out[name] = bundle.read(name)
            if name.endswith(".gpkg"):
                with tempfile.TemporaryDirectory() as tmp:
                    out[name] = gpkg_contents(bundle.extract(name, tmp))
    return out


def sqlite_contents(path):
    """Every table's schema and rows (R-tree shadow tables left out)."""
    con = sqlite3.connect(path)
    try:
        schema = sorted(con.execute("SELECT type, name, tbl_name, sql FROM sqlite_master")
                        .fetchall(), key=repr)
        tables = {}
        for (name,) in con.execute("SELECT name FROM sqlite_master WHERE type = 'table'"):
            if name.startswith("sqlite_") or name.endswith(("_node", "_parent", "_rowid")):
                continue
            tables[name] = con.execute('SELECT * FROM "%s"' % name).fetchall()
        return schema, tables
    finally:
        con.close()


def same_file(ours, theirs):
    """The file (and its sidecars) ``ours`` holds what ``theirs`` holds:
    the same bytes, archive members or SQLite contents."""
    ext = os.path.splitext(ours)[1].lower()
    if ext == ".sqlite":
        assert sqlite_contents(ours) == sqlite_contents(theirs)
    elif ext in (".zip", ".kmz"):
        assert members(ours) == members(theirs)
    elif ext == ".shp":
        assert _family(ours) == _family(theirs)
    elif ext == ".gpkg":
        assert gpkg_contents(ours) == gpkg_contents(theirs)
    else:
        assert open(ours, "rb").read() == open(theirs, "rb").read()
    if ext == ".mif":
        mid = os.path.splitext(ours)[0] + ".mid"
        assert open(mid, "rb").read() == open(os.path.splitext(theirs)[0] + ".mid", "rb").read()


def paths(tmp_path, name):
    """(the port's path, the JAX package's path) of one file name, in
    folders of their own (writers name layers and members after it)."""
    for side in ("port", "jax"):
        (tmp_path / side).mkdir(exist_ok=True)
    return str(tmp_path / "port" / name), str(tmp_path / "jax" / name)


def repaired_gml_writer(frame, path, layer=None, _write=jax_vectorfile._write_gml):
    """The JAX GML writer with the port's layer name (the file's stem
    made an XML name): the same bytes wherever the JAX writer writes
    XML."""
    stem = os.path.splitext(os.path.basename(path))[0]
    return _write(frame, path, layer or vectorfile._gml_name(stem))


def read_both(path, layer=None):
    """The port's and the JAX package's read of one file, the same frame."""
    port = vectorfile.read_vector(path, layer)
    ref = jax_vectorfile.read_vector(path, layer)
    assert_same_read(port, ref)
    return port, ref


# --- round trips across the packages, and the files each writes ---


@pytest.mark.parametrize("ext", NEW_FORMATS)
def test_round_trip_across_packages(tmp_path, ext):
    columns, wkts, crs = CONTENT[ext]
    port, ref = frames(columns, wkts, crs)
    ours, theirs = paths(tmp_path, "data." + ext)
    vectorfile.write_vector(port, ours)
    jax_vectorfile.write_vector(ref, theirs)
    for path in (ours, theirs):
        back, _ = read_both(path)
    # DXF writes each ring of a polygon as an entity of its own
    assert len(back) == (7 if ext == "dxf" else len(wkts))
    if ext not in ("gpx", "dxf"):
        assert back.geometry.values[0].equals(geometry.from_wkt(wkts[0]))


@pytest.mark.parametrize("ext", NEW_FORMATS)
@pytest.mark.parametrize("index", [None, [4, 9, 2, 7, 11], ["a", "b", "c", "d", "e"]])
def test_writers_write_the_jax_files(tmp_path, ext, index):
    """Byte-identical text files, archive members and SQLite contents,
    whatever the index (a string index falls back to sequential fids)."""
    columns, wkts, crs = CONTENT[ext]
    port, ref = frames(columns, wkts, crs, index=None if index is None else index[:len(wkts)])
    ours, theirs = paths(tmp_path, "data." + ext)
    vectorfile.write_vector(port, ours, layer="pand")
    jax_vectorfile.write_vector(ref, theirs, layer="pand")
    same_file(ours, theirs)


@pytest.mark.parametrize("ext", ["gml", "sqlite", "mif", "kml", "topojson"])
@pytest.mark.parametrize("crs", ["EPSG:28992", "EPSG:4326", "EPSG:3857", None])
def test_crs_written_and_read_alike(tmp_path, ext, crs):
    port, ref = frames(COLUMNS, POLYGONS[:3], crs)
    ours, theirs = paths(tmp_path, "data." + ext)
    vectorfile.write_vector(port, ours)
    jax_vectorfile.write_vector(ref, theirs)
    same_file(ours, theirs)
    read_both(ours)


@pytest.mark.parametrize("ext", NEW_FORMATS)
def test_unicode_and_special_floats(tmp_path, ext):
    """tests/test_geometry_sources_sinks.py: unicode text and negative,
    zero and fractional floats survive every new writable format."""
    columns = {"label": ["café", "中文"], "x": [-1.5, 0.0]}
    wkts = ["POINT (0.5 0.5)", "LINESTRING (2 2, 3 3)"] if ext == "gpx" else \
        [geometry.box(0, 0, 1, 1).wkt, geometry.box(2, 2, 3, 3).wkt]
    if ext == "gpx":
        columns = {"name": columns["label"], "ele": columns["x"]}
    port, ref = frames(columns, wkts, "EPSG:4326")
    path = str(tmp_path / ("uni." + ext))
    vectorfile.write_vector(port, path)
    back, _ = read_both(path)
    if ext == "dxf":
        assert back["Layer"].tolist() == ["0", "0"]
    elif ext == "gpx":
        assert back["name"].tolist() == ["café", "中文"]
        assert repr(back["ele"].tolist()) == "[-1.5, nan]"  # a track has no <ele>
    else:
        assert back["label"].tolist() == ["café", "中文"]
        assert back["x"].tolist() == [-1.5, 0.0]


@pytest.mark.parametrize("ext", ["gml", "kml", "kmz", "topojson", "sqlite", "mif", "zip"])
def test_jax_roundtrip_case(tmp_path, ext):
    """tests/test_geometry_sources_sinks.py:TestVectorFileIO.test_roundtrip
    over the new formats, in both packages."""
    columns = {"name": ["a", "b", "c"], "value": [1.5, 2.5, 3.5], "n": [1, 2, 3]}
    wkts = [geometry.box(0, 0, 2, 2).wkt, geometry.box(4, 4, 6, 6).wkt,
            geometry.box(8, 8, 10, 10).wkt]
    port, ref = frames(columns, wkts, "EPSG:4326")
    ours, theirs = paths(tmp_path, "test." + ext)
    vectorfile.write_vector(port, ours)
    jax_vectorfile.write_vector(ref, theirs)
    same_file(ours, theirs)
    result, _ = read_both(ours)
    assert len(result) == 3
    assert result["value"].tolist() == [1.5, 2.5, 3.5]
    assert result["name"].tolist() == ["a", "b", "c"]
    assert result.geometry.values[0].equals(geometry.box(0, 0, 2, 2))


@pytest.mark.parametrize("stem", ["5e0f1a2", "my data", "-x", "pand", "_a.b-c"])
def test_gml_layer_names_are_xml_names(tmp_path, stem):
    """A sink's partial is named after its request token; the JAX writer
    makes a stem that starts with a digit (or holds a space) the element
    name, which no XML parser reads.  The port writes an XML name and
    otherwise the JAX writer's bytes."""
    port, ref = frames(COLUMNS, MIXED, "EPSG:28992")
    ours, theirs = paths(tmp_path, stem + ".gml")
    vectorfile.write_vector(port, ours)
    jax_vectorfile.write_vector(ref, theirs)
    name = vectorfile._gml_name(stem)
    valid = name == stem
    if valid:
        same_file(ours, theirs)
    else:
        with pytest.raises(Exception):
            jax_vectorfile.read_vector(theirs)
        repaired_gml_writer(ref, theirs)
        same_file(ours, theirs)
    back, _ = read_both(ours)
    assert back.index.values.tolist() == ["%s.%d" % (name, i) for i in range(len(MIXED))]


def test_osm_write_raises_naming_the_format(tmp_path):
    """The JAX package writes a GeoPackage under an .osm name (its
    write_vector has no osm branch); the port refuses."""
    port, _ = frames(COLUMNS, POLYGONS[:3], "EPSG:4326")
    with pytest.raises(NotImplementedError, match="OSM XML is read only"):
        vectorfile.write_vector(port, str(tmp_path / "x.osm"))
    assert not (tmp_path / "x.osm").exists()


def test_supported_extensions_match_the_jax_package_but_two():
    assert vectorfile.supported_extensions == (
        jax_vectorfile.supported_extensions - {"parquet", "geoparquet"})


# --- column typing: GML's astype and KML's to_numeric, against pandas ---

#: text cells that part pandas' astype from its to_numeric
TOKENS = ["12", " 12 ", "1e3", "nan", "NaN", "inf", "-Infinity", " inf", "1_000", "+5", "-0",
          "0x10", "1.0", "5.", ".5", "٣", "", "  ", "True", "00012", "1.5e400", "-1e-700",
          "9223372036854775807", "9223372036854775808", "-9223372036854775809",
          "18446744073709551615", "18446744073709551616", "123456789.123456789123",
          "0.30000000000000004", "99999999999999999999e-5", "1e", "abc", "12\\n"]
#: (JAX-package ids of) a column's cells: a token, a float's repr, an int
CELLS = st.one_of(
    st.sampled_from(TOKENS),
    st.floats(allow_nan=True, allow_infinity=True).map(repr),
    st.floats(-1e6, 1e6).map(lambda f: "%.17g" % f),
    st.integers(-(2**70), 2**70).map(str),
    st.none(),
)
TYPING = settings(max_examples=300, deadline=None,
                  suppress_health_check=[HealthCheck.too_slow])


def _outcome(call):
    try:
        values = call()
    except Exception as error:  # pandas and the port must fail alike
        return type(error)
    return values


def _pandas_column(cells):
    """The column pandas' from_records builds of the cells: a None cell's
    key is absent (NaN), unless every cell is None (an object column)."""
    if all(c is None for c in cells):
        return pd.DataFrame.from_records([{"a": None} for _ in cells])["a"]
    return pd.DataFrame.from_records([{} if c is None else {"a": c} for c in cells])["a"]


def _same_column(port, ref):
    if isinstance(ref, type):
        assert port is ref
        return
    if port is None:  # the port keeps the text: pandas raised and the JAX reader kept it
        raise AssertionError("the port kept a column pandas typed as %s" % ref.dtype)
    assert repr(port.tolist()) == repr(ref.tolist())
    assert port.dtype == ref.dtype


@TYPING
@given(st.lists(CELLS, min_size=1, max_size=6))
def test_to_numeric_like_pandas(cells):
    """vectorfile._to_numeric (KML and CSV) against pd.to_numeric of the
    column pandas builds of the same records."""
    column = _pandas_column(cells)
    expected = _outcome(lambda: pd.to_numeric(column))
    actual = vectorfile._to_numeric(column.tolist())
    if expected is ValueError or (not isinstance(expected, type)
                                  and expected.dtype == column.dtype):
        assert actual is None  # the column stays text
        return
    _same_column(actual, expected)


@TYPING
@given(st.lists(CELLS, min_size=1, max_size=6))
def test_astype_like_pandas(cells):
    """vectorfile._astype_number (GML) against pandas' astype(int64),
    then astype(float64), of the same column."""
    column = _pandas_column(cells)

    def cast():
        for caster in (np.int64, np.float64):
            try:
                return column.astype(caster)
            except (ValueError, TypeError):
                continue
        return None

    expected = _outcome(cast)
    actual = _outcome(lambda: vectorfile._astype_number(column.tolist()))
    if expected is None:
        assert actual is None
        return
    _same_column(actual, expected)


def _gml_of(rows):
    """A hand-written GML file: one feature per row, the row's cells as
    properties (None: the property is absent)."""
    from xml.sax.saxutils import escape

    features = []
    for i, row in enumerate(rows):
        props = "".join("<ogr:%s>%s</ogr:%s>" % (k, escape(v), k)
                        for k, v in row.items() if v is not None)
        features.append(
            '<gml:featureMember><ogr:t fid="t.%d"><ogr:geometryProperty><gml:Point '
            'srsName="EPSG:28992"><gml:coordinates>%d,1</gml:coordinates></gml:Point>'
            "</ogr:geometryProperty>%s</ogr:t></gml:featureMember>" % (i, i, props))
    return ('<?xml version="1.0"?><ogr:FeatureCollection xmlns:ogr="http://ogr.maptools.org/" '
            'xmlns:gml="http://www.opengis.net/gml">%s</ogr:FeatureCollection>'
            % "".join(features))


def _kml_of(rows):
    from xml.sax.saxutils import escape

    marks = []
    for i, row in enumerate(rows):
        data = "".join('<Data name="%s"><value>%s</value></Data>' % (k, escape(v))
                       for k, v in row.items() if v is not None)
        marks.append("<Placemark><ExtendedData>%s</ExtendedData><Point><coordinates>%d,1"
                     "</coordinates></Point></Placemark>" % (data, i))
    return ('<?xml version="1.0"?><kml xmlns="http://www.opengis.net/kml/2.2"><Document>%s'
            "</Document></kml>" % "".join(marks))


@TYPING
@given(st.lists(st.fixed_dictionaries({"a": CELLS, "b": CELLS}), min_size=1, max_size=5),
       st.sampled_from(["gml", "kml"]))
def test_typed_reads_like_the_jax_readers(tmp_path_factory, rows, ext):
    """Whole files of drawn text cells: the port's GML and KML readers
    give the JAX readers' frames, or raise as they raise."""
    rows = [{k: (None if v is None else v.replace("\\n", "\n")) for k, v in row.items()}
            for row in rows]
    path = tmp_path_factory.mktemp("typed") / ("cells." + ext)
    path.write_text((_gml_of if ext == "gml" else _kml_of)(rows))
    expected = _outcome(lambda: jax_vectorfile.read_vector(str(path)))
    actual = _outcome(lambda: vectorfile.read_vector(str(path)))
    if isinstance(expected, type):
        assert actual is expected
        return
    assert_same_read(actual, expected)


@pytest.mark.parametrize("cells", [
    ["nan", "1"], [" 12 ", "3"], ["1e3", "2"], ["1", None], [None, None], ["1", ""],
    ["9223372036854775808"], ["9223372036854775808", None], ["-1", "9223372036854775808"],
    ["18446744073709551616", "-1"], ["0.30000000000000004"], ["abc", "99999999999999999999"],
    ["99999999999999999999", "abc"],
])
@pytest.mark.parametrize("ext", ["gml", "kml"])
def test_typing_examples(tmp_path, cells, ext):
    """The cases that part astype from to_numeric: "nan", " 12 ", "1e3",
    a missing cell in an integer column, integers beyond int64 (GML's
    astype raises OverflowError where no earlier cell failed)."""
    path = tmp_path / ("cells." + ext)
    path.write_text((_gml_of if ext == "gml" else _kml_of)([{"a": c} for c in cells]))
    expected = _outcome(lambda: jax_vectorfile.read_vector(str(path)))
    actual = _outcome(lambda: vectorfile.read_vector(str(path)))
    if isinstance(expected, type):
        assert actual is expected
    else:
        assert_same_read(actual, expected)


# --- the cases of the JAX tests, each run once in each package ---


def _kit(port):
    """What a case needs of one package: its frame built from columns,
    its geometry constructors, its codecs and blocks, and a runner that
    sets its ``geomodeling.root``."""
    if port:
        def frame(columns, geometry_list, crs=None):
            return GeoDataFrame(dict(columns) if columns else None, geometry=geometry_list,
                                crs=crs)
        return types.SimpleNamespace(
            port=True, frame=frame, g=geometry, vf=vectorfile, mif=mapinfo, dxf=dxf, osm=osm,
            spatialite=spatialite, blocks=port_blocks, config=config,
            get_data=lambda block, **request: block.get_data(device="cpu", **request),
            index=lambda values: Index(np.asarray(values)))

    def frame(columns, geometry_list, crs=None):
        return JaxGeoDataFrame(pd.DataFrame(columns) if columns else None,
                               geometry=geometry_list, crs=crs)
    return types.SimpleNamespace(
        port=False, frame=frame, g=jax_geometry, vf=jax_vectorfile, mif=jax_mapinfo,
        dxf=jax_dxf, osm=jax_osm, spatialite=jax_spatialite, blocks=jax_blocks,
        config=jax_config, get_data=lambda block, **request: block.get_data(**request),
        index=pd.Index)


def run_both(tmp_path, case):
    """Run ``case(kit, root)`` for the JAX package in ``tmp_path/jax`` and
    for the port in ``tmp_path/port`` (each its ``geomodeling.root``);
    every file the JAX run left holds what the port's does, and the
    frames each returns are the same.  Returns the port's result."""
    results = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        root.mkdir()
        kit = _kit(side == "port")
        pipeline.clear_read_cache()
        jax_pipeline.clear_read_cache()
        with kit.config.set({"geomodeling.root": str(root)}):
            results[side] = case(kit, root)
    for name in sorted(os.listdir(tmp_path / "jax")):
        if name.lower().endswith((".mif", ".dxf", ".gml", ".kml", ".kmz", ".gpx", ".zip",
                                  ".topojson", ".sqlite", ".geojson")):
            same_file(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))
    port, ref = results["port"], results["jax"]
    if isinstance(ref, type):  # both raised: the same error class
        assert isinstance(port, type) and port.__name__ == ref.__name__
    for ours, theirs in zip(port if isinstance(port, tuple) else (port,),
                            ref if isinstance(ref, tuple) else (ref,)):
        if hasattr(theirs, "geometry"):
            assert_same_read(ours, theirs)
    return port


def _mif_frame(kit):
    """tests/test_mapinfo_dxf.py's frame fixture."""
    g = kit.g
    return kit.frame({"name": ["a", "b", "c"], "value": [1.5, 2.5, 3.5], "n": [1, 2, 3]},
                     [g.box(0, 0, 2, 2), g.Point(5, 5), g.box(8, 8, 10, 10)], crs="EPSG:4326")


def _mif_roundtrip(kit, root):
    path = str(root / "test.mif")
    kit.mif.write_mif(_mif_frame(kit), path)
    result = kit.mif.read_mif(path)
    assert result["name"].tolist() == ["a", "b", "c"]
    assert result["value"].tolist() == [1.5, 2.5, 3.5]
    assert result["n"].tolist() == [1, 2, 3]
    assert result.geometry.iloc[0].equals(kit.g.box(0, 0, 2, 2))
    assert result.geometry.iloc[1].equals(kit.g.Point(5, 5))
    assert result.crs == "EPSG:4326"
    return result


def _mif_dispatch(kit, root):
    path = str(root / "disp.mif")
    kit.vf.write_vector(_mif_frame(kit), path)
    result = kit.vf.read_vector(path)
    assert len(result) == 3
    return result


def _mif_lines(kit, root):
    g = kit.g
    frame = kit.frame({"id": [1, 2, 3]}, [
        g.LineString([(0, 0), (1, 1), (2, 0)]),
        g.MultiLineString([g.LineString([(0, 0), (1, 0)]), g.LineString([(0, 1), (1, 1)])]),
        g.MultiPoint([g.Point(3, 3), g.Point(4, 4)]),
    ], crs="EPSG:4326")
    path = str(root / "lines.mif")
    kit.mif.write_mif(frame, path)
    result = kit.mif.read_mif(path)
    assert [result.geometry.iloc[i].geom_type for i in range(3)] == [
        "LineString", "MultiLineString", "MultiPoint"]
    assert list(result.geometry.iloc[0].coords) == [(0.0, 0.0), (1.0, 1.0), (2.0, 0.0)]
    return result


def _donut(g):
    return g.Polygon([(0, 0), (10, 0), (10, 10), (0, 10), (0, 0)],
                     [[(4, 4), (6, 4), (6, 6), (4, 6), (4, 4)]])


def _mif_hole(kit, root):
    poly = _donut(kit.g)
    path = str(root / "hole.mif")
    kit.mif.write_mif(kit.frame({"id": [1]}, [poly], crs="EPSG:4326"), path)
    result = kit.mif.read_mif(path)
    got = result.geometry.iloc[0]
    assert got.geom_type == "Polygon" and len(got.interiors) == 1
    assert abs(got.area - poly.area) < 1e-9
    return result


def _mif_region_grouping(kit, root):
    g = kit.g
    multi = g.MultiPolygon([_donut(g), g.box(20, 20, 22, 22)])
    path = str(root / "multi.mif")
    kit.mif.write_mif(kit.frame({"id": [1]}, [multi], crs="EPSG:4326"), path)
    result = kit.mif.read_mif(path)
    got = result.geometry.iloc[0]
    assert got.geom_type == "MultiPolygon"
    assert abs(got.area - multi.area) < 1e-9
    parts = sorted(got.geoms, key=lambda p: p.area)
    assert abs(parts[0].area - 4.0) < 1e-9
    assert len(parts[1].interiors) == 1
    return result


def _mif_foreign_styling(kit, root):
    (root / "styled.mif").write_text(
        'Version 300\nCharset "Neutral"\nDelimiter ","\nCoordSys Earth Projection 1, 104\n'
        "Columns 1\n  id Integer\nData\n\nRect 1 2 5 8\n    Pen (1,2,0)\n"
        "    Brush (2,16777215,16777215)\nPoint 3 4\n    Symbol (34,0,12)\n")
    (root / "styled.mid").write_text("7\n9\n")
    result = kit.mif.read_mif(str(root / "styled.mif"))
    assert len(result) == 2 and result["id"].tolist() == [7, 9]
    assert result.geometry.iloc[0].equals(kit.g.box(1, 2, 5, 8))
    return result


def _mif_quoted(kit, root):
    g = kit.g
    frame = kit.frame({"name": ['a, "b"', "plain"], "n": [7, 9]}, [g.Point(1, 1), g.Point(2, 2)],
                      crs="EPSG:4326")
    path = str(root / "quoted.mif")
    kit.mif.write_mif(frame, path)
    result = kit.mif.read_mif(path)
    assert result["name"].tolist() == ['a, "b"', "plain"]
    assert result["n"].tolist() == [7, 9]
    return result


def _mif_sink_merge(kit, root):
    kit.vf.write_vector(_mif_frame(kit), str(root / "src.geojson"))
    sink = kit.blocks.GeometryFileSink(kit.blocks.GeometryFileSource("src.geojson"), "partials",
                                       extension="mif")
    kit.get_data(sink, mode="intersects", geometry=kit.g.box(-1, -1, 11, 11),
                 projection="EPSG:4326", start=datetime(2000, 1, 1))
    kit.blocks.GeometryFileSink.merge_files("partials", "merged.mif", remove_source=True)
    merged = kit.vf.read_vector(str(root / "merged.mif"))
    assert merged["name"].tolist() == ["a", "b", "c"]
    assert not os.path.exists(str(root / "partials"))
    return merged


def _mif_nonearth(kit, root):
    frame = _mif_frame(kit)
    frame.crs = "EPSG:28992"
    path = str(root / "ne.mif")
    kit.mif.write_mif(frame, path)
    result = kit.mif.read_mif(path)
    assert result.geometry.iloc[1].equals(kit.g.Point(5, 5))
    assert result.crs == 'CoordSys NonEarth Units "m"'
    return result


def _dxf_roundtrip(kit, root):
    path = str(root / "test.dxf")
    kit.dxf.write_dxf(_mif_frame(kit), path)
    result = kit.dxf.read_dxf(path)
    assert len(result) == 3
    assert result.geometry.iloc[0].geom_type == "Polygon"
    assert result.geometry.iloc[1].equals(kit.g.Point(5, 5))
    assert abs(result.geometry.iloc[0].area - 4.0) < 1e-9
    assert result["Layer"].tolist() == ["0", "0", "0"]
    return result


def _dxf_layers(kit, root):
    g = kit.g
    frame = kit.frame({"Layer": ["roads", "water"]},
                      [g.LineString([(0, 0), (5, 5)]), g.box(1, 1, 2, 2)])
    path = str(root / "layers.dxf")
    kit.dxf.write_dxf(frame, path)
    result = kit.dxf.read_dxf(path)
    assert result["Layer"].tolist() == ["roads", "water"]
    return result


def _dxf_dispatch(kit, root):
    path = str(root / "disp.dxf")
    kit.vf.write_vector(_mif_frame(kit), path)
    result = kit.vf.read_vector(path)
    assert len(result) == 3
    return result


def _dxf_foreign(kit, root):
    (root / "cad.dxf").write_text("\n".join([
        "0", "SECTION", "2", "ENTITIES", "0", "LINE", "8", "walls",
        "10", "0", "20", "0", "11", "3", "21", "4",
        "0", "POLYLINE", "8", "area", "70", "1",
        "0", "VERTEX", "10", "0", "20", "0", "0", "VERTEX", "10", "4", "20", "0",
        "0", "VERTEX", "10", "4", "20", "4", "0", "SEQEND",
        "0", "CIRCLE", "8", "round", "10", "10", "20", "10", "40", "2",
        "0", "ENDSEC", "0", "EOF"]))
    result = kit.dxf.read_dxf(str(root / "cad.dxf"))
    assert [g.geom_type for g in result.geometry] == ["LineString", "Polygon", "Polygon"]
    assert abs(result.geometry.iloc[1].area - 8.0) < 1e-9
    assert abs(result.geometry.iloc[2].area - np.pi * 4) < 0.1
    assert result["Layer"].tolist() == ["walls", "area", "round"]
    return result


MIF_DXF_CASES = {
    "mif roundtrip": _mif_roundtrip,
    "mif via vectorfile dispatch": _mif_dispatch,
    "mif line and multi geometries": _mif_lines,
    "mif polygon with hole": _mif_hole,
    "mif multipolygon region grouping": _mif_region_grouping,
    "mif foreign with styling": _mif_foreign_styling,
    "mif delimiter inside quoted string": _mif_quoted,
    "mif sink merge single partial keeps mid": _mif_sink_merge,
    "mif nonearth crs preserved": _mif_nonearth,
    "dxf roundtrip": _dxf_roundtrip,
    "dxf layer column travels": _dxf_layers,
    "dxf via vectorfile dispatch": _dxf_dispatch,
    "dxf foreign entities": _dxf_foreign,
}


@pytest.mark.parametrize("case", sorted(MIF_DXF_CASES))
def test_mapinfo_dxf_case(tmp_path, case):
    """Every case of tests/test_mapinfo_dxf.py."""
    run_both(tmp_path, MIF_DXF_CASES[case])


def test_mif_in_rd_through_a_file_source(tmp_path):
    """A MIF written in EPSG:28992 carries ``CoordSys NonEarth``, which no
    CRS parser reads: a GeometryFileSource request in EPSG:28992 fails in
    both packages, with the same error type."""
    def case(kit, root):
        frame = _mif_frame(kit)
        frame.crs = "EPSG:28992"
        kit.mif.write_mif(frame, str(root / "rd.mif"))
        source = kit.blocks.GeometryFileSource("rd.mif")
        return _outcome(lambda: kit.get_data(source, mode="intersects",
                                             geometry=kit.g.box(-1, -1, 11, 11),
                                             projection="EPSG:28992"))

    outcome = run_both(tmp_path, case)
    assert isinstance(outcome, type) and issubclass(outcome, Exception)


def _osm_text():
    from tests.test_osm import OSM as text

    return text


def _osm_points(kit, root):
    points = kit.osm.read_osm(str(root / "extract.osm"), layer="points")
    assert points["osm_id"].tolist() == ["1"] and points["amenity"].tolist() == ["pub"]
    assert points.geometry.iloc[0].coords[0] == (4.00, 52.00)
    return points


def _osm_lines(kit, root):
    lines = kit.osm.read_osm(str(root / "extract.osm"), layer="lines")
    assert lines["osm_id"].tolist() == ["100"]
    assert list(lines.geometry.iloc[0].coords) == [(4.00, 52.01), (4.02, 52.02), (4.03, 52.03)]
    return lines


def _osm_multipolygons(kit, root):
    polys = kit.osm.read_osm(str(root / "extract.osm"), layer="multipolygons")
    assert sorted(polys["osm_id"].tolist()) == ["101", "200"]
    relation = polys.geometry.values[polys["osm_id"].tolist().index("200")]
    assert type(relation).__name__ == "Polygon"
    np.testing.assert_allclose(relation.area, 0.1 * 0.1 - 0.02 * 0.02, atol=1e-12)
    return polys


def _osm_default(kit, root):
    everything = kit.vf.read_vector(str(root / "extract.osm"))
    assert sorted(set(everything["layer"].tolist())) == ["lines", "multipolygons", "points"]
    assert len(everything) == 4 and everything.crs == "EPSG:4326"
    return everything


def _osm_unknown_layer(kit, root):
    with pytest.raises(ValueError, match="Unknown OSM layer"):
        kit.osm.read_osm(str(root / "extract.osm"), layer="bogus")


def _osm_not_osm(kit, root):
    (root / "x.osm").write_text("<gpx></gpx>")
    with pytest.raises(ValueError, match="not an OSM"):
        kit.osm.read_osm(str(root / "x.osm"))


def _osm_file_source(kit, root):
    source = kit.blocks.GeometryFileSource("extract.osm", id_field=None)
    result = kit.get_data(source, mode="intersects", geometry=kit.g.box(3.9, 51.9, 4.05, 52.05),
                          projection="EPSG:4326", limit=None, min_size=None, start=None,
                          stop=None, filters={})
    assert sorted(result["features"]["osm_id"].tolist()) == ["1", "100", "101"]
    return result["features"]


OSM_CASES = {
    "points": _osm_points, "lines": _osm_lines, "multipolygons": _osm_multipolygons,
    "default concatenates with layer column": _osm_default,
    "unknown layer raises": _osm_unknown_layer, "not osm": _osm_not_osm,
    "geometry file source": _osm_file_source,
}


@pytest.mark.parametrize("case", sorted(OSM_CASES))
def test_osm_case(tmp_path, case):
    """Every case of tests/test_osm.py."""
    def run(kit, root):
        (root / "extract.osm").write_text(_osm_text())
        return OSM_CASES[case](kit, root)

    run_both(tmp_path, run)


@pytest.mark.parametrize("layer", [None, "points", "lines", "multipolygons"])
def test_osm_layer_tag_goes_with_the_layer_column(tmp_path, layer):
    """A ``layer`` tag (bridges carry one) and the layer column share a
    name: one layer drops both, the default keeps the tag's value."""
    text = _osm_text().replace('<tag k="highway" v="residential"/>',
                               '<tag k="highway" v="residential"/><tag k="layer" v="1"/>')
    (tmp_path / "tagged.osm").write_text(text)
    read_both(str(tmp_path / "tagged.osm"), layer)


# --- the format cases of tests/test_geometry_sources_sinks.py ---

GPX = """<?xml version="1.0" encoding="UTF-8"?>
<gpx version="1.1" creator="test" xmlns="http://www.topografix.com/GPX/1/1">
  <wpt lat="52.1" lon="4.3"><ele>2.5</ele><name>home</name></wpt>
  <wpt lat="52.2" lon="4.4"><name>work</name></wpt>
  <rte><name>commute</name>
    <rtept lat="52.1" lon="4.3"/><rtept lat="52.2" lon="4.4"/>
  </rte>
  <trk><name>run</name>
    <trkseg><trkpt lat="52.0" lon="4.0"/><trkpt lat="52.05" lon="4.05"/></trkseg>
    <trkseg><trkpt lat="52.1" lon="4.1"/><trkpt lat="52.15" lon="4.15"/></trkseg>
  </trk>
</gpx>"""


def _boxes(kit):
    """tests/test_geometry_sources_sinks.py's frame fixture."""
    g = kit.g
    return kit.frame({"name": ["a", "b", "c"], "value": [1.5, 2.5, 3.5]},
                     [g.box(0, 0, 2, 2), g.box(4, 4, 6, 6), g.box(8, 8, 10, 10)],
                     crs="EPSG:4326")


def _gpx_layers(kit, root):
    path = str(root / "test.gpx")
    with open(path, "w") as f:
        f.write(GPX)
    everything = kit.vf.read_vector(path)
    assert everything["layer"].tolist() == ["waypoints", "waypoints", "routes", "tracks"]
    waypoints = kit.vf.read_vector(path, layer="waypoints")
    assert "layer" not in waypoints.columns
    assert waypoints["name"].tolist() == ["home", "work"]
    assert waypoints.geometry.iloc[0].coords[0] == (4.3, 52.1)
    routes = kit.vf.read_vector(path, layer="routes")
    tracks = kit.vf.read_vector(path, layer="tracks")
    assert type(tracks.geometry.iloc[0]).__name__ == "MultiLineString"
    with pytest.raises(ValueError):
        kit.vf.read_vector(path, layer="nope")
    g = kit.g
    mixed = kit.frame({"name": ["p", "l"]},
                      [g.Point(4.3, 52.1), g.LineString([(4.0, 52.0), (4.1, 52.1)])],
                      crs="EPSG:4326")
    kit.vf.write_vector(mixed, str(root / "out.gpx"))
    back = kit.vf.read_vector(str(root / "out.gpx"))
    assert set(back["layer"].tolist()) == {"waypoints", "tracks"}
    with pytest.raises(ValueError):
        kit.vf.write_vector(kit.frame(None, [g.box(0, 0, 1, 1)], crs="EPSG:4326"),
                            str(root / "bad.gpx"))
    return everything, waypoints, routes, tracks, back


def _spatialite_review_fixes(kit, root):
    g = kit.g
    dup = kit.frame({"tags": [["a", "b"], ["c"]]}, [g.box(0, 0, 1, 1), g.box(2, 2, 3, 3)],
                    crs="EPSG:4326")
    dup.index = kit.index([1, 1])
    kit.vf.write_vector(dup, str(root / "dup.sqlite"))
    back = kit.vf.read_vector(str(root / "dup.sqlite"))
    assert back["tags"].tolist() == ['["a", "b"]', '["c"]']
    with pytest.raises(IOError):
        kit.spatialite.parse_blob(b"\x00\x01\x02")
    compressed = bytearray(b"\x00\x01") + struct.pack("<i", 4326) + struct.pack(
        "<4d", 0, 0, 1, 1) + b"\x7c" + struct.pack("<i", 1000002) + b"\x00" * 16 + b"\xfe"
    with pytest.raises(NotImplementedError):
        kit.spatialite.parse_blob(bytes(compressed))
    con = sqlite3.connect(str(root / "pk.sqlite"))
    con.execute("CREATE TABLE geometry_columns (f_table_name TEXT, f_geometry_column TEXT, "
                "geometry_type INTEGER, coord_dimension INTEGER, srid INTEGER, "
                "spatial_index_enabled INTEGER)")
    con.execute("INSERT INTO geometry_columns VALUES ('t','geom',1,2,4326,0)")
    con.execute("CREATE TABLE t (fid INTEGER, PK_UID INTEGER, geom BLOB)")
    con.execute("INSERT INTO t VALUES (5, 77, ?)", (_point_blob(3.0, 4.0, 1),))
    con.commit()
    con.close()
    result = kit.vf.read_vector(str(root / "pk.sqlite"))
    assert result.index.tolist() == [5] and result["PK_UID"].tolist() == [77]
    return back, result


def _point_blob(x, y, code, z=None):
    blob = bytearray(b"\x00\x01") + struct.pack("<i", 4326) + struct.pack("<4d", x, y, x, y)
    blob += b"\x7c" + struct.pack("<i", code) + struct.pack("<2d", x, y)
    if z is not None:
        blob += struct.pack("<d", z)
    return bytes(blob + b"\xfe")


def _topojson_empty_arc(kit, root):
    topology = {"type": "Topology", "arcs": [[]], "objects": {"pts": {
        "type": "GeometryCollection", "geometries": [
            {"type": "Point", "coordinates": [1.0, 2.0]},
            {"type": "Point", "coordinates": [3.0, 4.0]}]}}}
    (root / "noids.topojson").write_text(json.dumps(topology))
    result = kit.vf.read_vector(str(root / "noids.topojson"))
    assert result.index.name is None and result.index.tolist() == [0, 1]
    return result


def _spatialite_z_and_legacy(kit, root):
    blob = _point_blob(3.0, 4.0, 1001, z=99.0)
    point = kit.spatialite.parse_blob(blob)
    assert (point.x, point.y) == (3.0, 4.0)
    con = sqlite3.connect(str(root / "legacy.sqlite"))
    con.execute("CREATE TABLE geometry_columns (f_table_name TEXT, f_geometry_column TEXT, "
                "type TEXT, coord_dimension INTEGER, srid INTEGER, "
                "spatial_index_enabled INTEGER)")
    con.execute("INSERT INTO geometry_columns VALUES ('pts', 'geom', 'POINT', 2, 4326, 0)")
    con.execute("CREATE TABLE pts (PK_UID INTEGER, v REAL, geom BLOB)")
    con.execute("INSERT INTO pts VALUES (7, 1.25, ?)", (blob,))
    con.commit()
    con.close()
    result = kit.vf.read_vector(str(root / "legacy.sqlite"))
    assert result["v"].tolist() == [1.25] and result.index.tolist() == [7]
    assert result.crs == "EPSG:4326" and result.geometry.iloc[0].x == 3.0
    return result


def _topojson_quantized(kit, root):
    topology = {
        "type": "Topology",
        "transform": {"scale": [0.01, 0.01], "translate": [0.0, 0.0]},
        "arcs": [[[100, 0], [0, 100]], [[100, 100], [-100, 0], [0, -100], [100, 0]],
                 [[100, 0], [100, 0], [0, 100], [-100, 0]]],
        "objects": {"squares": {"type": "GeometryCollection", "geometries": [
            {"type": "Polygon", "arcs": [[0, 1]], "properties": {"name": "left"}},
            {"type": "Polygon", "arcs": [[2, ~0]], "properties": {"name": "right"}}]}},
    }
    (root / "squares.topojson").write_text(json.dumps(topology))
    path = str(root / "squares.topojson")
    result = kit.vf.read_vector(path)
    assert result["name"].tolist() == ["left", "right"]
    assert result.geometry.iloc[0].equals(kit.g.box(0, 0, 1, 1))
    assert result.geometry.iloc[1].equals(kit.g.box(1, 0, 2, 1))
    assert len(kit.vf.read_vector(path, layer="squares")) == 2
    with pytest.raises(IOError):
        kit.vf.read_vector(path, layer="nope")
    return result


def _kmz_prefers_doc_kml(kit, root):
    frame = _boxes(kit)
    with zipfile.ZipFile(str(root / "bundle.kmz"), "w") as bundle:
        bundle.writestr("aaa_overlay.kml", kit.vf._kml_document(frame.iloc[:1]))
        bundle.writestr("doc.kml", kit.vf._kml_document(frame))
    result = kit.vf.read_vector(str(root / "bundle.kmz"))
    assert len(result) == 3
    return result


def _zip_layer_selection(kit, root):
    frame = _boxes(kit)
    kit.vf.write_vector(frame, str(root / "data.shp.zip"))
    with zipfile.ZipFile(str(root / "data.shp.zip")) as bundle:
        names = set(bundle.namelist())
    assert "data.shp" in names and "data.dbf" in names
    result = kit.vf.read_vector(str(root / "data.shp.zip"))
    assert result["value"].tolist() == [1.5, 2.5, 3.5]
    kit.vf.write_vector(frame, str(root / "a.geojson"))
    kit.vf.write_vector(frame.iloc[:1], str(root / "b.geojson"))
    with zipfile.ZipFile(str(root / "multi.zip"), "w") as bundle:
        bundle.write(str(root / "a.geojson"), "a.geojson")
        bundle.write(str(root / "b.geojson"), "b.geojson")
    b = kit.vf.read_vector(str(root / "multi.zip"), layer="b")
    a = kit.vf.read_vector(str(root / "multi.zip"), layer="a")
    assert (len(b), len(a)) == (1, 3)
    with pytest.raises(IOError):
        kit.vf.read_vector(str(root / "multi.zip"), layer="missing")
    return result, b, a


def _zip_macos_sidecars(kit, root):
    kit.vf.write_vector(_boxes(kit), str(root / "plain.zip"))
    with zipfile.ZipFile(str(root / "plain.zip")) as src, \
            zipfile.ZipFile(str(root / "macos.zip"), "w") as dst:
        for name in src.namelist():
            dst.writestr(name, src.read(name))
            dst.writestr("__MACOSX/._" + name, b"\x00\x05\x16\x07junk")
    result = kit.vf.read_vector(str(root / "macos.zip"))
    assert result["value"].tolist() == [1.5, 2.5, 3.5]
    return result


def _zip_forwards_layer(kit, root):
    kit.vf.write_vector(_boxes(kit), str(root / "layers.gpkg"), layer="boxes")
    with zipfile.ZipFile(str(root / "layers.zip"), "w") as bundle:
        bundle.write(str(root / "layers.gpkg"), "layers.gpkg")
    result = kit.vf.read_vector(str(root / "layers.zip"), layer="boxes")
    assert len(result) == 3
    with pytest.raises(IOError):
        kit.vf.read_vector(str(root / "layers.zip"), layer="nope")
    return result


def _zip_member_paths_stay_inside(kit, root):
    """Members named with ``..`` and absolute paths extract inside the
    temporary folder: the read never reaches a file beside the archive."""
    kit.vf.write_vector(_boxes(kit), str(root / "outside.geojson"))
    with zipfile.ZipFile(str(root / "evil.zip"), "w") as bundle:
        bundle.writestr("../outside.geojson", b"{}")
        bundle.writestr("/abs/inside.geojson", open(str(root / "outside.geojson"), "rb").read())
    result = kit.vf.read_vector(str(root / "evil.zip"), layer="inside")
    assert len(result) == 3
    assert len(kit.vf.read_vector(str(root / "outside.geojson"))) == 3
    return result


def _gpx_file_source(kit, root):
    (root / "pts.gpx").write_text(
        '<?xml version="1.0"?>\n<gpx version="1.1" creator="t" '
        'xmlns="http://www.topografix.com/GPX/1/1">\n  <wpt lat="1.0" lon="1.0"><name>in</name>'
        '</wpt>\n  <wpt lat="50.0" lon="50.0"><name>out</name></wpt>\n</gpx>')
    result = kit.get_data(kit.blocks.GeometryFileSource("pts.gpx"), mode="intersects",
                          geometry=kit.g.box(0, 0, 10, 10), projection="EPSG:4326",
                          start=datetime(2000, 1, 1))
    assert result["features"]["name"].tolist() == ["in"]
    return result["features"]


def _gml_crs_and_holes(kit, root):
    g = kit.g
    donut = g.Polygon([(0, 0), (10, 0), (10, 10), (0, 10)], [[(4, 4), (6, 4), (6, 6), (4, 6)]])
    kit.vf.write_vector(kit.frame({"value": [7]}, [donut], crs="EPSG:28992"),
                        str(root / "test.gml"))
    result = kit.vf.read_vector(str(root / "test.gml"))
    assert result.crs == "EPSG:28992" and result["value"].tolist() == [7]
    assert result.geometry.iloc[0].equals(donut)
    return result


def _gpx_empty_ele(kit, root):
    (root / "ele.gpx").write_text(
        '<?xml version="1.0"?>\n<gpx version="1.1" creator="t" '
        'xmlns="http://www.topografix.com/GPX/1/1">\n  <wpt lat="1.0" lon="2.0"><ele/>'
        '<name>a</name></wpt>\n  <wpt lat="1.5" lon="2.5"><ele>  </ele></wpt>\n</gpx>')
    frame = kit.vf.read_vector(str(root / "ele.gpx"))
    assert len(frame) == 2 and "ele" not in frame.columns
    return frame


def _gpx_no_ele_in_trk(kit, root):
    frame = kit.frame({"ele": [12.5], "name": ["l"]},
                      [kit.g.LineString([(0.0, 0.0), (1.0, 1.0)])], crs="EPSG:4326")
    kit.vf.write_vector(frame, str(root / "line.gpx"))
    text = (root / "line.gpx").read_text()
    assert "<ele>" not in text and "<name>l</name>" in text


def _gml_urn_srsname(kit, root):
    (root / "urn.gml").write_text(
        '<?xml version="1.0"?>\n<gml:FeatureCollection xmlns:gml="http://www.opengis.net/gml">'
        "\n  <gml:featureMember>\n    <feature>\n      <name>a</name>\n      <geom>"
        '<gml:Point srsName="urn:ogc:def:crs:EPSG::28992">\n        <gml:coordinates>'
        "155000,463000</gml:coordinates>\n      </gml:Point></geom>\n    </feature>\n"
        "  </gml:featureMember>\n</gml:FeatureCollection>\n")
    frame = kit.vf.read_vector(str(root / "urn.gml"))
    assert frame.crs == "EPSG:28992"
    return frame


def _gml_other_srsnames(kit, root):
    """A GML3 file (gml:id, posList with srsDimension 3, Surface and
    MultiSurface) with an opengis URL srsName, and one no parser reads
    (kept as it is)."""
    frames_read = []
    for srs in ("http://www.opengis.net/def/crs/EPSG/0/28992", "EPSG:4258",
                "urn:example:nonsense"):
        (root / "g3.gml").write_text(
            '<?xml version="1.0"?><wfs:FeatureCollection xmlns:wfs="http://www.opengis.net/wfs"'
            ' xmlns:gml="http://www.opengis.net/gml/3.2" xmlns:bag="http://bag">'
            '<wfs:member><bag:pand gml:id="pand.1"><bag:geom><gml:Surface srsName="%s">'
            "<gml:patches><gml:PolygonPatch><gml:exterior><gml:LinearRing><gml:posList "
            'srsDimension="3">0 0 1 4 0 1 4 4 1 0 0 1</gml:posList></gml:LinearRing>'
            "</gml:exterior></gml:PolygonPatch></gml:patches></gml:Surface></bag:geom>"
            "<bag:bouwjaar>1931</bag:bouwjaar><bag:status>Pand in gebruik</bag:status>"
            '</bag:pand></wfs:member><wfs:member><bag:pand gml:id="pand.2"><bag:geom>'
            "<gml:MultiSurface><gml:surfaceMember><gml:Polygon><gml:exterior><gml:LinearRing>"
            "<gml:posList>5 5 6 5 6 6 5 5</gml:posList></gml:LinearRing></gml:exterior>"
            "</gml:Polygon></gml:surfaceMember></gml:MultiSurface></bag:geom>"
            "<bag:bouwjaar></bag:bouwjaar></bag:pand></wfs:member></wfs:FeatureCollection>"
            % srs)
        frames_read.append(kit.vf.read_vector(str(root / "g3.gml")))
    return tuple(frames_read)


SOURCE_SINK_CASES = {
    "gpx read layers and roundtrip": _gpx_layers,
    "spatialite review fixes": _spatialite_review_fixes,
    "topojson empty arc and unnamed index": _topojson_empty_arc,
    "spatialite z and legacy schema": _spatialite_z_and_legacy,
    "topojson quantized shared arcs": _topojson_quantized,
    "kmz prefers doc kml": _kmz_prefers_doc_kml,
    "zip layer selection and shp zip": _zip_layer_selection,
    "zip skips macos sidecars": _zip_macos_sidecars,
    "zip forwards layer to inner dataset": _zip_forwards_layer,
    "zip member paths stay inside": _zip_member_paths_stay_inside,
    "gpx geometry file source": _gpx_file_source,
    "gml crs and holes": _gml_crs_and_holes,
    "gpx empty ele tolerated": _gpx_empty_ele,
    "gpx no ele inside trk": _gpx_no_ele_in_trk,
    "gml urn srsname": _gml_urn_srsname,
    "gml3 and other srsnames": _gml_other_srsnames,
}


@pytest.mark.parametrize("case", sorted(SOURCE_SINK_CASES))
def test_sources_sinks_format_case(tmp_path, case):
    """The GPX, SpatiaLite, TopoJSON, KMZ, zip and GML cases of
    tests/test_geometry_sources_sinks.py (TestGpxEdgeCases and
    test_gml_urn_srsname among them)."""
    run_both(tmp_path, SOURCE_SINK_CASES[case])
