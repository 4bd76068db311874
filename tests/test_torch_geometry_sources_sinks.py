"""GeometryFileSource, GeometryTiler, GeometryFileSink, ``merge_files``
and ``to_file``, carried across from the JAX package and held to it on
the CPU.

The ``TestGeometryFileSource*`` and ``TestGeometry*Sink*`` cases of
tests/test_geometry_sources_sinks.py over the ported formats, each on a
JAX-package view and on the port's view of it (``from_reference``,
``device="cpu"``): the same features (geometries bitwise, the same
values, dtypes and index), the same extents, the same file names (each
partial file's stem is the request's token) and the same bytes (GeoJSON,
Shapefile, GML, MIF/MID, TopoJSON, FlatGeobuf; GeoPackage and SpatiaLite
contents).
GeometryTiler over boxes and over a non-rectangular request geometry
plans the JAX package's pieces.
"""
import os

import numpy as np
import pandas as pd
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo.features import GeoDataFrame as JaxGeoDataFrame
from dask_geomodeling_tpu.geometry import parallelize as jax_parallelize
from dask_geomodeling_tpu.io import vectorfile as jax_vectorfile
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch import geometry as port_blocks
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geometry import parallelize
from dask_geomodeling_tpu_torch.geometry.sinks import GeometryFileSink, to_file
from dask_geomodeling_tpu_torch.io import vectorfile
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_field_ops import assert_same_frame
from tests.test_torch_vector_formats import repaired_gml_writer, same_file, sqlite_contents
from tests.test_torch_vectorfile import _family, assert_same_read, gpkg_contents

FORMATS = ["geojson", "geojsonl", "gpkg", "shp", "gml", "kml", "csv", "fgb"]


@pytest.fixture
def root(tmp_path, monkeypatch):
    """The packages' roots; the JAX GML writer names its layer as the
    port's does (a partial named after a token that starts with a digit
    is no XML in the JAX package: tests/test_torch_vector_formats.py)."""
    monkeypatch.setattr(jax_vectorfile, "_write_gml", repaired_gml_writer)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path), "geomodeling.executor": "numpy"}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        yield tmp_path


def write(root, name, polygons, properties=None, crs="EPSG:4326"):
    """A vector file of polygons written by the JAX writer."""
    properties = properties if properties is not None else [{"name": "test"} for _ in polygons]
    frame = JaxGeoDataFrame(pd.DataFrame(properties),
                            geometry=[jax_geometry.Polygon(p) for p in polygons], crs=crs)
    jax_vectorfile.write_vector(frame, str(root / name))
    return name


def same_answer(jax_view, **request):
    """The port's view of ``jax_view`` answers ``request`` as it does."""
    ref = jax_view.get_data(**request)
    port_view = from_reference(jax_view.serialize())
    request = {k: _port_geometry(v) for k, v in request.items()}
    port = port_view.get_data(device="cpu", **request)
    assert sorted(port) == sorted(ref)
    assert port["projection"] == ref["projection"]
    if "extent" in ref:
        assert port["extent"] == ref["extent"]
    else:
        assert_same_frame(port["features"], ref["features"])
        if len(ref["features"]):
            assert port["features"].crs == ref["features"].crs
    return port, ref


def _port_geometry(value):
    if isinstance(value, jax_geometry.Geometry):
        return geometry.from_wkb(value.wkb)
    return value


@pytest.fixture
def frame_file(root):
    return write(root, "data.geojson", [[(0, 0), (2, 0), (2, 2), (0, 2)],
                                        [(4, 4), (6, 4), (6, 6), (4, 6)],
                                        [(8, 8), (10, 8), (10, 10), (8, 10)]],
                 [{"value": 1.5, "name": "a"}, {"value": 2.5, "name": "b"},
                  {"value": 3.5, "name": "c"}])


# --- TestGeometryFileSource ---


def test_columns(frame_file):
    source = jax_blocks.GeometryFileSource(frame_file)
    assert from_reference(source.serialize()).columns == source.columns == {
        "geometry", "value", "name"}


@pytest.mark.parametrize("request_fields", [
    dict(mode="intersects", geometry=jax_geometry.box(0, 0, 5, 5)),
    dict(mode="centroid", geometry=jax_geometry.box(0, 0, 5, 5)),
    dict(mode="extent", geometry=jax_geometry.box(0, 0, 20, 20)),
    dict(mode="intersects", geometry=jax_geometry.box(0, 0, 20, 20), filters={"name": "b"}),
    dict(mode="intersects", geometry=jax_geometry.box(0, 0, 20, 20), limit=1),
    dict(mode="intersects", geometry=jax_geometry.box(0, 0, 20, 20), min_size=3.0),
    dict(mode="intersects", geometry=jax_geometry.box(0, 0, 20, 20), min_size=1.0),
])
def test_file_source(frame_file, request_fields):
    same_answer(jax_blocks.GeometryFileSource(frame_file), projection="EPSG:4326",
                **request_fields)


def test_filters_lookup_unsupported(frame_file):
    source = from_reference(jax_blocks.GeometryFileSource(frame_file).serialize())
    with pytest.raises(ValueError, match="not supported"):
        source.get_data(device="cpu", mode="intersects", geometry=geometry.box(0, 0, 20, 20),
                        projection="EPSG:4326", filters={"name__in": ["b"]})


def test_global_limit(frame_file):
    source = from_reference(jax_blocks.GeometryFileSource(frame_file).serialize())
    with config.set({"geomodeling.geometry-limit": 2}):
        with pytest.raises(RuntimeError, match="maximum of 2"):
            source.get_data(device="cpu", mode="intersects", geometry=geometry.box(0, 0, 20, 20),
                            projection="EPSG:4326")


# --- TestGeometryFileSourceBehaviors, over every ported format ---

SQUARES = [[(i * 0.1, 0.0), (i * 0.1 + 0.05, 0.0), (i * 0.1 + 0.05, 0.5), (i * 0.1, 0.5)]
           for i in range(10)]


@pytest.fixture(params=FORMATS)
def squares(root, request):
    return jax_blocks.GeometryFileSource(write(root, "squares." + request.param, SQUARES))


@pytest.mark.parametrize("request_fields", [
    dict(geometry=jax_geometry.box(0, 0, 1, 1)),
    dict(geometry=jax_geometry.box(0, 0, 1, 1), limit=3),
    dict(geometry=jax_geometry.box(0, 0, 1, 1), filters=dict(name="test")),
    dict(geometry=jax_geometry.box(0, 0, 1, 1), filters=dict(name="a")),
    dict(geometry=jax_geometry.box(0, 0, 1, 1), filters=dict(a=1)),
    dict(mode="extent"),
    dict(mode="extent", limit=1),
    dict(mode="centroid", geometry=jax_geometry.box(0, 0, 0.33, 1)),
])
def test_source_behaviors(squares, request_fields):
    same_answer(squares, projection="EPSG:4326", **request_fields)


def test_reproject(squares):
    from dask_geomodeling_tpu.geo import transform_extent

    bbox3857 = transform_extent((0, 0, 1, 1), "EPSG:4326", "EPSG:3857")
    port, _ = same_answer(squares, geometry=jax_geometry.box(*bbox3857), projection="EPSG:3857")
    assert port["features"].crs == "EPSG:3857" and len(port["features"]) == 10
    if not squares.url.endswith(".csv"):  # CRS-less: taken as the requested projection
        port, _ = same_answer(squares, mode="extent", projection="EPSG:3857")
        assert port["extent"][2] > 10000.0


def test_bbox_predicates(root):
    square = [(0.5, 0.5), (0.5, 0.6), (0.6, 0.6), (0.6, 0.5)]
    source = jax_blocks.GeometryFileSource(write(
        root, "bbox.geojson", [square, [(x + 1, y) for x, y in square],
                               [(x + 0.45, y) for x, y in square]]))
    boxes = [(0.0, 0.0, 1.0, 1.0), (0.0, 0.0, 0.9, 1.0)]
    boxes += [(x, y, x, y) for x, y in [(0.5, 0.5), (0.5, 0.6), (0.6, 0.5), (0.6, 0.6),
                                        (0.49, 0.55), (0.61, 0.6), (0.55, 0.49), (0.6, 0.61)]]
    counts = [len(same_answer(source, geometry=jax_geometry.box(*b),
                              projection="EPSG:4326")[0]["features"]) for b in boxes]
    assert counts == [2, 1, 1, 1, 1, 1, 0, 0, 0, 0]


@pytest.mark.parametrize("min_size", [1.1, 0.9, 0])
def test_size_filter(root, min_size):
    source = jax_blocks.GeometryFileSource(write(
        root, "sizes.geojson", [[(0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0)],
                                [(0.0, 0.0), (0.0, 0.1), (0.1, 0.1), (0.1, 0.0)]]))
    same_answer(source, geometry=jax_geometry.box(0, 0, 1, 1), projection="EPSG:4326",
                min_size=min_size)


@pytest.mark.parametrize("mode", ["centroid", "intersects"])
def test_centroid_mode(root, mode):
    source = jax_blocks.GeometryFileSource(write(
        root, "centroid.geojson", [[(0.8, 0.8), (2.0, 0.8), (2.0, 2.0)]]))
    same_answer(source, geometry=jax_geometry.box(0, 0, 1, 1), projection="EPSG:4326",
                mode=mode)


@pytest.mark.parametrize("fmt", FORMATS)
def test_custom_id_field(root, fmt):
    name = write(root, "ids." + fmt, [[(0, 0), (1, 0), (1, 1), (0, 1)]] * 2,
                 [{"code": 42, "name": "x"}, {"code": 7, "name": "y"}])
    port, _ = same_answer(jax_blocks.GeometryFileSource(name, id_field="code"),
                          geometry=jax_geometry.box(0, 0, 1, 1), projection="EPSG:4326")
    assert set(port["features"].index.values.tolist()) == {42, 7}


@pytest.mark.parametrize("limit", [16 * 1024 * 1024, 1024])
@pytest.mark.parametrize("projection", ["EPSG:28992", "EPSG:4326"])
def test_geopackage_rtree_read_above_the_limit(root, limit, projection):
    """Above ``geomodeling.vector-windowed-read-limit`` bytes a GeoPackage
    answers the bbox through its R-tree; the features are the same."""
    rng = np.random.RandomState(5)
    corners = rng.uniform(0, 900, size=(300, 2)) + (135000, 456000)
    polygons = [[(x, y), (x + 40, y), (x + 40, y + 25), (x, y + 25)] for x, y in corners]
    name = write(root, "big.gpkg", polygons, [{"n": i} for i in range(len(polygons))],
                 crs="EPSG:28992")
    assert os.path.getsize(root / name) > 1024
    from dask_geomodeling_tpu.geo import Extent

    bbox = Extent((135200, 456100, 135650, 456500), "EPSG:28992").transformed(projection).bbox
    request = dict(geometry=jax_geometry.box(*bbox), projection=projection)
    with jax_config.set({"geomodeling.vector-windowed-read-limit": limit}), \
            config.set({"geomodeling.vector-windowed-read-limit": limit}):
        for mode in ("intersects", "centroid", "extent"):
            same_answer(jax_blocks.GeometryFileSource(name), mode=mode, **request)
    read = []
    real = vectorfile._read_gpkg
    pipeline.clear_read_cache()
    with config.set({"geomodeling.vector-windowed-read-limit": limit}):
        import unittest.mock as mock

        with mock.patch.object(vectorfile, "_read_gpkg",
                               lambda *a, **k: read.append(k.get("bbox")) or real(*a, **k)):
            from_reference(jax_blocks.GeometryFileSource(name).serialize()).get_data(
                device="cpu", mode="intersects", geometry=geometry.box(*bbox),
                projection=projection)
    assert (read[0] is not None) == (limit == 1024)


def test_unported_format_raises_naming_its_module(root):
    (root / "data.parquet").write_bytes(b"PAR1")
    source = port_blocks.GeometryFileSource("data.parquet")
    with pytest.raises(NotImplementedError, match="io/vectorfile.py"):
        source.get_data(device="cpu", mode="intersects", geometry=geometry.box(0, 0, 1, 1),
                        projection="EPSG:4326")


# --- GeometryTiler ---


@pytest.mark.parametrize("wkt, size", [
    ("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))", 4.0),
    ("POLYGON ((0 0, 10 0, 10 7.5, 0 7.5, 0 0))", 2.5),
    ("POLYGON ((0 0, 10 0, 0 10, 0 0))", 3.0),
    ("POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (3 3, 7 3, 7 7, 3 7, 3 3))", 2.0),
    ("POLYGON ((1 1, 9 2, 5 9.5, 1 1))", 20.0),
])
def test_cover_with_boxes(wkt, size):
    ref = jax_parallelize._cover_with_boxes(jax_geometry.from_wkt(wkt), size)
    port = parallelize._cover_with_boxes(geometry.from_wkt(wkt), size)
    if ref is None:
        assert port is None
        return
    assert [g.wkb for g in port] == [g.wkb for g in ref]


@pytest.mark.parametrize("wkt", [
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
    "POLYGON ((0 0, 10.5 0, 0 10.5, 0 0))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (3 3, 7 3, 7 7, 3 7, 3 3))",
])
@pytest.mark.parametrize("size", [4.0, 3.0, 100.0])
def test_geometry_tiler(root, wkt, size):
    rng = np.random.RandomState(7)
    corners = rng.uniform(-0.5, 10, size=(40, 2))
    polygons = [[(x, y), (x + 0.7, y), (x + 0.7, y + 0.4), (x, y + 0.4)] for x, y in corners]
    name = write(root, "tiled.gpkg", polygons,
                 [{"n": i, "f": bool(i % 2), "v": float(i) / 3} for i in range(len(polygons))],
                 crs="EPSG:28992")
    view = jax_blocks.GeometryTiler(jax_blocks.GeometryFileSource(name), size, "EPSG:28992")
    request = dict(mode="centroid", geometry=jax_geometry.from_wkt(wkt), projection="EPSG:28992")
    port, ref = same_answer(view, **request)
    port_view = from_reference(view.serialize())
    assert port_view.get_sources_and_requests(**{k: _port_geometry(v) for k, v in request.items()})
    same_answer(view, mode="extent", projection="EPSG:28992")
    with pytest.raises(NotImplementedError):
        port_view.get_data(device="cpu", mode="intersects", geometry=geometry.box(0, 0, 1, 1),
                           projection="EPSG:28992")


# --- TestGeometryFileSink, TestGeometrySinkBehaviors ---


def _sink_files(directory):
    return sorted(os.listdir(directory)) if os.path.isdir(directory) else []


def _same_outputs(port_dir, jax_dir):
    """The same file names, and per format the same bytes (GeoPackage:
    contents)."""
    names = _sink_files(jax_dir)
    assert _sink_files(port_dir) == names and names
    for name in names:
        ours, theirs = os.path.join(port_dir, name), os.path.join(jax_dir, name)
        if name.endswith(".gpkg"):
            assert gpkg_contents(ours) == gpkg_contents(theirs)
        elif name.endswith(".sqlite"):
            assert sqlite_contents(ours) == sqlite_contents(theirs)
        else:
            assert open(ours, "rb").read() == open(theirs, "rb").read(), name


def _sink_pair(root, source_name, ext, fields=None):
    jax_source = jax_blocks.GeometryFileSource(source_name)
    port_source = from_reference(jax_source.serialize())
    return (jax_blocks.GeometryFileSink(jax_source, "jax_out", extension=ext, fields=fields),
            port_blocks.GeometryFileSink(port_source, "port_out", extension=ext, fields=fields))


REQUEST_ALL = dict(mode="intersects", projection="EPSG:4326")


@pytest.mark.parametrize("ext", ["geojson", "gpkg", "shp", "gml", "mif", "sqlite", "topojson",
                                 "fgb"])
@pytest.mark.parametrize("fields", [None, {"renamed": "value"}, {"target": "name", "v": "value"}])
def test_sink(root, frame_file, ext, fields):
    jax_sink, port_sink = _sink_pair(root, frame_file, ext, fields)
    ref = jax_sink.get_data(geometry=jax_geometry.box(0, 0, 20, 20), **REQUEST_ALL)
    port = port_sink.get_data(device="cpu", geometry=geometry.box(0, 0, 20, 20), **REQUEST_ALL)
    assert port["features"]["saved"].tolist() == ref["features"]["saved"].tolist() == [True] * 3
    _same_outputs(str(root / "port_out"), str(root / "jax_out"))
    if ext == "shp":
        for name in _sink_files(str(root / "jax_out")):
            if name.endswith(".shp"):
                assert _family(str(root / "port_out" / name)) == _family(
                    str(root / "jax_out" / name))


def test_sink_validation(root, frame_file):
    source = port_blocks.GeometryFileSource(frame_file)
    with pytest.raises(ValueError):
        GeometryFileSink(source, "out", extension="bogus")
    with pytest.raises(ValueError):
        GeometryFileSink(source, "out", extension="geojson", fields={"x": "nope"})
    with pytest.raises(ValueError):
        GeometryFileSink(source, "out", extension="shp", fields={"target": "nonexisting"})
    with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/"):
        GeometryFileSink(source, "out", extension="parquet")
    assert sorted(GeometryFileSink.supported_extensions) == [
        "fgb", "geojson", "gml", "gpkg", "mif", "shp", "sqlite", "topojson"]


def test_sink_without_features_writes_nothing(root, frame_file):
    _, port_sink = _sink_pair(root, frame_file, "geojson")
    result = port_sink.get_data(device="cpu", geometry=geometry.box(50, 50, 60, 60),
                                **REQUEST_ALL)
    assert len(result["features"]) == 0
    assert not os.path.isdir(root / "port_out")


def _targets(root, name):
    """(the port's, the JAX package's) target of one name, in folders of
    their own (GML names its layer after the file)."""
    for side in ("port_result", "jax_result"):
        (root / side).mkdir(exist_ok=True)
    return str(root / "port_result" / name), str(root / "jax_result" / name)


@pytest.mark.parametrize("ext", ["geojson", "gpkg", "shp", "gml", "mif", "sqlite", "topojson",
                                 "fgb"])
def test_merge_files(root, frame_file, ext):
    """Partial files of several requests merged, against the JAX merge
    of the same partials; a single partial is copied with its sidecars."""
    jax_sink, port_sink = _sink_pair(root, frame_file, ext)
    for box in ((0, 0, 3, 3), (3, 3, 20, 20)):
        jax_sink.get_data(geometry=jax_geometry.box(*box), **REQUEST_ALL)
        port_sink.get_data(device="cpu", geometry=geometry.box(*box), **REQUEST_ALL)
    ours, theirs = _targets(root, "merged." + ext)
    GeometryFileSink.merge_files(str(root / "port_out"), ours, remove_source=True)
    jax_blocks.GeometryFileSink.merge_files(str(root / "jax_out"), theirs)
    assert not (root / "port_out").is_dir()
    assert_same_read(vectorfile.read_vector(ours), jax_vectorfile.read_vector(theirs))
    same_file(ours, theirs)
    with pytest.raises(IOError, match="already exists"):
        GeometryFileSink.merge_files(str(root / "port_out"), ours)
    with pytest.raises(IOError, match="No source files"):
        GeometryFileSink.merge_files(str(root / "nothing"), str(root / ("none." + ext)))


def test_merge_keeps_int_and_bool_columns_across_tiles(root):
    """int and bool columns stay int and bool across the tiles' frames,
    and a tile that answers no features adds nothing."""
    polygons = [[(1, 1), (3, 1), (3, 3), (1, 3)], [(11, 11), (13, 11), (13, 13), (11, 13)],
                [(12, 1), (14, 1), (14, 2), (12, 2)]]
    name = write(root, "two.geojson", polygons,
                 [{"value": 1, "flag": True, "x": 0.5}, {"value": 2, "flag": False, "x": 1.5},
                  {"value": 3, "flag": True, "x": np.nan}])
    request = dict(mode="centroid", geometry=jax_geometry.box(0, 0, 30, 30),
                   projection="EPSG:4326")
    view = jax_blocks.GeometryTiler(jax_blocks.GeometryFileSource(name), 10.0, "EPSG:4326")
    port, ref = same_answer(view, **request)
    assert port["features"]["value"].dtype == np.int64
    assert port["features"]["flag"].dtype == bool


@pytest.mark.parametrize("ext", ["geojson", "gpkg", "shp", "gml", "mif", "sqlite", "topojson",
                                 "fgb"])
@pytest.mark.parametrize("tile_size", [None, 4.0])
def test_to_file(root, frame_file, ext, tile_size):
    jax_source = jax_blocks.GeometryFileSource(frame_file)
    jax_view = jax_source.set("double", jax_source["value"] * 2)
    ours, theirs = _targets(root, "export." + ext)
    jax_view.to_file(theirs, tile_size=tile_size, projection="EPSG:4326")
    port_view = from_reference(jax_view.serialize())
    to_file(port_view, ours, tile_size=tile_size, projection="EPSG:4326", device="cpu")
    port_read = vectorfile.read_vector(ours)
    assert len(port_read) == 3
    assert_same_read(port_read, jax_vectorfile.read_vector(theirs))
    same_file(ours, theirs)


def test_to_file_dry_run_and_temporary_directory(root, frame_file):
    source = port_blocks.GeometryFileSource(frame_file)
    to_file(source, str(root / "dry.geojson"), dry_run=True, projection="EPSG:4326",
            device="cpu")
    assert not (root / "dry.geojson").exists()
    scratch = root / "scratch"
    scratch.mkdir()
    with config.set({"temporary_directory": str(scratch)}):
        source.to_file(str(root / "out.gpkg"), projection="EPSG:4326", device="cpu")
    assert len(vectorfile.read_vector(str(root / "out.gpkg"))) == 3
    assert os.listdir(scratch) == []  # the partials' folder is gone


def test_with_tiler_writes_only_nonempty_tiles(root):
    name = write(root, "two.geojson", [[(1, 1), (3, 1), (3, 3), (1, 3)],
                                       [(11, 11), (13, 11), (13, 13), (11, 13)]],
                 [{"value": 1}, {"value": 2}])
    block = jax_blocks.GeometryTiler(
        jax_blocks.GeometryFileSink(jax_blocks.GeometryFileSource(name), "jax_out",
                                    extension="geojson"), size=10.0, projection="EPSG:4326")
    request = dict(mode="centroid", geometry=jax_geometry.box(0, 0, 20, 20),
                   projection="EPSG:4326")
    block.get_data(**request)
    port_block = port_blocks.GeometryTiler(
        GeometryFileSink(port_blocks.GeometryFileSource(name), "port_out",
                         extension="geojson"), size=10.0, projection="EPSG:4326")
    port_block.get_data(device="cpu", mode="centroid", geometry=geometry.box(0, 0, 20, 20),
                        projection="EPSG:4326")
    _same_outputs(str(root / "port_out"), str(root / "jax_out"))
    assert len(_sink_files(str(root / "port_out"))) == 2


def test_categorical_column(root, frame_file):
    """Classify's result through a sink: the JAX package casts it to its
    labels' dtype (not a categorical), and so does the port."""
    jax_source = jax_blocks.GeometryFileSource(frame_file)
    with_class = jax_source.set(
        "categorical", jax_blocks.Classify(jax_source["value"], bins=[2.0], labels=["A", "B"]))
    jax_sink = jax_blocks.GeometryFileSink(with_class, "jax_out", extension="geojson",
                                           fields={"label": "categorical"})
    jax_sink.get_data(geometry=jax_geometry.box(0, 0, 20, 20), **REQUEST_ALL)
    port_with = from_reference(with_class.serialize())
    GeometryFileSink(port_with, "port_out", extension="geojson",
                     fields={"label": "categorical"}).get_data(
        device="cpu", geometry=geometry.box(0, 0, 20, 20), **REQUEST_ALL)
    _same_outputs(str(root / "port_out"), str(root / "jax_out"))
    files = _sink_files(str(root / "port_out"))
    result = vectorfile.read_vector(str(root / "port_out" / files[0]))
    assert sorted(result["label"].tolist()) == ["A", "B", "B"]
