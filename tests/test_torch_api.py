"""The port's API surface against the JAX package's, on the CPU.

- the top-level names (``config``, ``Block``, ``DummyBlock``, ``compute``,
  ``construct``, ``construct_multiple``, ``tokenize``, ``geometry``,
  ``raster``, ``__version__``) beside the port's own entry points, the
  flat ``geo`` namespace (but ``get_index_jax``) and ``utils``;
- ``construct`` and ``construct_multiple`` with and without validation:
  the same graph gives the JAX package's tokens, argument types and
  answers; an invalid key warns when validation is off;
- ``DummyBlock``: its name and token, and the tokens of views over it;
- ``utils.create_dataset`` and ``Dataset``: the same geo transform,
  projection WKT (for EPSG:28992, 25832 and a proj4 string), nodata and
  array;
- ``GeoTransform.cell_area``, ``scale``, ``get_points``,
  ``get_array_ranges`` and ``Extent.sr``, ``from_geometry``,
  ``as_geometry``, ``__eq__``, ``__repr__``: the JAX package's answers;
- ``view.geometry`` (bounds and ``srs``) of every raster Block class of
  tests/test_raster_contract.py, against the JAX Block's.
"""
import logging
from datetime import datetime, timedelta

import numpy as np
import pytest

import chip_smoke
import dask_geomodeling_tpu as jax_top
import dask_geomodeling_tpu.geo as jax_geo
import dask_geomodeling_tpu.utils as jax_utils
import dask_geomodeling_tpu_torch as top
import dask_geomodeling_tpu_torch.geo as port_geo
import dask_geomodeling_tpu_torch.utils as port_utils
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as JR
from dask_geomodeling_tpu.core import construct as jax_construct
from dask_geomodeling_tpu.core import construct_multiple as jax_construct_multiple
from dask_geomodeling_tpu.io.geotiff import write_geotiff
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.factories import MockGeometry
from tests.test_raster_contract import exported_raster_blocks, make_instance

JAX_TOP_NAMES = ("config", "Block", "DummyBlock", "compute", "construct",
                 "construct_multiple", "tokenize", "geometry", "raster", "__version__")
PORT_ENTRY_POINTS = ("from_reference", "get_data", "compute_torch", "compute_host",
                     "evaluate_tiled", "resolve_device")


# --- the namespaces ---


def test_top_level_names():
    for name in JAX_TOP_NAMES + PORT_ENTRY_POINTS:
        value = getattr(top, name)
        module = getattr(value, "__module__", None) or getattr(value, "__name__", "")
        if name != "__version__":
            assert module.startswith("dask_geomodeling_tpu_torch"), name
    assert top.__version__ == jax_top.__version__
    assert top.raster.Group is not None and top.geometry.AggregateRaster is not None
    assert top.Block is top.raster.RasterBlock.__mro__[1]


def test_geo_and_utils_namespaces():
    jax_names = {n for n in vars(jax_geo) if not n.startswith("_")} - {"get_index_jax"}
    port_names = {n for n in vars(port_geo) if not n.startswith("_")}
    missing = sorted(n for n in jax_names - port_names
                     if not isinstance(getattr(jax_geo, n), type(jax_geo)))
    assert not missing, missing
    assert "get_index_jax" not in port_names
    for name in ("create_dataset", "Dataset", "shapely_transform", "shapely_from_wkt",
                 "TransformException", "get_crs", "crs_to_srs", "transform_min_size",
                 "Extent", "GeoTransform"):
        assert getattr(port_utils, name).__module__.startswith("dask_geomodeling_tpu_torch")
        assert hasattr(jax_utils, name)


# --- construction ---


def _source(dtype="f4"):
    data = (np.arange(64).reshape(1, 8, 8) % 7).astype(dtype)
    return JR.MemorySource(data=data, no_data_value=6, projection="EPSG:28992",
                           pixel_size=1.0, pixel_origin=(0.0, 8.0),
                           time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))


REQUEST = dict(mode="vals", bbox=(0.0, 0.0, 8.0, 8.0), projection="EPSG:28992", width=8,
               height=8, start=datetime(2000, 1, 1))


def _graphs(jax_view):
    """The JAX construction graph (class paths of the JAX package) and the
    same graph naming the port's classes, as JSON gives them."""
    import json

    jax_graph = json.loads(jax_view.to_json())
    port_graph = json.loads(from_reference(jax_view.serialize()).to_json())
    return jax_graph, port_graph


@pytest.mark.parametrize("validate", [True, False])
@pytest.mark.parametrize("dtype", ["u1", "i2", "f4"])
def test_construct_with_and_without_validation(validate, dtype):
    jax_view = JR.Smooth(_source(dtype) + 1, 2)
    jax_graph, port_graph = _graphs(jax_view)
    expected = jax_construct(jax_graph["graph"], jax_graph["name"], validate=validate)
    actual = top.construct(port_graph["graph"], port_graph["name"], validate=validate)
    assert type(actual).__name__ == type(expected).__name__
    # keys embed the tokens: without validation each Block keeps its key's;
    # with it, the JSON lists are coerced again and the tokens follow
    source_key = [k for k in port_graph["graph"] if k.startswith("MemorySource_")][0]
    if validate:
        assert actual.token == from_reference(expected.serialize()).token
    else:
        assert actual.token == port_graph["name"].rsplit("_", 1)[1]
        assert expected.token == jax_graph["name"].rsplit("_", 1)[1]
        assert actual.args[0].args[0].token == source_key.rsplit("_", 1)[1]
        assert isinstance(actual.args[0].args[0].args[0], list)
    with jax_config.set({"geomodeling.executor": "numpy"}):
        want = expected.get_data(**REQUEST)
    got = actual.get_data(device="cpu", **REQUEST)
    assert got["values"].dtype == want["values"].dtype
    np.testing.assert_array_equal(got["values"], want["values"])


def test_construct_multiple():
    jax_view = _source() + 1
    _, port_graph = _graphs(jax_view)
    names = sorted(port_graph["graph"])
    for validate in (True, False):
        blocks = top.construct_multiple(port_graph["graph"], names, validate)
        if not validate:
            assert [b.name for b in blocks] == names
        jax_graph, _ = _graphs(jax_view)
        jax_blocks = jax_construct_multiple(jax_graph["graph"], sorted(jax_graph["graph"]),
                                            validate)
        assert [type(b).__name__ for b in blocks] == [type(b).__name__ for b in jax_blocks]


def test_construct_invalid_key_warns(caplog):
    graph = {"a": ["dask_geomodeling_tpu_torch.raster.sources.MemorySource",
                   [[1, 2]], 255, "EPSG:28992", 1.0, [0.0, 1.0]]}
    with caplog.at_level(logging.WARNING, logger="dask_geomodeling_tpu_torch.core.graphs"):
        block = top.construct(graph, "a", validate=False)
    assert "invalid name ('a')" in caplog.text
    assert block.data.dtype == np.int64
    with pytest.raises(KeyError):
        top.construct(graph, "b")


def test_construct_prefixes_errors_with_the_key():
    graph = {"bad_key": ["dask_geomodeling_tpu_torch.raster.sources.MemorySource",
                         [[1, 2]], 255, "EPSG:28992", [1.0, 2.0, 3.0], [0.0, 1.0]]}
    with pytest.raises(ValueError, match="^bad_key: pixel_size"):
        top.construct(graph, "bad_key")


def test_from_json_skips_validation_and_keeps_the_token():
    view = from_reference(JR.Smooth(_source("u1") + 1, 2).serialize())
    loaded = top.Block.from_json(view.to_json())
    assert loaded.token == view.token
    assert top.Block.deserialize(view.serialize(), validate=True).token == view.token


# --- DummyBlock ---


def test_dummy_block():
    token = "872650a1016b7d4ab8f01a77f2034c33"
    port, jax = top.DummyBlock("Name_" + token), jax_top.DummyBlock("Name_" + token)
    assert port.token == jax.token == token
    assert port.name == jax.name == "Name_" + token
    assert top.DummyBlock("some_block_" + token).token == token
    source = from_reference(_source().serialize())
    derived = Pair(port, 2)
    assert derived.token == Pair(top.DummyBlock(port.name), 2).token
    assert derived.token != Pair(source, 2).token
    graph, name = derived.get_graph()
    assert graph[port.name] == [top.DummyBlock, port.name]


class Pair(top.Block):
    """A Block of two arguments (graph keys hash its import path)."""


# --- utils ---


@pytest.mark.parametrize("projection", ["EPSG:28992", "EPSG:25832",
                                        "+proj=utm +zone=31 +ellps=GRS80 +units=m +no_defs",
                                        None])
def test_create_dataset(projection):
    array = np.arange(24, dtype="f4").reshape(2, 3, 4)
    kwargs = dict(geo_transform=(10.0, 0.5, 0.0, 20.0, 0.0, -0.5), projection=projection,
                  no_data_value=-1.0)
    port, jax = port_utils.create_dataset(array, **kwargs), jax_utils.create_dataset(array, **kwargs)
    for method in ("GetGeoTransform", "GetProjection", "GetNoDataValue"):
        assert getattr(port, method)() == getattr(jax, method)(), method
    assert (port.RasterCount, port.RasterYSize, port.RasterXSize) == (2, 3, 4)
    assert port.ReadAsArray() is array
    with port_utils.Dataset(array, **kwargs) as dataset:
        assert dataset.GetProjection() == jax.GetProjection()
    assert port_utils.create_dataset(array).GetGeoTransform() == (0, 1, 0, 0, 0, -1)
    with pytest.raises(ValueError):
        port_utils.create_dataset(array[0])


# --- GeoTransform and Extent ---


GEO_TRANSFORMS = [(0.0, 1.0, 0.0, 10.0, 0.0, -1.0), (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.25),
                  (-3.5, 2.0, 0.0, 7.25, 0.0, 3.0)]


@pytest.mark.parametrize("gt", GEO_TRANSFORMS)
def test_geo_transform_methods(gt):
    port, jax = port_geo.GeoTransform(gt), jax_geo.GeoTransform(gt)
    assert port.cell_area == jax.cell_area
    assert tuple(port.scale(2.0, 0.5)) == tuple(jax.scale(2.0, 0.5))
    assert type(port.scale(2.0, 0.5)) is port_geo.GeoTransform
    assert repr(port) == repr(jax)
    indices = np.random.RandomState(0).randint(-5, 50, (20, 2))
    np.testing.assert_array_equal(port.get_points(indices), jax.get_points(indices))
    rng = np.random.RandomState(1)
    for _ in range(50):
        x = sorted(gt[0] + rng.uniform(-20, 40, 2) * gt[1])
        y = sorted(gt[3] + rng.uniform(-20, 40, 2) * gt[5])
        bbox = (x[0], y[0], x[1], y[1])
        shape = (1, int(rng.randint(1, 30)), int(rng.randint(1, 30)))
        assert port.get_array_ranges(bbox, shape) == jax.get_array_ranges(bbox, shape)


def test_extent_methods():
    bbox = (135000.0, 455000.0, 136000.123, 456000.0)
    port, jax = port_geo.Extent(bbox, "EPSG:28992"), jax_geo.Extent(bbox, "EPSG:28992")
    assert repr(port) == repr(jax)
    assert port.sr.ExportToWkt() == jax.sr.ExportToWkt()
    geometry = port.as_geometry()
    assert geometry.bounds == jax.as_geometry().bounds and geometry.srs == "EPSG:28992"
    assert port_geo.Extent.from_geometry(geometry) == port
    assert port != port_geo.Extent(bbox, "EPSG:3857") and hash(port) == hash(port_geo.Extent(bbox, "EPSG:28992"))
    for srs in ("EPSG:4326", "EPSG:25832", "EPSG:3035"):
        assert port.transformed(srs).bbox == jax.transformed(srs).bbox


# --- view.geometry across the raster Blocks ---


def _jax_sources(tmp_path):
    source = JR.MemorySource(
        data=np.full((2, 10, 10), 3, dtype=np.uint8), no_data_value=255,
        projection="EPSG:28992", pixel_size=1.0, pixel_origin=(135000, 456000),
        time_first=datetime(2000, 1, 1), time_delta=timedelta(hours=1))
    polygon = [(135000, 455990), (135010, 455990), (135010, 456000), (135000, 456000)]
    return source, MockGeometry([polygon], projection="EPSG:28992"), polygon


RASTER_CLASSES = [cls.__name__ for cls in exported_raster_blocks()]


@pytest.mark.parametrize("name", RASTER_CLASSES)
def test_view_geometry_matches_the_jax_block(name, tmp_path):
    from dask_geomodeling_tpu_torch.raster import Rasterize

    cls = getattr(JR, name)
    source, geom_source, polygon = _jax_sources(tmp_path)
    pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path)}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        if name == "MemorySource":
            jax_block = source
        elif name in ("RasterFileSource", "RasterFileSink"):
            write_geotiff(str(tmp_path / "a.tif"), np.full((1, 10, 12), 3, "u1"),
                          (135000.0, 1.0, 0.0, 456000.0, 0.0, -1.0), "EPSG:25832", 255)
            jax_block = JR.RasterFileSource("a.tif")
            if name == "RasterFileSink":
                jax_block = JR.RasterFileSink(jax_block, str(tmp_path / "out"))
        else:
            jax_block = make_instance(cls, source, geom_source)
        if name == "Rasterize":
            port_block = Rasterize(chip_smoke.mock_geometry_class()(
                [polygon], projection="EPSG:28992"))
        else:
            port_block = from_reference(jax_block.serialize())
        assert type(port_block).__name__ == name
        expected, actual = jax_block.geometry, port_block.geometry
    pipeline.clear_read_cache()
    if expected is None:
        assert actual is None
        return
    assert type(actual).__name__ == type(expected).__name__
    assert actual.bounds == expected.bounds
    assert actual.srs == expected.srs
