"""The constructive, set, merge and text GeometryBlocks, ``buffer`` and the
frame's ``merge``, held on the CPU to the JAX package.

Every case of tests/test_geometry.py's TestBufferBehaviors, TestMerge
and TestParseTextColumn, and its Difference, Intersection, Buffer and
Simplify cases, each view built twice: over tests/factories.py's
MockGeometry with the JAX package's blocks (its numpy executor) and over
its copy ``chip_smoke.mock_geometry_class()`` with the port's (on the
CPU).  The port's frames must be the JAX package's, column by column:
the same names in the same order, the same index, the same cells (NaN
alike, geometries by WKB) and the same dtypes (pandas' str and object as
the port's object).  Then hypothesis: ``buffer`` bitwise to the JAX
``buffer`` over footprints, points, lines, multipolygons with holes and
negative distances; the frame's ``merge`` and ParseTextColumn's dtypes
against pandas 3.0.3, imported here only.
"""
import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import geometry as jax_blocks
from dask_geomodeling_tpu.geo import _buffer as jax_buffer
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geometry.text import autocast_value as jax_autocast
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch import geometry as port_blocks
from dask_geomodeling_tpu_torch.geo import _buffer, geometry
from dask_geomodeling_tpu_torch.geo import features
from dask_geomodeling_tpu_torch.geometry.text import autocast_value
from tests.factories import MockGeometry as JaxMockGeometry

SQUARE1 = [(0, 0), (10, 0), (10, 10), (0, 10)]
SQUARE2 = [(20, 20), (30, 20), (30, 30), (20, 30)]
PROPERTIES = [{"id": 1, "value": 4.0, "name": "a"}, {"id": 2, "value": 8.0, "name": "b"}]


class Side:
    """One package's blocks, MockGeometry and geometry module."""

    def __init__(self, blocks, mock, geometry_module):
        self.G = blocks
        self.Mock = mock
        self.geo = geometry_module

    def get(self, view, **request):
        if self.G is jax_blocks:
            with jax_config.set({"geomodeling.executor": "numpy"}):
                return view.get_data(**request)
        return view.get_data(device="cpu", **request)


JAX = Side(jax_blocks, JaxMockGeometry, jax_geometry)
PORT = Side(port_blocks, chip_smoke.mock_geometry_class(), geometry)


def _cell(value):
    if isinstance(value, (geometry.Geometry, jax_geometry.Geometry)):
        return ("geometry", value.wkb)
    return repr(value)


def assert_same_frame(port, ref):
    """The port's frame against the JAX package's, column by column."""
    assert port.columns == list(ref.columns)
    assert port.index.values.tolist() == ref.index.tolist()
    assert port.index.name == ref.index.name
    for column in ref.columns:
        assert [_cell(v) for v in port[column].values.tolist()] == \
            [_cell(v) for v in ref[column].tolist()], column
        dtype = ref[column].dtype
        if isinstance(dtype, np.dtype) and dtype != object:
            assert port[column].values.dtype == dtype, column
        else:  # pandas' object or str: the port holds an object array
            assert port[column].values.dtype == object, column


def assert_same_answer(port, ref):
    assert set(port) == set(ref)
    assert port["projection"] == ref["projection"]
    if "features" in ref:
        if len(ref["features"]) == 0:
            assert len(port["features"]) == 0
        else:
            assert_same_frame(port["features"], ref["features"])
    if "extent" in ref:
        assert port["extent"] == (None if ref["extent"] is None else tuple(ref["extent"]))


def both(build, **request):
    """``build(side)`` -> view in each package; the answers compared.
    The request's geometry is given as bounds."""
    answers = []
    for side in (PORT, JAX):
        req = dict(request)
        if "geometry" in req:
            req["geometry"] = side.geo.box(*req["geometry"])
        answers.append(side.get(build(side), **req))
    assert_same_answer(*answers)
    return answers


REQUEST_ALL = dict(mode="intersects", geometry=(0, 0, 50, 50), projection="EPSG:3857")


def source(side, polygons=(SQUARE1, SQUARE2), properties=PROPERTIES, **kwargs):
    return side.Mock([list(p) for p in polygons], properties, **kwargs)


# --- TestSetOperations, TestConstructive ---


def test_intersection():
    port, _ = both(lambda s: s.G.Intersection(source(s)), **dict(REQUEST_ALL, geometry=(0, 0, 5, 5)))
    assert len(port["features"]) == 1
    assert port["features"].geometry.values[0].area == pytest.approx(25.0)


def test_difference():
    port, _ = both(lambda s: s.G.Difference(
        s.Mock([SQUARE1], properties=[{"id": 1}]),
        s.Mock([[(5, 5), (15, 5), (15, 15), (5, 15)]], properties=[{"id": 1}])), **REQUEST_ALL)
    assert port["features"].geometry.values[0].area == pytest.approx(75.0)


def test_difference_missing_in_b():
    port, _ = both(lambda s: s.G.Difference(s.Mock([SQUARE1], properties=[{"id": 1}]),
                                            s.Mock([SQUARE2], properties=[{"id": 99}])),
                   **REQUEST_ALL)
    assert port["features"].geometry.values[0].area == pytest.approx(100.0)


UNIT_REQUEST = dict(mode="intersects", projection="EPSG:3857", geometry=(0, 0, 1, 1))
BIG = ((0.0, 0.0), (0.0, 2.0), (2.0, 2.0), (2.0, 0.0))


def test_intersection_with_request():
    port, _ = both(lambda s: s.G.Intersection(s.Mock([BIG])), **UNIT_REQUEST)
    assert port["features"]["geometry"].values[0].area == pytest.approx(1.0)
    port, _ = both(lambda s: s.G.Intersection(s.Mock([BIG])), **dict(UNIT_REQUEST, mode="extent"))
    assert tuple(port["extent"]) == (0.0, 0.0, 1.0, 1.0)


def test_intersection_refuses_another_source():
    for side in (PORT, JAX):
        with pytest.raises(NotImplementedError, match="another geometry datasource"):
            side.G.Intersection(side.Mock([BIG]), side.Mock([BIG]))
        with pytest.raises(NotImplementedError, match="a constant geometry"):
            side.G.Intersection(side.Mock([BIG]), "POINT (1 1)")


def test_difference_scopes_other_request():
    small = ((0.0, 0.0), (0.0, 1.0), (1.0, 1.0), (1.0, 0.0))
    for side in (PORT, JAX):
        view = side.G.Difference(side.Mock([BIG]), side.Mock([small]))
        sar = view.get_sources_and_requests(**dict(UNIT_REQUEST, geometry=side.geo.box(0, 0, 1, 1)))
        assert sar[-1][1]["geometry"].area == pytest.approx(4.0)
    port, _ = both(lambda s: s.G.Difference(s.Mock([BIG]), s.Mock([small])), **UNIT_REQUEST)
    assert len(port["features"]) == 1
    assert port["features"]["geometry"].values[0].area == pytest.approx(3.0)


def test_difference_with_empty_source():
    for side in (PORT, JAX):
        view = side.G.Difference(side.Mock([]), side.Mock([BIG]))
        sar = view.get_sources_and_requests(**dict(UNIT_REQUEST, geometry=side.geo.box(0, 0, 1, 1)))
        assert len(sar) == 1 and sar[0][1] is None
    port, _ = both(lambda s: s.G.Difference(s.Mock([]), s.Mock([BIG])), **UNIT_REQUEST)
    assert len(port["features"]) == 0


def test_difference_with_empty_other():
    port, _ = both(lambda s: s.G.Difference(s.Mock([BIG]), s.Mock([])), **UNIT_REQUEST)
    assert len(port["features"]) == 1
    assert port["features"]["geometry"].values[0].area == pytest.approx(4.0)


def test_buffer():
    port, _ = both(lambda s: s.G.Buffer(source(s), 1.0, "EPSG:3857"), **REQUEST_ALL)
    assert port["features"].geometry.values[0].area > 100.0


def test_buffer_validation():
    for side in (PORT, JAX):
        with pytest.raises(TypeError):
            side.G.Buffer(source(side), "a lot", "EPSG:3857")
        with pytest.raises(TypeError):
            side.G.Buffer(source(side), 1.0, 28992)
        with pytest.raises(TypeError):
            side.G.Buffer(source(side), 1.0, "EPSG:3857", resolution=1.5)


def test_simplify():
    poly = [(0, 0), (5, 0.0001), (10, 0), (10, 10), (0, 10)]
    port, _ = both(lambda s: s.G.Simplify(s.Mock([poly], properties=[{"id": 1}]),
                                          tolerance=0.01), **REQUEST_ALL)
    assert len(port["features"].geometry.values[0].exterior.coords) == 5


def test_simplify_tolerance_defaults_to_min_size():
    poly = [(0, 0), (5, 0.5), (10, 0), (10, 10), (0, 10)]
    for min_size in (0.1, 1.0):
        both(lambda s: s.G.Simplify(s.Mock([poly], properties=[{"id": 1}])),
             **dict(REQUEST_ALL, min_size=min_size))


# --- TestBufferBehaviors ---


def test_buffer_square():
    port, _ = both(lambda s: s.G.Buffer(s.Mock([((1, 1), (2, 1), (2, 2), (1, 2))]), distance=1.0,
                                        projection="EPSG:3857"),
                   mode="intersects", projection="EPSG:3857", geometry=(0, 0, 10, 10))
    expected = 1 + 4 + np.pi
    assert port["features"].geometry.area.values[0] == pytest.approx(expected, rel=0.02)


def test_buffer_transform():
    from dask_geomodeling_tpu_torch.geo import shapely_transform

    polygon = ((155000, 463000), (155001, 463000), (155001, 463001), (155000, 463001))
    port, _ = both(lambda s: s.G.Buffer(s.Mock([polygon], projection="EPSG:28992"), distance=0.1,
                                        projection="EPSG:28992"),
                   mode="intersects", projection="EPSG:4326", geometry=(4, 51, 7, 53))
    actual = shapely_transform(port["features"].geometry.values[0], "EPSG:4326", "EPSG:28992").area
    assert actual == pytest.approx(1 + 4 * 0.1 + np.pi * 0.1**2, rel=0.02)


def test_buffer_extent_mode():
    polygon = ((155000, 463000), (156000, 463000), (156000, 464000), (155000, 464000))
    port, _ = both(lambda s: s.G.Buffer(s.Mock([polygon], projection="EPSG:28992"), distance=10,
                                        projection="EPSG:28992"),
                   mode="extent", projection="EPSG:4326", geometry=(4, 51, 7, 53))
    expected = (5.38705742335229, 52.15508055768161, 5.401968302292468, 52.16425103224139)
    np.testing.assert_allclose(port["extent"], expected, atol=5e-5)


def test_buffer_empty():
    request = dict(mode="intersects", projection="EPSG:3857", geometry=(0, 0, 10, 10))
    port, _ = both(lambda s: s.G.Buffer(s.Mock([]), distance=1.0, projection="EPSG:3857"),
                   **request)
    assert len(port["features"]) == 0
    port, _ = both(lambda s: s.G.Buffer(s.Mock([]), distance=1.0, projection="EPSG:3857"),
                   **dict(request, mode="extent"))
    assert port["extent"] is None


# --- TestMerge ---


def test_merge_inner():
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(
        s.G.SetSeriesBlock(source(s), "x", 1), s.G.SetSeriesBlock(source(s), "y", 2),
        how="inner"), **REQUEST_ALL)
    assert "x" in port["features"].columns and "y" in port["features"].columns
    assert len(port["features"]) == 2


def test_merge_suffixes():
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(source(s), source(s), suffixes=("_l", "_r")),
                   **REQUEST_ALL)
    assert {"value_l", "value_r", "geometry_l", "geometry_r"} <= set(port["features"].columns)


def test_merge_extent():
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(source(s), source(s), how="outer"),
                   **dict(REQUEST_ALL, mode="extent"))
    assert port["extent"] == (0.0, 0.0, 30.0, 30.0)


def test_merge_validation():
    for side in (PORT, JAX):
        with pytest.raises(KeyError):
            side.G.MergeGeometryBlocks(source(side), source(side), how="sideways")
        with pytest.raises(TypeError):
            side.G.MergeGeometryBlocks(source(side), source(side), suffixes=("_l", 2))


@pytest.mark.parametrize("how, first, second, expected", [
    ("inner", 0, 1, (3.0, 3.0, 3.0, 3.0)),
    ("inner", 0, 3, None),
    ("outer", 0, 3, (2.0, 2.0, 6.0, 6.0)),
    ("inner", 0, 2, None),
    ("outer", 0, 2, (2.0, 2.0, 3.0, 3.0)),
    ("left", 0, 3, (2.0, 2.0, 3.0, 3.0)),
    ("right", 0, 3, (5.0, 5.0, 6.0, 6.0)),
])
def test_merge_extent_variants(how, first, second, expected):
    squares = [[((2.0, 2.0), (3.0, 2.0), (3.0, 3.0), (2.0, 3.0))],
               [((3.0, 3.0), (4.0, 3.0), (4.0, 4.0), (3.0, 4.0))],
               [],
               [((5.0, 5.0), (6.0, 5.0), (6.0, 6.0), (5.0, 6.0))]]
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(s.Mock(squares[first]), s.Mock(squares[second]),
                                                     how=how),
                   geometry=(0, 0, 10, 10), mode="extent", projection="EPSG:3857")
    assert port["extent"] == expected


def test_merge_empty_source():
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(source(s), s.Mock([]), how="inner"),
                   **REQUEST_ALL)
    assert len(port["features"]) == 0


@pytest.mark.parametrize("how", ["left", "right", "inner", "outer"])
def test_merge_hows_with_missing_rows(how):
    """Labels on one side only: int columns become float64, bool ones
    object, the right's geometry "geometry_right", NaN where a row is
    missing."""
    left = [{"id": i, "n": i * 3, "flag": i % 2 == 0, "name": "l%d" % i} for i in (4, 1, 7, 3)]
    right = [{"id": i, "n": i * 5, "flag": i > 2, "x": i / 4} for i in (7, 2, 1, 9)]
    sq = [SQUARE1, SQUARE2, SQUARE1, SQUARE2]
    port, _ = both(lambda s: s.G.MergeGeometryBlocks(s.Mock(sq, left), s.Mock(sq, right), how=how),
                   **REQUEST_ALL)
    assert "geometry_right" in port["features"].columns


def test_merge_columns_property():
    for side in (PORT, JAX):
        view = side.G.MergeGeometryBlocks(source(side), side.G.SetSeriesBlock(source(side), "y", 2))
        assert view.columns == {"geometry", "geometry_right", "value", "value_right", "name",
                                "name_right", "y"}


# --- TestParseTextColumn ---

KEY_MAPPING = {"modelname": "model_name", "duration": "rainfall_duration",
               "strength": "rainfall_strength", "ahn2": "ahn2_used"}
DESCRIPTION = ("\nSimulation of Rotterdam\n\nmodelname=rotterdam 01"
               "\nduration=120\nstrength=70\nahn2=true")
EXPECTED = {"model_name": "rotterdam 01", "rainfall_duration": 120, "rainfall_strength": 70,
            "ahn2_used": True}
OTHER = ("\nSimulation of Groningen\n\nmodelname=groningen 01"
         "\nduration=60\nstrength=120\nahn2=false")


def parsed(descriptions, mapping=KEY_MAPPING):
    def build(s):
        mock = s.Mock([SQUARE1] * len(descriptions),
                      [{"id": i + 1, "description": d} for i, d in enumerate(descriptions)])
        return s.G.ParseTextColumn(mock, "description", mapping)

    port, _ = both(build, **REQUEST_ALL)
    return port["features"]


def _at(frame, label, column):
    return frame[column].values[frame.index.values.tolist().index(label)]


def test_parse():
    def build(s):
        mock = s.Mock([SQUARE1, SQUARE2], [{"id": 1, "description": "depth=1.2\nquality=good"},
                                           {"id": 2, "description": "depth=3.4\nquality=bad"}])
        return s.G.ParseTextColumn(mock, "description", {"depth": "depth_m", "quality": "qual"})

    port, _ = both(build, **REQUEST_ALL)
    assert build(PORT).columns == {"geometry", "description", "depth_m", "qual"}
    assert port["features"]["depth_m"].tolist() == [1.2, 3.4]
    assert port["features"]["qual"].tolist() == ["good", "bad"]


def test_autocast():
    for value in ("1.5", "true", "TRUE", "False", "null", "abc", "nan", "-inf", "", "1e3", None):
        assert repr(autocast_value(value)) == repr(jax_autocast(value))
    assert autocast_value("1.5") == 1.5
    assert autocast_value("true") is True
    assert autocast_value("null") is None
    assert autocast_value("abc") == "abc"


def test_parser_results():
    data = parsed([DESCRIPTION])
    for col, expected in EXPECTED.items():
        assert _at(data, 1, col) == expected


def test_parser_empty_description():
    data = parsed([None])
    for col in EXPECTED:
        assert features.is_null(_at(data, 1, col))
        assert data[col].values.dtype == np.float64


def test_parser_empty_one_description():
    data = parsed([None, DESCRIPTION])
    for col, expected in EXPECTED.items():
        assert features.is_null(_at(data, 1, col))
        assert _at(data, 2, col) == expected


def test_parser_two_different():
    data = parsed([DESCRIPTION, OTHER])
    expected2 = {"model_name": "groningen 01", "rainfall_duration": 60,
                 "rainfall_strength": 120, "ahn2_used": False}
    for col in EXPECTED:
        assert _at(data, 1, col) == EXPECTED[col]
        assert _at(data, 2, col) == expected2[col]
    assert data["ahn2_used"].values.dtype == bool


def test_parser_missing_and_null_keys():
    data = parsed(["\nSimulation of Utrecht\n\nmodelname=null\nduration=60\nstrength=120"])
    assert features.is_null(_at(data, 1, "model_name"))
    assert _at(data, 1, "rainfall_duration") == 60
    assert _at(data, 1, "rainfall_strength") == 120
    assert features.is_null(_at(data, 1, "ahn2_used"))


def test_parser_into_same_column():
    data = parsed([DESCRIPTION], {"modelname": "description"})
    assert _at(data, 1, "description") == "rotterdam 01"


def test_parser_into_same_column_non_existing():
    data = parsed([DESCRIPTION], {"nonexisting": "description"})
    assert features.is_null(_at(data, 1, "description"))


def test_parser_missing_column_raises():
    for side in (PORT, JAX):
        with pytest.raises(KeyError, match="not available"):
            side.G.ParseTextColumn(source(side), "description", {"a": "b"})


def test_from_reference_builds_the_six_blocks():
    """Each of the six comes across as the port's class of the same module
    path with the same arguments, and answers as the JAX package."""
    from dask_geomodeling_tpu.geometry import GeometryWKTSource as JaxWKTSource

    wkt = "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))"
    jax_source = JaxWKTSource(wkt, "EPSG:3857")
    views = [
        jax_blocks.Buffer(jax_source, 2.0, "EPSG:3857", 8),
        jax_blocks.Simplify(jax_source, 0.5, False),
        jax_blocks.Difference(jax_source, JaxWKTSource("POLYGON ((5 5, 15 5, 15 15, 5 15, 5 5))",
                                                       "EPSG:3857")),
        jax_blocks.Intersection(jax_source),
        jax_blocks.MergeGeometryBlocks(jax_source, jax_source, "outer", ("_a", "_b")),
        jax_blocks.ParseTextColumn(jax_source, "geometry", {"a": "x"}),
    ]
    request = dict(mode="intersects", projection="EPSG:3857", geometry=(1, 1, 8, 8))
    for view in views:
        port = from_reference(view.serialize())
        assert type(port).__module__ == type(view).__module__.replace(
            "dask_geomodeling_tpu", "dask_geomodeling_tpu_torch")
        assert type(port).__name__ == type(view).__name__
        assert port.columns == view.columns
        req = dict(request, geometry=geometry.box(*request["geometry"]))
        ref_req = dict(request, geometry=jax_geometry.box(*request["geometry"]))
        with jax_config.set({"geomodeling.executor": "numpy"}):
            ref = view.get_data(**ref_req)
        assert_same_answer(port.get_data(device="cpu", **req), ref)


# --- hypothesis: buffer bitwise ---


def _pair(make):
    return make(geometry), make(jax_geometry)


def _footprint(seed):
    rng = np.random.default_rng(seed)
    ring = chip_smoke.building_footprint(rng, 155000.0, 463000.0, rng.uniform(3.0, 12.0))
    return lambda g: g.Polygon(ring)


def _point(seed):
    rng = np.random.default_rng(seed)
    x, y = rng.uniform(-50, 50, 2)
    return lambda g: g.Point(x, y)


def _line(seed):
    rng = np.random.default_rng(seed)
    coords = np.round(rng.uniform(0, 20, (int(rng.integers(2, 6)), 2)), 3)
    return lambda g: g.LineString(coords)


def _holes(seed):
    rng = np.random.default_rng(seed)
    w = rng.uniform(6, 15)

    def make(g):
        outer = [(0, 0), (w, 0), (w, w), (0, w)]
        hole = [(2, 2), (2, w - 2), (w - 2, w - 2), (w - 2, 2)]
        other = [(w + 3, 1), (w + 8, 1), (w + 8, 6), (w + 3, 6)]
        return g.MultiPolygon([g.Polygon(outer, [hole]), g.Polygon(other)])
    return make


KINDS = {"footprint": _footprint, "point": _point, "line": _line, "holes": _holes}


@settings(max_examples=30, deadline=None)
@given(kind=st.sampled_from(sorted(KINDS)), seed=st.integers(0, 2**16),
       distance=st.sampled_from([-2.0, -0.75, 0.0, 0.5, 1.25, 3.0]),
       resolution=st.sampled_from([4, 8, 16]))
def test_buffer_bitwise(kind, seed, distance, resolution):
    port, ref = _pair(KINDS[kind](seed))
    got = _buffer.buffer(port, distance, resolution)
    want = jax_buffer.buffer(ref, distance, resolution)
    assert type(got).__name__ == type(want).__name__
    assert got.wkb == want.wkb
    assert port.buffer(distance, resolution).wkb == want.wkb


def test_buffer_of_a_building_footprint_at_ten_metres():
    port, ref = _pair(_footprint(13))
    assert port.buffer(10.0).wkb == ref.buffer(10.0).wkb
    ring = port.buffer(10.0).difference(port).simplify(0.25)
    assert ring.wkb == ref.buffer(10.0).difference(ref).simplify(0.25).wkb


def test_geoseries_operations_as_the_jax_package():
    from dask_geomodeling_tpu.geo.features import GeoSeries as JaxGeoSeries

    polygons = [[(0, 0), (4, 0), (4, 4), (0, 4)], [(6, 1), (9.5, 1), (9.5, 3), (6, 3)]]
    port = features.GeoSeries([geometry.Polygon(p) for p in polygons], index=features.Index(
        np.array([3, 8])), crs="EPSG:28992")
    ref = JaxGeoSeries([jax_geometry.Polygon(p) for p in polygons], index=[3, 8],
                       crs="EPSG:28992")
    cases = [
        (lambda s, g: s.buffer(1.0, 8)),
        (lambda s, g: s.simplify(0.5)),
        (lambda s, g: s.intersection(g.box(1, 1, 7, 2))),
        (lambda s, g: s.difference(g.box(1, 1, 7, 2))),
    ]
    for case in cases:
        got, want = case(port, geometry), case(ref, jax_geometry)
        assert [g.wkb for g in got.values] == [g.wkb for g in want]
        assert got.index.values.tolist() == want.index.tolist()
        assert got.crs == want.crs
    other_port = features.GeoSeries([geometry.box(0, 0, 1, 1)], index=features.Index(np.array([8])))
    other_ref = JaxGeoSeries([jax_geometry.box(0, 0, 1, 1)], index=[8])
    got = port.difference(other_port.reindex(port.index))
    want = ref.difference(other_ref.reindex(ref.index))
    assert [g.wkb for g in got.values] == [g.wkb for g in want]


# --- hypothesis: merge against pandas ---


def _frames(rows, seed, prefix):
    """(port frame, pandas frame) of ``rows`` labels with an int, a bool, a
    float, a str and a geometry column."""
    rng = np.random.default_rng(seed)
    n = len(rows)
    ints = rng.integers(-5, 5, n)
    bools = rng.random(n) < 0.5
    floats = np.round(rng.normal(size=n), 2)
    strs = ["%s%d" % (prefix, v) for v in rng.integers(0, 9, n)]
    geoms = [geometry.box(float(i), 0.0, float(i) + 1, 1.0) for i in range(n)]
    columns = {"i": ints, "b": bools, prefix + "f": floats}
    port = features.GeoDataFrame(dict(columns, s=features._objects(strs)), geometry=geoms,
                                 index=features.Index(np.array(rows, np.int64), name="id"))
    index = pd.Index(rows, dtype=np.int64, name="id")
    ref = pd.DataFrame(dict(columns, s=pd.Series(strs, dtype="str", index=index),
                            geometry=pd.Series(geoms, dtype=object, index=index)), index=index)
    return port, ref


def _same_merge(port, ref):
    assert port.columns == list(ref.columns)
    assert port.index.values.tolist() == ref.index.tolist()
    assert port.index.values.dtype == ref.index.dtype
    assert port.index.name == ref.index.name
    for column in ref.columns:
        assert repr(port[column].values.tolist()) == repr(ref[column].tolist()), column
        dtype = ref[column].dtype
        if isinstance(dtype, np.dtype) and dtype != object:
            assert port[column].values.dtype == dtype, column
        else:
            assert port[column].values.dtype == object, column


@settings(max_examples=80, deadline=None)
@given(left=st.lists(st.integers(0, 6), max_size=6), right=st.lists(st.integers(0, 6), max_size=6),
       how=st.sampled_from(["left", "right", "inner", "outer"]),
       suffixes=st.sampled_from([("", "_right"), ("_x", "_y"), ("_l", "")]),
       seed=st.integers(0, 1000))
def test_merge_as_pandas(left, right, how, suffixes, seed):
    """Row order for each how, duplicate labels, suffixes on the shared
    columns (the geometry too), int to float64 and bool to object where a
    row is missing."""
    lp, lr = _frames(left, seed, "l")
    rp, rr = _frames(right, seed + 1, "r")
    got = features.merge(lp, rp, how=how, suffixes=suffixes)
    want = pd.merge(lr, rr, how=how, suffixes=suffixes, left_index=True, right_index=True)
    _same_merge(got, want)
    if suffixes[0] == "" and len(got.columns):
        assert got.geometry is not None


def test_merge_refuses_overlap_without_suffixes():
    lp, lr = _frames([1, 2], 0, "l")
    with pytest.raises(ValueError, match="no suffix"):
        features.merge(lp, lp, suffixes=("", ""))
    with pytest.raises(ValueError):
        pd.merge(lr, lr, suffixes=("", ""), left_index=True, right_index=True)


# --- hypothesis: ParseTextColumn's dtypes against pandas ---

_VALUES = st.sampled_from(["1.5", "true", "false", "null", "abc", "nan", "-2", "x y", ""])


@settings(max_examples=60, deadline=None)
@given(rows=st.lists(st.one_of(st.none(), st.dictionaries(st.sampled_from(["a", "b", "c"]),
                                                          _VALUES, max_size=3)),
                     min_size=1, max_size=6))
def test_parse_text_column_dtypes_as_pandas(rows):
    """The parsed columns typed as pandas infers a series of mixed None,
    float, bool and str cells; a column with nothing found is a float64
    NaN column."""
    descriptions = [None if r is None else "\n".join("%s=%s" % kv for kv in r.items())
                    for r in rows]
    parsed(descriptions, {"a": "col_a", "b": "col_b", "c": "col_c"})
