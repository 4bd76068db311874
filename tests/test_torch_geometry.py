"""The port's geometry engine, WKT, CRS transform and pandas-free feature
frame, held on the CPU to the JAX package's: the engine bitwise (the same
coordinates, measures and predicate answers), the frame against the JAX
package's pandas frames on every operation the ported blocks use.  This
file and tests/test_torch_calendar.py are the port's tests that import
pandas.
"""
import numpy as np
import pandas as pd
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geo import shapely_transform as jax_shapely_transform
from dask_geomodeling_tpu.geo.features import GeoDataFrame as JaxGeoDataFrame
from dask_geomodeling_tpu.geo.features import GeoSeries as JaxGeoSeries
from dask_geomodeling_tpu.geometry import GeometryWKTSource as JaxGeometryWKTSource
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.geo import geometry, shapely_transform
from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame, GeoSeries
from tests.factories import MockGeometry as JaxMockGeometry

WKTS = [
    "POINT (135010.5 455990.25)",
    "POINT EMPTY",
    "MULTIPOINT ((0 0), (3 4), (-1.5 2))",
    "LINESTRING (0 0, 10 0, 10 10, 3.3 7.1)",
    "MULTILINESTRING ((0 0, 1 1), (2 2, 3 1, 5 5))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (2 2, 4 2, 4 4, 2 4, 2 2))",
    "POLYGON ((0.5 0.5, 60.25 3, 50 50.125, 3 60, 0.5 0.5), (10 10, 20 10, 20 20, 10 20, 10 10))",
    "MULTIPOLYGON (((0 0, 4 0, 4 4, 0 4, 0 0)), ((6 6, 9 6, 9 9, 6 9, 6 6), (7 7, 8 7, 8 8, 7 7)))",
    "GEOMETRYCOLLECTION (POINT (1 1), LINESTRING (0 0, 2 2), POLYGON ((5 5, 6 5, 6 6, 5 5)))",
    "POLYGON EMPTY",
    "POLYGON ((135000 456000, 135100.125 456000, 135100.125 455900.5, 135000 456000))",
]


def _pair(wkt):
    return geometry.from_wkt(wkt), jax_geometry.from_wkt(wkt)


def _same_geometry(port, ref):
    assert type(port).__name__ == type(ref).__name__
    assert port.wkt == ref.wkt
    assert port.wkb == ref.wkb
    assert repr(port.__geo_interface__) == repr(ref.__geo_interface__)  # NaN in empty points


@pytest.mark.parametrize("wkt", WKTS)
def test_wkt_and_wkb_round_trips(wkt):
    port, ref = _pair(wkt)
    _same_geometry(port, ref)
    _same_geometry(geometry.from_wkb(port.wkb), ref)
    _same_geometry(geometry.from_wkt(port.wkt), jax_geometry.from_wkt(ref.wkt))
    _same_geometry(geometry.shape(ref.__geo_interface__), ref)


@pytest.mark.parametrize("wkt", WKTS)
def test_measures_bitwise(wkt):
    port, ref = _pair(wkt)
    assert port.is_empty == ref.is_empty
    if ref.is_empty:
        return
    np.testing.assert_array_equal(np.asarray(port.bounds), np.asarray(ref.bounds))
    assert (port.area, port.length) == (ref.area, ref.length)
    _same_geometry(port.centroid, ref.centroid)
    assert port.is_valid == ref.is_valid
    _same_geometry(port.convex_hull, ref.convex_hull)
    _same_geometry(port.simplify(0.5), ref.simplify(0.5))


@pytest.mark.parametrize("first", WKTS)
def test_predicates_answer_alike(first):
    port_a, ref_a = _pair(first)
    for other in WKTS + ["POLYGON ((-1 -1, 5 -1, 5 5, -1 5, -1 -1))", "POINT (3 3)"]:
        port_b, ref_b = _pair(other)
        for name in ("intersects", "within", "contains", "disjoint", "equals"):
            assert getattr(port_a, name)(port_b) == getattr(ref_a, name)(ref_b), (first, name, other)
        if not (ref_a.is_empty or ref_b.is_empty):
            assert port_a.distance(port_b) == ref_a.distance(ref_b)


def test_box_and_segment_intersection():
    """The vectorised segment test answers as the JAX package's loop."""
    rng = np.random.RandomState(0)
    for _ in range(200):
        coords = np.round(rng.uniform(0, 10, (rng.randint(3, 9), 2)), rng.choice([0, 3]))
        x1, y1 = rng.uniform(0, 8, 2)
        square = (x1, y1, x1 + rng.uniform(0.5, 4), y1 + rng.uniform(0.5, 4))
        line = geometry.LineString(coords)
        ref_line = jax_geometry.LineString(coords)
        assert line.intersects(geometry.box(*square)) == ref_line.intersects(jax_geometry.box(*square))
        assert line.intersects(line) == ref_line.intersects(ref_line)


@pytest.mark.parametrize("src, dst", [("EPSG:28992", "EPSG:3857"), ("EPSG:28992", "EPSG:4326"),
                                      ("EPSG:3857", "EPSG:28992")])
def test_transform_bitwise(src, dst):
    polygon = "POLYGON ((135000 456000, 136000.5 456000, 136000.5 455000.25, 135000 456000), " \
              "(135100 455900, 135200 455900, 135200 455800, 135100 455900))"
    if src != "EPSG:28992":
        polygon = jax_shapely_transform(jax_geometry.from_wkt(polygon), "EPSG:28992", src).wkt
    port, ref = _pair(polygon)
    _same_geometry(shapely_transform(port, src, dst), jax_shapely_transform(ref, src, dst))
    assert shapely_transform(port, src, dst).srs == dst


@pytest.mark.parametrize("operation, module", [
    (lambda g, h: g.intersection(h), "_overlay"),
    (lambda g, h: g.union(h), "_overlay"),
    (lambda g, h: g.difference(h), "_overlay"),
    (lambda g, h: g.buffer(1.0), "_buffer"),
])
def test_overlay_and_buffer_not_ported(operation, module):
    """Both were left out once; now the overlay (geo/_overlay.py) and
    ``buffer`` (geo/_buffer.py) are ported and give the JAX package's
    geometries."""
    pair = geometry.box(0, 0, 1, 1), geometry.box(0.5, -0.5, 2, 0.75)
    expected = operation(jax_geometry.box(0, 0, 1, 1), jax_geometry.box(0.5, -0.5, 2, 0.75))
    if module == "_buffer":
        assert operation(*pair).wkb == expected.wkb
        return
    _same_geometry(operation(*pair), expected)


# --- the feature frame against the JAX package's pandas frames ---

SQUARES = [[(0, 0), (4, 0), (4, 4), (0, 4)], [(6, 1), (9.5, 1), (9.5, 3), (6, 3)],
           [(2, 5), (3, 5), (3, 8.25), (2, 8.25)]]
PROPERTIES = [{"id": 11, "code": 3, "threshold": 1.5, "name": "a"},
              {"id": 12, "code": 7, "threshold": 2.5, "name": "b"},
              {"id": 15, "code": 9, "threshold": 0.5, "name": "c"}]


def _frames(properties=PROPERTIES, projection="EPSG:28992"):
    """(port frame, pandas frame) as MockGeometry builds them."""
    port = GeoDataFrame.from_records(properties)
    port = port.set_geometry(GeoSeries([geometry.Polygon(p) for p in SQUARES], crs=projection))
    ref = JaxGeoDataFrame(pd.DataFrame.from_records(properties))
    ref = ref.set_geometry(JaxGeoSeries([jax_geometry.Polygon(p) for p in SQUARES], crs=projection),
                           crs=projection)
    port.set_index("id", inplace=True)
    ref.set_index("id", inplace=True)
    return port, ref


def _same_frame(port, ref):
    assert len(port) == len(ref)
    assert sorted(port.columns) == sorted(ref.columns)
    assert port.index.name == ref.index.name
    np.testing.assert_array_equal(port.index.values, ref.index.values)
    assert port.crs == ref.crs
    for column in ref.columns:
        if column == "geometry":
            assert [g.wkt for g in port[column]] == [g.wkt for g in ref[column]]
        else:
            assert repr(port[column].tolist()) == repr(ref[column].tolist())  # NaN alike
            if ref[column].dtype != object and ref[column].dtype.kind != "O" \
                    and str(ref[column].dtype) != "str":
                assert port[column].values.dtype == ref[column].values.dtype, column


def test_frame_from_records():
    port, ref = _frames()
    _same_frame(port, ref)
    assert "code" in port and "id" not in port and ("code" in ref) == ("code" in port)
    assert port.copy() is not port
    _same_frame(port.copy(), ref.copy())


def test_frame_columns_set_and_copy():
    port, ref = _frames()
    copy_port, copy_ref = port.copy(), ref.copy()
    for frame in (copy_port, copy_ref):
        frame["agg"] = np.array([1.5, 2.5, np.nan], np.float32)
        frame["zero"] = 0
        frame["nan"] = np.nan
    _same_frame(copy_port, copy_ref)
    _same_frame(port, ref)  # the copies did not touch the originals
    agg = np.arange(6, dtype=np.float32).reshape(2, 3)
    copy_port["series"] = [[x] for x in agg.T]
    copy_ref["series"] = [[x] for x in agg.T]
    for p, r in zip(copy_port["series"].tolist(), copy_ref["series"].tolist()):
        assert isinstance(p, list) and len(p) == 1
        np.testing.assert_array_equal(p[0], r[0])
        assert p[0].dtype == r[0].dtype
    assert copy_port.iloc[1]["series"][0].tolist() == copy_ref.iloc[1]["series"][0].tolist()
    assert copy_port.iloc[0]["agg"] == copy_ref.iloc[0]["agg"]


def test_frame_rows_and_index():
    port, ref = _frames()
    _same_frame(port.iloc[[2, 0]], ref.iloc[[2, 0]])
    _same_frame(port.iloc[[]], ref.iloc[[]])
    mask_port = port.geometry.intersects(geometry.box(3, 0, 7, 4))
    mask_ref = ref.geometry.intersects(jax_geometry.box(3, 0, 7, 4))
    assert mask_port.tolist() == mask_ref.tolist()
    _same_frame(port[mask_port], ref[mask_ref])
    series_port, series_ref = port.index.to_series(), ref.index.to_series()
    assert series_port.tolist() == series_ref.tolist()
    assert series_port.dtype == series_ref.dtype and series_port.name == series_ref.name
    assert series_port.index.values.tolist() == series_ref.index.tolist()
    assert port["threshold"].values.astype("f4").tolist() == ref["threshold"].values.astype("f4").tolist()


def test_geoseries_measures_and_crs():
    port, ref = _frames()
    gp, gr = port.geometry, ref.geometry
    np.testing.assert_array_equal(gp.bounds.values, gr.bounds.values)
    np.testing.assert_array_equal(port.total_bounds, ref.total_bounds)
    assert gp.is_empty.tolist() == gr.is_empty.tolist()
    np.testing.assert_array_equal(gp.centroid.x.values, gr.centroid.x.values)
    np.testing.assert_array_equal(gp.centroid.y.values, gr.centroid.y.values)
    assert [g.wkt for g in gp.iloc[[1, 2]]] == [g.wkt for g in gr.iloc[[1, 2]]]
    moved_port, moved_ref = port.to_crs("EPSG:3857"), ref.to_crs("EPSG:3857")
    _same_frame(moved_port, moved_ref)
    gp.crs = "EPSG:28992"
    gr.crs = "EPSG:28992"
    assert [g.wkt for g in gp.to_crs("EPSG:4326")] == [g.wkt for g in gr.to_crs("EPSG:4326")]


def test_frame_without_properties_and_empty():
    port = GeoDataFrame(geometry=GeoSeries([geometry.Polygon(SQUARES[0])]), crs="EPSG:28992")
    ref = JaxGeoDataFrame(geometry=JaxGeoSeries([jax_geometry.Polygon(SQUARES[0])]),
                          crs="EPSG:28992")
    port.index.name = "id"
    ref.index.name = "id"
    _same_frame(port, ref)
    assert len(GeoDataFrame([])) == len(JaxGeoDataFrame([])) == 0
    assert GeoDataFrame([]).columns == list(JaxGeoDataFrame([]).columns)
    empty = GeoSeries([], crs="EPSG:28992")
    assert len(empty.bounds.values) == 0


@pytest.mark.parametrize("mode", ["intersects", "centroid", "extent"])
@pytest.mark.parametrize("projection", ["EPSG:28992", "EPSG:3857"])
def test_mock_geometry_matches_the_factory(mode, projection):
    """chip_smoke.py's copy of tests/factories.py:MockGeometry, on the
    port's frame, answers as the factory does on pandas."""
    polygons, properties = chip_smoke.make_parcels(4, 2)
    port = chip_smoke.mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    ref = JaxMockGeometry(polygons, properties, projection="EPSG:28992")
    request = chip_smoke.zonal_request(3, projection)
    request = dict(request, mode=mode, geometry=jax_geometry.from_wkt(request["geometry"].wkt))
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = ref.get_data(**request)
    port_request = dict(request, geometry=geometry.from_wkt(request["geometry"].wkt))
    actual = port.get_data(device="cpu", **port_request)
    assert actual["projection"] == expected["projection"]
    if mode == "extent":
        assert actual["extent"] == expected["extent"]
    else:
        _same_frame(actual["features"], expected["features"])
    assert compute_host(*port.get_compute_graph(**port_request)).keys() == actual.keys()


@pytest.mark.parametrize("mode", ["intersects", "centroid", "extent"])
def test_geometry_wkt_source(mode):
    wkt = WKTS[7]
    jax_view = JaxGeometryWKTSource(wkt, "EPSG:28992")
    view = from_reference(jax_view.serialize())
    assert view.columns == jax_view.columns
    for projection, box in [("EPSG:28992", (0, 0, 30, 30)), ("EPSG:3857", (-1e7, -1e7, 1e7, 1e7)),
                            ("EPSG:28992", (100, 100, 200, 200))]:
        request = dict(mode=mode, projection=projection, geometry=jax_geometry.box(*box),
                       min_size=None)
        with jax_config.set({"geomodeling.executor": "numpy"}):
            expected = jax_view.get_data(**request)
        actual = view.get_data(device="cpu", **dict(request, geometry=geometry.box(*box)))
        if mode == "extent":
            assert actual == expected
        else:
            _same_frame(actual["features"], expected["features"])
    with pytest.raises(ValueError):
        type(view)("NOT A WKT", "EPSG:28992")


@pytest.mark.parametrize("other", [
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0))",  # a box
    "POLYGON ((2 2, 2 8, 8 8, 8 2, 2 2))",  # a box, clockwise
    "POLYGON ((0 0, 10 0, 0 10, 0 0))",  # not a box
    "POLYGON ((0 0, 10 0, 10 10, 0 10, 0 0), (4 4, 6 4, 6 6, 4 6, 4 4))",  # a box with a hole
    "POLYGON ((5 5, 5 5, 5 5, 5 5, 5 5))",  # degenerate
])
def test_geoseries_intersects_as_per_geometry(other):
    """GeoSeries.intersects gives the answers of the JAX package's
    per-geometry loop, for boxes and other polygons alike."""
    rng = np.random.RandomState(2)
    wkts = [geometry.box(x, y, x + w, y + h).wkt for x, y, w, h in
            np.round(rng.uniform([-3, -3, 0.5, 0.5], [11, 11, 4, 4], size=(60, 4)), 1)]
    wkts += ["POINT (10 10)", "POINT (10 11)", "LINESTRING (-1 5, 11 5)", "POLYGON EMPTY",
             "POLYGON ((10 0, 12 0, 12 2, 10 2, 10 0))"]
    port = GeoSeries([geometry.from_wkt(w) for w in wkts]).intersects(geometry.from_wkt(other))
    ref = JaxGeoSeries([jax_geometry.from_wkt(w) for w in wkts]).intersects(
        jax_geometry.from_wkt(other))
    assert port.tolist() == ref.tolist()
    assert port.tolist() == [bool(geometry.from_wkt(w).intersects(geometry.from_wkt(other)))
                             for w in wkts]
