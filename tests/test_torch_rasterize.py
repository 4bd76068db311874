"""RasterizeWKT and Rasterize, held on the CPU to the JAX package's numpy
executor bit for bit: RasterizeWKT's numpy process and its crossing-parity
twin (``compute_torch`` and the tile runtime, on CPU tensors), Rasterize's
numpy process as a host node whose per-tile results feed a twin.
"""
from datetime import datetime

import numpy as np
import pytest

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch.raster import Add, Rasterize
from dask_geomodeling_tpu_torch.runtime import executor, tiles
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests
from tests.factories import MockGeometry as JaxMockGeometry


def _star(n, cx, cy, lo, hi, seed):
    rng = np.random.RandomState(seed)
    angles = np.sort(rng.uniform(0, 2 * np.pi, n))
    radii = rng.uniform(lo, hi, n)
    points = ["%r %r" % (float(cx + r * np.cos(t)), float(cy + r * np.sin(t)))
              for t, r in zip(angles, radii)]
    return "(" + ", ".join(points + points[:1]) + ")"


POLYGONS = {
    "square": "POLYGON ((2 2, 30 2, 30 30, 2 30, 2 2))",
    # centres (i + 0.5) fall on these vertices and on the horizontal edges
    "on-centres": "POLYGON ((0.5 0.5, 20.5 0.5, 20.5 10.5, 10.5 10.5, 10.5 20.5, 0.5 20.5, 0.5 0.5))",
    "hole": "POLYGON ((1 1, 60 3, 50 50, 3 60, 1 1), (10 10, 20 10, 20 20, 10 20, 10 10))",
    "multipolygon": "MULTIPOLYGON (((0 0, 16 0, 16 16, 0 16, 0 0)), "
                    "((32 32, 63 32, 63 63, 32 63, 32 32), (40 40, 50 40, 50 50, 40 50, 40 40)))",
    # edges along the tile borders of 32^2 tiles
    "tile-borders": "POLYGON ((0 32, 32 32, 32 0, 64 0, 64 64, 0 64, 0 32))",
    "star": "POLYGON (%s, %s)" % (_star(300, 32, 32, 15, 30, 1), _star(40, 32, 32, 3, 6, 2)),
    "many-vertices": "POLYGON (%s)" % _star(2500, 32, 32, 10, 31, 3),
}


def _request(px=64, width=None, height=None, bbox=(0.0, 0.0, 64.0, 64.0), projection="EPSG:28992"):
    return dict(mode="vals", bbox=bbox, projection=projection, width=width or px,
                height=height or px, start=datetime(1970, 1, 1))


def _jax_numpy(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def _assert_bitwise(actual, expected):
    assert actual["no_data_value"] == expected["no_data_value"]
    assert actual["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(actual["values"], expected["values"])


@pytest.mark.parametrize("name", sorted(POLYGONS))
@pytest.mark.parametrize("request_kwargs", [
    dict(),
    dict(width=61, height=47),
    dict(bbox=(-3.3, 1.7, 70.1, 60.3), width=97, height=83),
])
def test_rasterize_wkt_bitwise(name, request_kwargs):
    jax_view = R.RasterizeWKT(POLYGONS[name], "EPSG:28992")
    view = from_reference(jax_view.serialize())
    request = _request(**request_kwargs)
    expected = _jax_numpy(jax_view, request)
    _assert_bitwise(compute_host(*view.get_compute_graph(**request)), expected)
    runs = executor.host_node_runs
    _assert_bitwise(view.get_data(device="cpu", **request), expected)
    assert executor.host_node_runs == runs  # the twin ran
    assert expected["values"].any() and not expected["values"].all()


@pytest.mark.parametrize("name", ["hole", "tile-borders", "star"])
def test_rasterize_wkt_tiled(name):
    """128^2 over 32^2 tiles in batches of 5 (the last of 1): each tile
    burns its own centres, bitwise to the whole request's numpy answer."""
    jax_view = R.RasterizeWKT(POLYGONS[name], "EPSG:28992")
    view = from_reference(jax_view.serialize())
    request = _request(128)
    expected = _jax_numpy(jax_view, request)
    _assert_bitwise(evaluate_tiled(view, request, tile_size=32, batch=5, device="cpu"), expected)


def test_rasterize_wkt_cross_crs_and_clip():
    """The polygon in EPSG:28992 requested in EPSG:3857, below a Clip."""
    from dask_geomodeling_tpu.geo import Extent

    wkt = "POLYGON ((135010 455990, 135050 455995, 135040 455950, 135005 455960, 135010 455990))"
    bbox = Extent((135000, 455940, 135064, 456004), "EPSG:28992").transformed("EPSG:3857").bbox
    request = _request(64, bbox=bbox, projection="EPSG:3857")
    jax_view = R.RasterizeWKT(wkt, "EPSG:28992")
    view = from_reference(jax_view.serialize())
    _assert_bitwise(view.get_data(device="cpu", **request), _jax_numpy(jax_view, request))
    source = R.MemorySource(data=np.arange(96 * 96, dtype=np.float32).reshape(1, 96, 96),
                            no_data_value=-1.0, projection="EPSG:28992", pixel_size=1.0,
                            pixel_origin=(135000.0, 456004.0), time_first=datetime(1970, 1, 1))
    jax_clip = R.Clip(source, jax_view)
    clip = from_reference(jax_clip.serialize())
    request = _request(64, bbox=(135000, 455940, 135064, 456004))
    expected = _jax_numpy(jax_clip, request)
    _assert_bitwise(clip.get_data(device="cpu", **request), expected)
    _assert_bitwise(evaluate_tiled(clip, request, tile_size=16, batch=3, device="cpu"), expected)


@pytest.mark.parametrize("wkt", ["LINESTRING (0 0, 30 40, 60 10)", "POINT (10.5 20.5)",
                                 "POLYGON EMPTY"])
def test_rasterize_wkt_other_geometries_on_the_host(wkt):
    jax_view = R.RasterizeWKT(wkt, "EPSG:28992")
    view = from_reference(jax_view.serialize())
    request = _request()
    runs = executor.host_node_runs
    _assert_bitwise(view.get_data(device="cpu", **request), _jax_numpy(jax_view, request))
    assert executor.host_node_runs == runs + 1


@pytest.mark.parametrize("point", [(10.0, 10.0), (5.5, 5.5), (100.0, 100.0)])
def test_rasterize_wkt_point_request(point):
    jax_view = R.RasterizeWKT(POLYGONS["hole"], "EPSG:28992")
    view = from_reference(jax_view.serialize())
    request = _request(1, bbox=point * 2)
    _assert_bitwise(view.get_data(device="cpu", **request), _jax_numpy(jax_view, request))


def test_rasterize_wkt_time_and_meta():
    jax_view = R.RasterizeWKT(POLYGONS["square"], "EPSG:28992")
    view = from_reference(jax_view.serialize())
    for mode in ("time", "meta"):
        assert view.get_data(mode=mode) == _jax_numpy(jax_view, dict(mode=mode))
    assert view.extent == jax_view.extent
    assert view.period == jax_view.period
    with pytest.raises(ValueError):
        type(view)("NOT A WKT", "EPSG:28992")


# --- Rasterize ---

SQUARES = [[(1, 1), (20, 1), (20, 20), (1, 20)], [(15.5, 15.5), (40, 15.5), (40, 40), (15.5, 40)],
           [(44, 2), (62, 2), (62, 30), (44, 30)], [(10, 45), (11, 45), (11, 46), (10, 46)]]
PROPERTIES = [
    {"id": 11, "flag": True, "code": 3, "value": 1.5},
    {"id": 12, "flag": False, "code": -7, "value": np.nan},
    {"id": 15, "flag": True, "code": 9, "value": 2.0e6},
    {"id": 21, "flag": True, "code": 2**20, "value": -0.25},
]


def _rasterize_views(column_name, dtype=None, properties=PROPERTIES):
    port_source = chip_smoke.mock_geometry_class()(SQUARES, properties, projection="EPSG:28992")
    jax_source = JaxMockGeometry(SQUARES, properties, projection="EPSG:28992")
    return (Rasterize(port_source, column_name=column_name, dtype=dtype),
            R.Rasterize(jax_source, column_name=column_name, dtype=dtype))


@pytest.mark.parametrize("column_name, dtype", [
    (None, None), ("flag", None), ("code", None), ("code", "int16"), ("value", "float32"),
    ("value", "float16"), ("code", "float64"), ("id", None), ("missing", None),
])
def test_rasterize_bitwise(column_name, dtype):
    view, jax_view = _rasterize_views(column_name, dtype)
    assert view.dtype == jax_view.dtype and view.fillvalue == jax_view.fillvalue
    request = _request()
    expected = _jax_numpy(jax_view, request)
    _assert_bitwise(compute_host(*view.get_compute_graph(**request)), expected)
    _assert_bitwise(view.get_data(device="cpu", **request), expected)
    # a host node whose per-tile results feed the Add twin; each tile asks
    # the source for its own features (a tile no feature reaches burns all
    # nodata, where the whole request burns a boolean column's zeros), so
    # the tiles are held to the numpy executor tile by tile
    before = tiles.batches_run
    tiled = evaluate_tiled(Add(view, 1), request, tile_size=16, batch=6, device="cpu")
    # the source's frames differ per tile, but only Rasterize's pixels
    # feed the twin: 16 tiles in batches of 6
    assert tiles.batches_run - before == 3
    jax_added = R.Add(jax_view, 1)
    for k, tile in enumerate(tile_requests(request, 16)[0]):
        j, i = divmod(k, 4)
        window = tiled["values"][:, 64 - 16 * (j + 1): 64 - 16 * j, 16 * i: 16 * (i + 1)]
        expected_tile = _jax_numpy(jax_added, tile)
        assert tiled["no_data_value"] == expected_tile["no_data_value"]
        assert window.dtype == expected_tile["values"].dtype
        np.testing.assert_array_equal(window, expected_tile["values"])


def test_rasterize_limit_point_and_time():
    view, jax_view = _rasterize_views("code")
    for request in [_request(1, bbox=(15.0, 15.0, 15.0, 15.0)), _request(1, bbox=(70.0,) * 4)]:
        _assert_bitwise(view.get_data(device="cpu", **request), _jax_numpy(jax_view, request))
    limited = Rasterize(view.source, "code", limit=1)
    jax_limited = R.Rasterize(jax_view.source, "code", limit=1)
    _assert_bitwise(limited.get_data(device="cpu", **_request()), _jax_numpy(jax_limited, _request()))
    for mode in ("time", "meta"):
        assert view.get_data(mode=mode) == _jax_numpy(jax_view, dict(mode=mode))
    with pytest.raises(ValueError):
        Rasterize(view.source, "code", limit=-1)


def test_rasterize_empty_source():
    port_source = chip_smoke.mock_geometry_class()([], None, projection="EPSG:28992")
    jax_source = JaxMockGeometry([], None, projection="EPSG:28992")
    request = _request()
    _assert_bitwise(Rasterize(port_source, "code").get_data(device="cpu", **request),
                    _jax_numpy(R.Rasterize(jax_source, "code"), request))
    assert jax_geometry  # the JAX engine builds the factory's polygons
