"""AggregateRaster and AggregateRasterAboveThreshold, held on the CPU to
the JAX package's numpy executor: the port's host path (``compute_host``,
scipy.ndimage as the JAX package calls it) and its device plane
(``get_data``, which hands AggregateRaster the raster as a tensor:
ops/segment.py on CPU tensors).  count, min, max, median and p<q> are
bitwise; sum, mean, std and var within one float32 ulp (the device plane
accumulates in float64 in another order on the card; on the CPU it is
bitwise too); the uncovered features (centroid sampling) are the same.

The cases of tests/test_aggregate_raster.py that read no file, every
statistic over uint8, int32, float32 and float64 rasters with nodata (and
NaN for the floats), overlapping features in several buckets, uncovered
features, multiband output, auto coarsening, a cross-CRS request and an
empty extent.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.geo import geometry as jax_geometry
from dask_geomodeling_tpu.geometry import AggregateRaster as JaxAggregateRaster
from dask_geomodeling_tpu.geometry import AggregateRasterAboveThreshold as JaxAboveThreshold
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.geo import GeoTransform, rasterize_geoseries
from dask_geomodeling_tpu_torch.geo import geometry
from dask_geomodeling_tpu_torch.geometry import AggregateRaster, AggregateRasterAboveThreshold
from dask_geomodeling_tpu_torch.geometry import aggregate
from dask_geomodeling_tpu_torch.geometry.aggregate import bucketize
from dask_geomodeling_tpu_torch.ops.segment import (
    labeled_statistics,
    polygon_edges,
    rasterize_labels,
)
from tests.factories import MockGeometry as JaxMockGeometry

STATISTICS = ["sum", "count", "min", "max", "mean", "median", "std", "var", "p0", "p75", "p100"]
WITHIN_ONE_ULP = ("sum", "mean", "std", "var")
NODATA = {"uint8": 255, "int32": -9999, "float32": float(np.finfo(np.float32).max),
          "float64": -9999.0}
ORIGIN = (135000.0, 456000.0)

# in EPSG:28992, over a 48^2 raster of 1 m cells at ORIGIN: overlapping
# squares (several buckets), a star, a sliver, a tiny square between cell
# centres (uncovered: centroid sampling) and one outside the raster
POLYGONS = [
    [(135002, 455970), (135020, 455970), (135020, 455990), (135002, 455990)],
    [(135010, 455960), (135030, 455960), (135030, 455985), (135010, 455985)],
    [(135015.5, 455965.5), (135016.5, 455965.5), (135016.5, 455966.5), (135015.5, 455966.5)],
    [(135031, 455953), (135046, 455955), (135040, 455967), (135044, 455975), (135032, 455971)],
    [(135003.1, 455955.2), (135003.3, 455955.2), (135003.3, 455955.4), (135003.1, 455955.4)],
    [(135005, 455954), (135025, 455955), (135025, 455955.9), (135005, 455954.8)],
    [(135060, 455900), (135070, 455900), (135070, 455910), (135060, 455910)],
]
PROPERTIES = [{"id": 10 + k, "threshold": t} for k, t in
              enumerate([20.0, 5.5, 0.0, 100.0, 30.0, np.nan, 1.0])]


def _raster(dtype, bands=3, nan=True, seed=0, px=48):
    rng = np.random.RandomState(seed)
    high = 40 if dtype == "uint8" else 200
    data = rng.randint(0, high, size=(bands, px, px)).astype(dtype)
    if dtype.startswith("float"):
        data += rng.rand(bands, px, px).astype(dtype) * 0.5
        if nan:
            data[rng.rand(bands, px, px) < 0.03] = np.nan
    data[rng.rand(bands, px, px) < 0.1] = NODATA[dtype]
    return R.MemorySource(data=data, no_data_value=NODATA[dtype], projection="EPSG:28992",
                          pixel_size=1.0, pixel_origin=ORIGIN, time_first=datetime(2000, 1, 1),
                          time_delta=timedelta(hours=1))


def _request(projection="EPSG:28992", frames=3, box=(135000, 455940, 135048, 456000)):
    from dask_geomodeling_tpu.geo import Extent

    bbox = Extent(box, "EPSG:28992").transformed(projection).bbox
    return dict(mode="intersects", geometry=jax_geometry.box(*bbox), projection=projection,
                start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, frames - 1))


def _port_request(request):
    return dict(request, geometry=geometry.from_wkt(request["geometry"].wkt))


def _views(jax_cls, port_cls, raster, statistic, polygons=POLYGONS, properties=PROPERTIES,
           **kwargs):
    jax_source = JaxMockGeometry(polygons, properties, projection="EPSG:28992")
    port_source = chip_smoke.mock_geometry_class()(polygons, properties, projection="EPSG:28992")
    port_raster = from_reference(raster.serialize())
    return (jax_cls(jax_source, raster, statistic, **kwargs),
            port_cls(port_source, port_raster, statistic, **kwargs))


def _values(frame, column="agg"):
    cells = frame[column].tolist()
    return np.array([np.asarray(c[0] if isinstance(c, list) else [c], np.float64)
                     for c in cells]).reshape(len(cells), -1)


def _assert_same(actual, expected, statistic):
    assert actual["projection"] == expected["projection"]
    a, e = actual["features"], expected["features"]
    assert len(a) == len(e)
    if not len(e):
        return
    assert sorted(a.columns) == sorted(e.columns)
    np.testing.assert_array_equal(a.index.values, e.index.values)
    assert [g.wkt for g in a["geometry"]] == [g.wkt for g in e["geometry"]]
    for column in e.columns:
        if column == "geometry":
            continue
        got, want = _values(a, column), _values(e, column)
        if statistic in WITHIN_ONE_ULP:
            ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
            np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
            assert np.all(np.isnan(want) | (np.abs(got - want) <= ulp)), (column, got, want)
        else:
            np.testing.assert_array_equal(got, want)


@pytest.fixture
def device_plane(monkeypatch):
    """Counts the requests AggregateRaster served on the device plane."""
    calls = []
    original = aggregate._aggregate_on_device

    def spy(*args):
        calls.append(type(args[1]))
        return original(*args)

    monkeypatch.setattr(aggregate, "_aggregate_on_device", spy)
    return calls


def _check(jax_view, view, request, statistic, device_plane, device_used=True):
    device_plane.clear()
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**request)
    port_request = _port_request(request)
    _assert_same(compute_host(*view.get_compute_graph(**port_request)), expected, statistic)
    assert not device_plane
    _assert_same(view.get_data(device="cpu", **port_request), expected, statistic)
    if device_used:
        assert device_plane and all(t is torch.Tensor for t in device_plane)
    return expected


@pytest.mark.parametrize("statistic", STATISTICS)
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "float64"])
def test_every_statistic(dtype, statistic, device_plane):
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, _raster(dtype), statistic)
    expected = _check(jax_view, view, _request(), statistic, device_plane)
    values = _values(expected["features"])
    assert values.shape == (len(POLYGONS) - 1, 3)  # the outside one is not asked for
    assert np.isfinite(values).any()


@pytest.mark.parametrize("statistic", ["count", "sum", "max", "median", "p75", "mean"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_above_threshold(dtype, statistic, device_plane):
    jax_view, view = _views(JaxAboveThreshold, AggregateRasterAboveThreshold, _raster(dtype, seed=1),
                            statistic, threshold_name="threshold")
    _check(jax_view, view, _request(), statistic, device_plane)


@pytest.mark.parametrize("statistic", ["mean", "median", "count", "p75"])
def test_single_frame_and_cross_crs(statistic, device_plane):
    raster = _raster("float32", seed=2)
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, statistic)
    single = _check(jax_view, view, _request(frames=1), statistic, device_plane)
    assert not isinstance(single["features"]["agg"].tolist()[0], list)
    _check(jax_view, view, _request("EPSG:3857"), statistic, device_plane)
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, statistic,
                            projection="EPSG:3857", pixel_size=1.5)
    _check(jax_view, view, _request("EPSG:4326"), statistic, device_plane)


@pytest.mark.parametrize("statistic", ["sum", "count", "mean", "max"])
def test_auto_coarsening(statistic, device_plane):
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, _raster("int32", seed=3), statistic,
                            max_pixels=300, auto_pixel_size=True)
    _check(jax_view, view, _request(), statistic, device_plane)
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, _raster("int32", seed=3), statistic,
                            max_pixels=300)
    with pytest.raises(RuntimeError):
        view.get_data(device="cpu", **_port_request(_request()))


def test_empty_extent_and_empty_source(device_plane):
    raster = _raster("float32")
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, "mean")
    outside = _request(box=(140000, 450000, 140010, 450010))
    _check(jax_view, view, outside, "mean", device_plane, device_used=False)
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, "sum", polygons=[],
                            properties=None)
    _check(jax_view, view, _request(), "sum", device_plane, device_used=False)
    # the extent mode passes the source's through
    extent = dict(_request(), mode="extent")
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_data(**extent)
    assert view.get_data(device="cpu", **_port_request(extent)) == expected


def test_all_nodata_and_out_of_range_time(device_plane):
    data = np.full((2, 48, 48), 255, np.uint8)
    raster = R.MemorySource(data=data, no_data_value=255, projection="EPSG:28992", pixel_size=1.0,
                            pixel_origin=ORIGIN, time_first=datetime(2000, 1, 1),
                            time_delta=timedelta(hours=1))
    for statistic in ("sum", "mean"):
        jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, statistic)
        _check(jax_view, view, _request(frames=2), statistic, device_plane, device_used=False)
        late = dict(_request(), start=datetime(2001, 1, 1), stop=datetime(2001, 1, 2))
        _check(jax_view, view, late, statistic, device_plane, device_used=False)


def test_columns_validation_and_chaining(device_plane):
    raster = _raster("float32", seed=4)
    jax_view, view = _views(JaxAggregateRaster, AggregateRaster, raster, "sum", column_name="zonal")
    assert view.columns == jax_view.columns
    with pytest.raises(ValueError):
        AggregateRaster(view.source, view.raster, statistic="bogus")
    with pytest.raises(TypeError):
        AggregateRaster(view.source, "not a raster")
    with pytest.raises(KeyError):
        AggregateRasterAboveThreshold(view.source, view.raster, threshold_name="missing")
    jax_chained = JaxAggregateRaster(jax_view, raster, "max", column_name="agg2")
    chained = AggregateRaster(view, view.raster, "max", column_name="agg2")
    expected = _check(jax_chained, chained, _request(), "max", device_plane)
    assert {"zonal", "agg2"} <= set(expected["features"].columns)


# --- the device plane alone ---


def _parcels(grid=6, seed=0):
    polygons, _ = chip_smoke.make_parcels(grid, 3, seed=seed)
    return [geometry.Polygon(p) for p in polygons]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("cell", [1.0, 0.7])
def test_label_planes_bitwise_to_the_scanline(seed, cell):
    """Each bucket's label plane, burned from its edges by crossing parity
    and owner, equals the host scanline's rasterize_geoseries labels."""
    from dask_geomodeling_tpu_torch.geo.features import GeoSeries

    geoms = GeoSeries(_parcels(seed=seed), crs="EPSG:28992")
    x0, y0 = chip_smoke.PARCEL_ORIGIN
    size = chip_smoke.PARCEL_CELL * 6
    width = height = int(np.ceil(size / cell))
    bbox = (x0, y0 - height * cell, x0 + width * cell, y0)
    groups = bucketize(geoms.bounds.values)
    assert len(groups) > 1
    fill = int(np.iinfo(np.int32).max)
    labels = aggregate._device_labels(geoms, groups, bbox, "EPSG:28992", height, width, fill,
                                      torch.device("cpu"))
    for plane, group in enumerate(groups):
        burned = rasterize_geoseries(geoms.iloc[group], bbox, "EPSG:28992", height, width,
                                     values=np.asarray(group, dtype=np.int32))
        assert burned["no_data_value"] == fill
        np.testing.assert_array_equal(labels[plane].numpy(), burned["values"][0])


def test_label_planes_with_holes_and_touching_centres():
    """Polygons with holes and vertices on cell centres, in one bucket."""
    shapes = [
        "POLYGON ((0.5 0.5, 10.5 0.5, 10.5 10.5, 0.5 10.5, 0.5 0.5), (3 3, 6 3, 6 6, 3 6, 3 3))",
        "POLYGON ((40.5 40.5, 60 41, 55.5 60.5, 41 55, 40.5 40.5))",
        "MULTIPOLYGON (((0 40, 10 40, 10 50, 0 50, 0 40)), ((0 55, 8 55, 8 63, 0 63, 0 55)))",
    ]
    geoms = [geometry.from_wkt(w) for w in shapes]
    bbox, height, width = (0.0, 0.0, 64.0, 64.0), 64, 64
    starts, ends, owners = polygon_edges(geoms)
    fill = int(np.iinfo(np.int32).max)
    labels = rasterize_labels(starts, ends, owners, np.zeros(len(owners), np.int64), 1,
                              GeoTransform.from_bbox(bbox, height, width), height, width, fill,
                              torch.device("cpu"))
    from dask_geomodeling_tpu_torch.geo.features import GeoSeries

    burned = rasterize_geoseries(GeoSeries(geoms), bbox, "EPSG:28992", height, width,
                                 values=np.arange(3, dtype=np.int32))
    np.testing.assert_array_equal(labels[0].numpy(), burned["values"][0])


@pytest.mark.parametrize("statistic", ["sum", "count", "min", "max", "mean", "median", "std",
                                       "var", "percentile"])
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "float64", "float16"])
def test_labeled_statistics_against_ndimage(dtype, statistic):
    """labeled_statistics on CPU tensors against aggregate_polygons' host
    path on the same labels, frames and nodata (NaN in the floats)."""
    rng = np.random.RandomState(5)
    frames = rng.randint(0, 30, size=(2, 32, 32)).astype(dtype)
    if dtype.startswith("float"):
        frames[rng.rand(2, 32, 32) < 0.05] = np.nan
    nodata = 7
    labels = rng.randint(0, 9, size=(2, 32, 32)).astype(np.int32)
    fill = int(np.iinfo(np.int32).max)
    labels[:, :4] = fill
    labels[1][labels[1] < 5] = fill  # the planes hold disjoint labels
    labels[0][labels[0] >= 5] = fill
    q = 75.0
    reducer = aggregate.STATISTIC_REGISTRY[statistic][0]
    expected = np.full((2, 9), np.nan, np.float32)
    for plane in labels:
        for t, frame in enumerate(frames):
            active = aggregate._masked_frame(frame, nodata, plane, fill, None)
            hit = sorted(set(np.unique(plane[active])))
            if not hit:
                continue
            kwargs = {"qval": q} if statistic == "percentile" else {}
            with np.errstate(invalid="ignore", divide="ignore"):
                expected[t][hit] = reducer(1 if statistic == "count" else frame[active],
                                           labels=plane[active], index=hit, **kwargs)
    got, covered = labeled_statistics(torch.from_numpy(frames), torch.from_numpy(labels), fill,
                                      nodata, None, 9, statistic, q)
    np.testing.assert_array_equal(got.numpy(), expected)
    assert covered.tolist() == [bool((labels == k).any()) for k in range(9)]


# --- tests/test_aggregate_raster.py's request shaping, bucketing and
# scaling cases, the MockRaster as a constant MemorySource ---


def _constant(bands=1, value=1):
    data = np.full((bands, 40, 40), value, np.uint8)
    return R.MemorySource(data=data, no_data_value=255, projection="EPSG:3857", pixel_size=1.0,
                          pixel_origin=(-10.0, 30.0), time_first=datetime(2018, 1, 1),
                          time_delta=timedelta(hours=1))


SHAPING_SQUARE = [((2.0, 2.0), (8.0, 2.0), (8.0, 8.0), (2.0, 8.0))]
SHAPING_REQUEST = dict(mode="intersects", projection="EPSG:3857",
                       geometry=jax_geometry.box(0, 0, 10, 10), start=datetime(2018, 1, 1))


def _shaping_views(polygons=SHAPING_SQUARE, raster=None, statistic="sum", **kwargs):
    properties = [{"id": k + 1} for k in range(len(polygons))] if polygons else None
    jax_source = JaxMockGeometry([list(p) for p in polygons], properties)
    port_source = chip_smoke.mock_geometry_class()([list(p) for p in polygons], properties)
    raster = raster or _constant()
    return (JaxAggregateRaster(jax_source, raster, statistic, **kwargs),
            AggregateRaster(port_source, from_reference(raster.serialize()), statistic, **kwargs))


def _raster_requests(jax_view, view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        expected = jax_view.get_sources_and_requests(**request)[1][1]
    actual = view.get_sources_and_requests(**_port_request(request))[1][1]
    assert actual == expected
    return actual


@pytest.mark.parametrize("kwargs, width", [
    (dict(), 6), (dict(pixel_size=2), 3), (dict(pixel_size=0.5), 12),
    (dict(max_pixels=9, auto_pixel_size=True), 3),
])
def test_raster_request_shaping(kwargs, width, device_plane):
    jax_view, view = _shaping_views(**kwargs)
    raster_request = _raster_requests(jax_view, view, SHAPING_REQUEST)
    np.testing.assert_almost_equal(raster_request["bbox"], (2, 2, 8, 8))
    assert raster_request["width"] == raster_request["height"] == width
    resolution = _raster_requests(jax_view, view, dict(SHAPING_REQUEST, time_resolution=3600000))
    assert resolution["time_resolution"] == 3600000
    _check(jax_view, view, SHAPING_REQUEST, "sum", device_plane)


@pytest.mark.parametrize("bbox", [
    (2.01, 1.99, 7.99, 8.01), (1.99, 2.01, 8.01, 7.99), (2.0, 2.0, 8.0, 8.0), (2.9, 1.1, 8.9, 7.1),
    (2.0, 1.0, 3.0, 2.0), (2.0, 1.1, 3.0, 2.1), (1.1, 1.0, 3.0, 2.0),
])
def test_snap_bbox(bbox, device_plane):
    x1, y1, x2, y2 = bbox
    polygon = ((x1, y1), (x2, y1), (x2, y2), (x1, y2))
    for kwargs in (dict(), dict(max_pixels=20, auto_pixel_size=True)):
        jax_view, view = _shaping_views([polygon], statistic="mean", **kwargs)
        raster_request = _raster_requests(jax_view, view, SHAPING_REQUEST)
        # a one-cell grid is a point request, which the source answers on
        # the host: the host path aggregates it
        one_cell = raster_request["width"] == raster_request["height"] == 1
        _check(jax_view, view, SHAPING_REQUEST, "mean", device_plane, device_used=not one_cell)


def test_pixel_budget_refused():
    jax_view, view = _shaping_views(max_pixels=9)
    with pytest.raises(RuntimeError):
        view.get_sources_and_requests(**_port_request(SHAPING_REQUEST))
    with pytest.raises(RuntimeError):
        view.get_data(device="cpu", **_port_request(SHAPING_REQUEST))


def test_raster_limit_key():
    """``geomodeling.raster-limit`` is the pixel budget of a block that sets
    none, in the port as in the JAX package (tests/test_aggregate_raster.py:
    test_raster_limit_fallback): 9 px refuse the 36 px grid, and with
    auto_pixel_size coarsen it to the JAX package's request."""
    from dask_geomodeling_tpu_torch.config import config as port_config

    limit = {"geomodeling.raster-limit": 9}
    jax_view, view = _shaping_views()
    with jax_config.set(limit), port_config.set(limit):
        with pytest.raises(RuntimeError):
            with jax_config.set({"geomodeling.executor": "numpy"}):
                jax_view.get_sources_and_requests(**SHAPING_REQUEST)
        with pytest.raises(RuntimeError):
            view.get_sources_and_requests(**_port_request(SHAPING_REQUEST))
        raster_request = _raster_requests(*_shaping_views(auto_pixel_size=True),
                                          SHAPING_REQUEST)
    assert raster_request["width"] == raster_request["height"] == 3
    assert port_config.get("geomodeling.raster-limit") == 12 * 1024**2
    assert _raster_requests(*_shaping_views(auto_pixel_size=True),
                            SHAPING_REQUEST)["width"] == 6


@pytest.mark.parametrize("statistic", ["sum", "mean"])
def test_extensive_and_intensive_scaling(statistic, device_plane):
    fine = _shaping_views(statistic=statistic)
    coarse = _shaping_views(statistic=statistic, pixel_size=0.1, max_pixels=6**2,
                            auto_pixel_size=True)
    results = [_check(*views, SHAPING_REQUEST, statistic, device_plane) for views in (fine, coarse)]
    agg = [r["features"].iloc[0]["agg"] for r in results]
    assert agg[1] == (agg[0] * 100 if statistic == "sum" else agg[0])


def test_different_projection(device_plane):
    jax_view, view = _shaping_views(statistic="mean", projection="EPSG:3857")
    request = dict(SHAPING_REQUEST, projection="EPSG:4326",
                   geometry=jax_geometry.box(-180, -85, 180, 85))
    assert _raster_requests(jax_view, view, request)["projection"] == "EPSG:3857"
    result = _check(jax_view, view, request, "mean", device_plane)
    assert result["projection"] == "EPSG:4326"


def test_time_frames(device_plane):
    raster = _constant(bands=3)
    jax_view, view = _shaping_views(raster=raster, statistic="mean")
    start, stop = datetime(2018, 1, 1), datetime(2018, 1, 1, 2)
    three = _check(jax_view, view, dict(SHAPING_REQUEST, start=start, stop=stop), "mean",
                   device_plane)
    assert len(three["features"].iloc[0]["agg"][0]) == 3
    _check(jax_view, view, dict(SHAPING_REQUEST, start=start, stop=None), "mean", device_plane)
    late = dict(SHAPING_REQUEST, start=start + timedelta(days=1), stop=stop + timedelta(days=1))
    _check(jax_view, view, late, "mean", device_plane, device_used=False)


def test_chained_aggregation(device_plane):
    jax_first, first = _shaping_views()
    raster2 = _constant(value=7)
    jax_chained = JaxAggregateRaster(jax_first, raster2, "mean", column_name="agg2")
    chained = AggregateRaster(first, from_reference(raster2.serialize()), "mean",
                              column_name="agg2")
    result = _check(jax_chained, chained, SHAPING_REQUEST, "mean", device_plane)
    assert (result["features"].iloc[0]["agg"], result["features"].iloc[0]["agg2"]) == (36.0, 7.0)


def test_empty_dataset(device_plane):
    jax_view, view = _shaping_views(polygons=[])
    _check(jax_view, view, SHAPING_REQUEST, "sum", device_plane, device_used=False)


@pytest.mark.parametrize("bboxes", [
    [(0, 0, 2, 2), (10, 10, 12, 12)],
    [(0, 0, 2, 2), (1, 1, 3, 3)],
    [tuple(o) + tuple(o + 1) for o in np.random.RandomState(0).rand(50, 2) * 100],
    [(5.0, 5.0, 5.0, 5.0), (0.0, 0.0, 2.0, 2.0), (5.0, 5.0, 5.0, 5.0)],
])
def test_bucketize_as_the_reference(bboxes):
    from dask_geomodeling_tpu.geometry.aggregate import bucketize as jax_bucketize

    assert bucketize(bboxes) == jax_bucketize(bboxes)
    assert sorted(sum(bucketize(bboxes), [])) == list(range(len(bboxes)))


def test_extent_resolves_no_device_and_cuda_without_a_card_raises():
    """An extent request runs on the host with no device named; any other
    request on the default device (the card) raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: the default device does not raise")
    jax_view, view = _shaping_views()
    request = _port_request(SHAPING_REQUEST)
    assert view.get_data(**dict(request, mode="extent"))["extent"] == (2.0, 2.0, 8.0, 8.0)
    with pytest.raises(RuntimeError, match="cuda"):
        view.get_data(**request)
