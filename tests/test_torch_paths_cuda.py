"""The raster-algebra, temporal and geometry paths and the executor fuzz
on the card.

Card-only (``cuda``-marked; they skip without a card): chip_smoke.py's
five raster-algebra paths, three temporal paths and two tiled geometry
paths (rasterize-wkt, rasterize) at 1024^2 in 256^2 tiles, on the card
against the same run on the CPU (bitwise, or within the bilinear path's
tolerance) and against compute_host on sampled tiles; the zonal views
over a 1024^2 raster (4 frames) against compute_host (count, max,
median, p90 bitwise; sum and mean within one float32 ulp), with the
label planes bitwise to the host scanline's;
every TemporalAggregate statistic, TemporalSum and Cumulative over a small
source on the card against compute_host; the fuzz's trees on the card
against compute_host; the float64 discrete ops; the building-heights
export of 400 footprints over a 1024^2 sheet against the CPU, and
chip_smoke's building-heights phase at that size; the wms-serving GetMaps of both
layers against the CPU, the phase at small size and the launch counters
under eight threads; the auto-routing phase over a small sheet and a
512^2 headline source; the building-rings export of the footprints
inside a 256 m square against the CPU, and its phase at that size.  This file imports nothing
of JAX or pandas, so it runs where neither is installed.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

import chip_smoke
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch import raster as R
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

PATHS = ["elemwise", "reclassify-chain", "combine", "place", "reproject-bilinear"]
TEMPORAL_PATHS = ["temporal-mean", "temporal-median", "temporal-cumulative"]
GEOMETRY_PATHS = ["rasterize-wkt", "rasterize"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def paths():
    return dict(chip_smoke.build_algebra_paths(1024),
                **chip_smoke.build_temporal_paths(mean_px=1024, px=1024)[0],
                **chip_smoke.build_geometry_paths(px=1024, rasterize_px=1024, parcels_grid=8))


@pytest.mark.cuda
@pytest.mark.parametrize("label", PATHS + TEMPORAL_PATHS + GEOMETRY_PATHS)
def test_path_on_card_equals_cpu_and_host(paths, label):
    device = _card()
    view, request, interpolation, _ = paths[label]
    with config.set({"geomodeling.warp-interpolation": interpolation}):
        card = evaluate_tiled(view, request, tile_size=256, batch=4, device=device)["values"]
        cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")["values"]
        tile = dict(request, width=256, height=256, bbox=(
            request["bbox"][0], request["bbox"][3] - (request["bbox"][3] - request["bbox"][1]) / 4,
            request["bbox"][0] + (request["bbox"][2] - request["bbox"][0]) / 4, request["bbox"][3]))
        host = compute_host(*view.get_compute_graph(**tile))["values"]
    if interpolation == "nearest":
        np.testing.assert_array_equal(card, cpu)
        np.testing.assert_array_equal(card[:, :256, :256], host)
    else:
        np.testing.assert_allclose(card, cpu, rtol=0, atol=chip_smoke.BILINEAR_ATOL)
        np.testing.assert_allclose(card[:, :256, :256], host, rtol=0, atol=chip_smoke.BILINEAR_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("seed", list(chip_smoke.FUZZ_SEEDS) + list(chip_smoke.FUZZ_TILED_SEEDS))
def test_fuzz_on_card(seed):
    device = _card()
    view, request = chip_smoke.fuzz_view(seed, chip_smoke.fuzz_sources())
    expected = compute_host(*view.get_compute_graph(**request))
    if seed in chip_smoke.FUZZ_TILED_SEEDS:
        actual = evaluate_tiled(view, request, tile_size=6, batch=2, device=device)
        actual["no_data_value"] = expected["no_data_value"]
    else:
        actual = view.get_data(device=device, **request)
    assert chip_smoke.same_as_host(actual, expected)


@pytest.mark.cuda
def test_float64_discrete_ops_on_card():
    assert chip_smoke.check_f64_discrete(_card()) > 40


def _hourly(dtype, frames=30, seed=6):
    """A small hourly source of ``dtype`` from 2000-03-25, a third of its
    cells nodata."""
    nodata = {"uint8": 255, "int32": -2147483648, "float32": float(np.finfo(np.float32).max)}
    rng = np.random.RandomState(seed)
    data = np.round(rng.rand(frames, 24, 20) * 200).astype(dtype)
    data[rng.rand(*data.shape) < 0.3] = nodata[dtype]
    return R.MemorySource(data=data, no_data_value=nodata[dtype], projection="EPSG:28992",
                          pixel_size=1.0, pixel_origin=(135000.0, 456000.0),
                          time_first=datetime(2000, 3, 25), time_delta=timedelta(hours=1))


SMALL = dict(mode="vals", bbox=(135000.0, 455976.0, 135020.0, 456000.0), projection="EPSG:28992",
             width=20, height=24, start=datetime(2000, 3, 25), stop=datetime(2000, 3, 27))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("statistic", ["sum", "count", "min", "max", "mean", "median", "std",
                                       "var", "p0", "p50", "p90", "p100"])
def test_temporal_aggregate_on_card(dtype, statistic):
    """Bitwise: the card's float64 square root is correctly rounded."""
    device = _card()
    view = R.TemporalAggregate(_hourly(dtype), "6h", statistic=statistic,
                               timezone="Europe/Amsterdam")
    expected = compute_host(*view.get_compute_graph(**SMALL))
    actual = view.get_data(device=device, **SMALL)
    assert actual["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(actual["values"], expected["values"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32"])
@pytest.mark.parametrize("make", [
    lambda s: R.TemporalSum(s),
    lambda s: R.Cumulative(s, statistic="sum", frequency="D", timezone="Europe/Amsterdam"),
    lambda s: R.Cumulative(s, statistic="count", frequency="3h"),
    lambda s: R.Cumulative(s, statistic="sum"),
])
def test_temporal_sum_and_cumulative_on_card(dtype, make):
    device = _card()
    view = make(_hourly(dtype))
    expected = compute_host(*view.get_compute_graph(**SMALL))
    actual = view.get_data(device=device, **SMALL)
    assert actual["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(actual["values"], expected["values"])


@pytest.fixture(scope="module")
def zonal_views():
    """build_zonal_views over 10 x 10 parcels (and 4 small) inside a
    1024^2 source of 4 hourly frames, with 5% nodata."""
    original = chip_smoke.PARCEL_ORIGIN
    chip_smoke.PARCEL_ORIGIN = (135100.0, 455900.0)
    try:
        source = chip_smoke.make_source(1024, seed=1, bands=4, nodata_share=0.05)
        raster = R.TemporalAggregate(source, "2h", statistic="mean")
        return chip_smoke.build_zonal_views(raster, grid=10, small=4)
    finally:
        chip_smoke.PARCEL_ORIGIN = original


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mean", "median", "p90", "max", "sum", "count-above",
                                  "mean-3857"])
def test_zonal_on_card(zonal_views, name):
    device = _card()
    view, request = zonal_views[name]
    actual = view.get_data(device=device, **request)
    expected = compute_host(*view.get_compute_graph(**request))
    differing, beyond, cells = chip_smoke.compare_zonal(name, actual, expected)
    assert beyond == 0
    if name in chip_smoke.ZONAL_EXACT:
        assert differing == 0
    assert cells >= 2 * 100


@pytest.mark.cuda
def test_zonal_label_planes_on_card(zonal_views):
    """The label planes and the covered set of the mean request, on the
    card, bitwise to the host scanline's."""
    from dask_geomodeling_tpu_torch.geo import rasterize_geoseries

    device = _card()
    view, request = zonal_views["mean"]
    _, labels, covered, shape, geometries, groups, plan, _ = chip_smoke.zonal_phases(
        view, request, device)
    _, height, width = shape
    host_covered = np.zeros(len(geometries), bool)
    for plane, group in enumerate(groups):
        burned = rasterize_geoseries(geometries.iloc[group], plan["agg_bbox"], plan["agg_srs"],
                                     height, width, values=np.asarray(group, dtype=np.int32))
        host = burned["values"][0]
        np.testing.assert_array_equal(labels[plane].cpu().numpy(), host)
        host_covered[np.unique(host[host != burned["no_data_value"]])] = True
    np.testing.assert_array_equal(covered, host_covered)
    assert not covered.all() and len(groups) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("statistic", ["sum", "count", "min", "max", "mean", "median", "std",
                                       "var", "percentile"])
@pytest.mark.parametrize("dtype", ["uint8", "int32", "float32", "float64"])
def test_labeled_statistics_on_card(dtype, statistic):
    """ops/segment.py:labeled_statistics on the card against the CPU:
    bitwise but for the float64 atomic sums (within one float32 ulp)."""
    from dask_geomodeling_tpu_torch.ops.segment import labeled_statistics

    device = _card()
    rng = np.random.RandomState(7)
    frames = rng.randint(0, 50, size=(3, 256, 256)).astype(dtype)
    if dtype.startswith("float"):
        frames += rng.rand(3, 256, 256).astype(dtype)
        frames[rng.rand(3, 256, 256) < 0.02] = np.nan
    labels = rng.randint(0, 40, size=(1, 256, 256)).astype(np.int32)
    fill = int(np.iinfo(np.int32).max)
    labels[rng.rand(1, 256, 256) < 0.2] = fill
    cpu, cpu_covered = labeled_statistics(torch.from_numpy(frames), torch.from_numpy(labels), fill,
                                          7, None, 40, statistic, 90.0)
    card, card_covered = labeled_statistics(torch.from_numpy(frames).to(device),
                                            torch.from_numpy(labels).to(device), fill, 7, None, 40,
                                            statistic, 90.0)
    assert torch.equal(card_covered.cpu(), cpu_covered)
    card, cpu = card.cpu().numpy().astype(np.float64), cpu.numpy().astype(np.float64)
    if statistic in ("sum", "mean", "std", "var"):
        ulp = np.spacing(np.abs(cpu).astype(np.float32)).astype(np.float64)
        assert np.all((np.isnan(cpu) & np.isnan(card)) | (np.abs(card - cpu) <= ulp))
    else:
        np.testing.assert_array_equal(card, cpu)


# --- the file paths: a 1024^2 sheet read window by window ---

FILE_LIMIT = {"geomodeling.windowed-read-limit": 100_000}


@pytest.fixture(scope="module")
def file_paths(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("sheet"))
    sheet = chip_smoke.write_sheet(folder, width=1024, height=1024, block=120)
    return folder, chip_smoke.build_file_paths(sheet, reproject_px=512)


def _tiles_against_host(view, request, values, tile):
    tiles, nx = tile_requests(request, tile)
    for index in (0, len(tiles) // 2, len(tiles) - 1):
        (rows, cols), (host_rows, host_cols) = chip_smoke.tile_cells(
            index, nx, request["width"], request["height"], tile)
        host = compute_host(*view.get_compute_graph(**tiles[index]))["values"]
        np.testing.assert_array_equal(values[:, rows, cols], host[:, host_rows, host_cols])


@pytest.mark.cuda
@pytest.mark.parametrize("label", ["file-read", "file-reproject"])
def test_file_path_on_card(file_paths, label):
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime

    device = _card()
    _, paths = file_paths
    view, request, _, _ = paths[label]
    with config.set(FILE_LIMIT):
        assert view.store._file_read_plan(request) is not None
        cuda_stencils.reset_launches()
        before = tile_runtime.batches_run
        card = evaluate_tiled(view, request, tile_size=256, batch=4, device=device)["values"]
        batches = tile_runtime.batches_run - before
        assert cuda_stencils.launches == batches
        cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")["values"]
        np.testing.assert_array_equal(card, cpu)
        if label == "file-read":
            assert batches == 4  # 16 tiles as a MemorySource's: no tile in a batch of its own
            _tiles_against_host(view, request, card, 256)


@pytest.mark.cuda
def test_file_export_on_card(file_paths, tmp_path):
    import os

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    device = _card()
    _, paths = file_paths
    view, request, _, _ = paths["file-read"]
    with config.set(FILE_LIMIT):
        cuda_stencils.reset_launches()
        view.to_file(str(tmp_path / "card" / "out.vrt"), tile_size=384, device=device)
        assert cuda_stencils.launches == 9  # one per subrequest
        view.to_file(str(tmp_path / "cpu" / "out.vrt"), tile_size=384, device="cpu")
        names = sorted(os.listdir(tmp_path / "card" / "tiles"))
        assert len(names) == 9 and names == sorted(os.listdir(tmp_path / "cpu" / "tiles"))
        for name in names:
            with open(tmp_path / "card" / "tiles" / name, "rb") as f, \
                    open(tmp_path / "cpu" / "tiles" / name, "rb") as g:
                assert f.read() == g.read(), name
        mosaic = RasterFileSource(str(tmp_path / "card" / "out.vrt"))
        read_back = mosaic.get_data(device=device, **request)["values"]
        assert read_back.shape == (1, 1024, 1024)
        cpu_back = mosaic.get_data(device="cpu", **request)["values"]
        np.testing.assert_array_equal(read_back, cpu_back)


# --- building-heights at small size ---


@pytest.fixture(scope="module")
def buildings(file_paths):
    """A 1024^2 sheet and 400 footprints over it (chip_smoke's builders)."""
    folder, paths = file_paths
    sheet = paths["file-read"][0].store.url
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    bbox = RasterFileSource(sheet).footprint.bbox
    path = chip_smoke.write_buildings(folder, bbox, 400)
    return chip_smoke.build_buildings_view(path, sheet)


def _heights(path):
    from dask_geomodeling_tpu_torch.io.vectorfile import read_vector

    return chip_smoke.frame_rows(read_vector(path))


@pytest.mark.cuda
@pytest.mark.parametrize("ext", ["gpkg", "geojson", "shp"])
def test_building_heights_on_card(buildings, tmp_path, ext):
    """The export on the card against the same export on the CPU: the
    same rows, h_mean within one float32 ulp before rounding (float64
    atomics), one Gaussian launch per tile."""
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    device = _card()
    request = dict(tile_size=128.0, projection="EPSG:28992", mode="centroid")
    cuda_stencils.reset_launches()
    to_file(buildings, str(tmp_path / ("card." + ext)), device=device, **request)
    assert cuda_stencils.launches == 16  # 512 m x 512 m in 128 m tiles
    to_file(buildings, str(tmp_path / ("cpu." + ext)), device="cpu", **request)
    card, cpu = _heights(str(tmp_path / ("card." + ext))), _heights(str(tmp_path / ("cpu." + ext)))
    assert len(card) > 300
    # a rounded h_mean may flip where the card's float64 atomics put the
    # mean one float32 ulp from the CPU's: allowed as a difference of 0.01
    differ = chip_smoke.compare_heights("card", card, cpu, lambda fids: [
        0 if abs(card[f]["h_mean"] - cpu[f]["h_mean"]) <= 0.0100001 else 2 for f in fids])
    assert len(differ) <= 2


@pytest.mark.cuda
def test_building_heights_phase_on_card(file_paths, tmp_path):
    """chip_smoke's phase at small size: every check of the full run."""
    device = _card()
    folder, paths = file_paths
    sheet = paths["file-read"][0].store.url
    launches, numbers = chip_smoke.check_buildings("card", device, str(tmp_path), sheet,
                                                   count=400, tile=128.0, sub_size=200.0)
    assert launches["gaussian_blur"] == numbers["tiles"] == 16


# --- wms-serving at small size ---


@pytest.fixture(scope="module")
def wms_sheet(tmp_path_factory):
    """A 1200 x 1500 sheet (600 m x 750 m: 12 XYZ tiles of zooms 14-16),
    read window by window."""
    folder = str(tmp_path_factory.mktemp("wms"))
    return chip_smoke.write_sheet(folder, width=1200, height=1500, block=60)


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["ahn-smooth", "ahn-hillshade"])
def test_getmap_on_card_equals_cpu(wms_sheet, layer):
    """A 256^2 GetMap of each layer on the card against the same tile on
    the CPU: the values within the limits outside the reach of a differing
    warped source cell, and every pixel whose value agrees coloured alike."""
    from dask_geomodeling_tpu_torch.io.png import decode_png_bytes
    from dask_geomodeling_tpu_torch.ipyleaflet_plugin import render_wms_tile

    device = _card()
    view, style, vmin, vmax = chip_smoke.wms_layers(wms_sheet)[layer]
    tiles = chip_smoke.xyz_tiles(view.footprint.transformed("EPSG:3857").bbox)
    with config.set({"geomodeling.windowed-read-limit": 10**5}):
        for tile in [t for t in tiles if t[0] == 16][:3]:
            params = {k.lower(): v for k, v in chip_smoke.getmap_params(
                layer, style, vmin, vmax, tile).items()}
            params["layers"] = view.to_json()
            request = chip_smoke.tile_request(tile)
            card = view.get_data(device=device, **request)["values"][0]
            cpu = view.get_data(device="cpu", **request)["values"][0]
            reach, share = chip_smoke.wms_source_reach(view, request, device)
            ok, _, outside = chip_smoke.wms_within_limits(layer, card, cpu, reach)
            assert share <= chip_smoke.HEADLINE_SHARE and ok, outside
            with config.set({"geomodeling.torch-device": "cpu"}):
                cpu_png = render_wms_tile(params)
            card_png = render_wms_tile(params)
            pixels = (decode_png_bytes(card_png)[0] != decode_png_bytes(cpu_png)[0]).any(axis=0)
            assert not (pixels & (card == cpu)).any()


@pytest.mark.cuda
def test_wms_serving_phase_on_card(wms_sheet):
    """chip_smoke's phase at small size: every check of the full run, the
    four-thread render included."""
    device = _card()
    with config.set({"geomodeling.windowed-read-limit": 10**5}):
        launches, numbers = chip_smoke.check_wms_serving("card", device, wms_sheet, sample=8)
    assert launches["gaussian_blur"] == numbers["tiles_per_layer"] == 12
    assert launches["moving_max"] == 0
    assert numbers["gaussian_launches"]["hit"] == 0
    assert not any(numbers["moving_max_launches"].values())
    assert set(numbers["in_process"]["ahn-smooth"]) >= {"card", "host"}
    assert numbers["threaded"] == (24, 12)


# --- auto-routing and building-rings at small size ---


@pytest.mark.cuda
def test_auto_routing_phase_on_card(wms_sheet, tmp_path):
    """chip_smoke's auto-routing phase over the small sheet and a 512^2
    headline source, edges 64 to 512: both routes taken, Gaussians only on
    card routes, every card-routed answer within its limits, the settled
    routes after a reseed, a non-empty trace."""
    device = _card()
    source, view = chip_smoke.build_headline_view(512)
    request = chip_smoke.headline_request(source, 1024)
    with config.set({"geomodeling.windowed-read-limit": 10**5}):
        launches, numbers = chip_smoke.check_auto_routing(
            "card", device, str(tmp_path), wms_sheet, view, request, edges=(64, 128, 256, 512),
            per_edge=6)
    assert numbers["routes"]["numpy"] > 0 and numbers["routes"]["torch"] > 0
    assert launches["gaussian_blur"] > 0 and launches["moving_max"] == 0
    assert numbers["trace_bytes"] > 0
    assert config.get("geomodeling.executor") == "torch"


@pytest.mark.cuda
def test_building_rings_on_card_equals_cpu(file_paths, tmp_path):
    """The rings export on the card against the same export on the CPU:
    the same rows, the rounded means within one float32 ulp before
    rounding (float64 atomics), two Gaussian launches a tile."""
    from dask_geomodeling_tpu_torch.geo.geometry import box
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    device = _card()
    _, paths = file_paths
    sheet = paths["file-read"][0].store.url
    bbox = RasterFileSource(sheet).footprint.bbox
    area = chip_smoke.rings_area(bbox, 256.0)
    rings, count = chip_smoke.write_rings_buildings(str(tmp_path), bbox, area, 400)
    view = chip_smoke.build_rings_view(rings, sheet)
    fields = {name: name for name in chip_smoke.RINGS_FIELDS}
    request = dict(tile_size=128.0, projection="EPSG:28992", mode="centroid",
                   geometry=box(*area), fields=fields)
    cuda_stencils.reset_launches()
    to_file(view, str(tmp_path / "card.gpkg"), device=device, **request)
    assert cuda_stencils.launches == 2 * 4
    to_file(view, str(tmp_path / "cpu.gpkg"), device="cpu", **request)
    card, cpu = _heights(str(tmp_path / "card.gpkg")), _heights(str(tmp_path / "cpu.gpkg"))
    assert len(card) == count > 50
    differ = chip_smoke.compare_heights("card", card, cpu, lambda fids: [
        0 if all(abs(card[f][k] - cpu[f][k]) <= 0.0100001 for k in ("ring_mean", "h_mean"))
        else 2 for f in fids], chip_smoke.RINGS_ROUNDED)
    assert len(differ) <= 2


@pytest.mark.cuda
def test_building_rings_phase_on_card(file_paths, tmp_path):
    """chip_smoke's phase at small size: every check of the full run."""
    device = _card()
    _, paths = file_paths
    sheet = paths["file-read"][0].store.url
    launches, numbers = chip_smoke.check_building_rings(
        "card", device, str(tmp_path), sheet, side=256.0, tile=128.0, sub_size=80.0, count=400)
    assert numbers["tiles"] == 4
    assert launches["gaussian_blur"] == 2 * numbers["tiles"]
    assert launches["moving_max"] == 0


@pytest.mark.cuda
def test_launch_counters_exact_under_threads():
    """Eight threads launch both kernels at once, from a fresh start of
    their first calls: every launch is counted, and each result equals its
    plain version."""
    import threading

    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.ops.stencils import (
        gaussian_blur_reference, moving_max_reference)

    device = _card()
    planes = torch.rand(2, 270, 270, device=device)
    want_blur = gaussian_blur_reference(planes, 1.3, 1.3, 0)
    want_max = moving_max_reference(planes, 3)
    cuda_stencils.reset_launches()
    failures = []
    start = threading.Barrier(8)

    def work():
        start.wait()
        for _ in range(50):
            if not torch.equal(cuda_stencils.gaussian_blur(planes, 1.3, 1.3, 0), want_blur):
                failures.append("gaussian_blur")
            if not torch.equal(cuda_stencils.moving_max(planes, 3), want_max):
                failures.append("moving_max")
        torch.cuda.synchronize()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()
    assert not failures
    assert cuda_stencils.launches == cuda_stencils.fused_launches == 400
    assert cuda_stencils.moving_max_launches == 400
