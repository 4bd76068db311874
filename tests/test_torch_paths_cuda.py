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
inside a 256 m square against the CPU, and its phase at that size; the
building-formats phase over 400 footprints (16 GML tiles, the square's
nine formats) and each format's view on the card against the CPU; the
border-reproject view (a 512^2 EPSG:25832 source through JSON, 1024^2 in
EPSG:28992) and each crs-families view at 256^2 against the CPU, the
crs-families phase with its NTv2 request at that size, the Cumulative
nestings and the integer JSON phase; the dem-formats view at 512^2 over
an int16 SRTM tile against the CPU and compute_host, and the phase over a
1441^2 tile; the zarr-store phase over the 1024^2 sheet; the netcdf-radar
phase over a small radar file; the hfa-roughness and tile-pyramids phases over a 1024 x 768
land-use grid; the modis-ndvi phase over a 960^2 HDF4 tile; the grib-forecast phase over
320 x 75 points and six hourly GRIB2 fields; the parcel-imagery phase over a 512^2 NITF
scene and 256 FlatGeobuf parcels; the lzw-sheet phase over the 1024^2 sheet as LZW and a
1024 x 768 land use as PackBits, with two host-pool workers; uint16, uint32 and uint64
sources warped on the card.
This file imports nothing of JAX or pandas, so it runs where neither is installed.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

import chip_smoke
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch import raster as R
from dask_geomodeling_tpu_torch.geo import Extent
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


@pytest.mark.cuda
def test_zarr_store_phase_on_card(file_paths, tmp_path):
    """chip_smoke's zarr-store phase over the 1024^2 sheet as a store of
    512^2 chunks, the limit lowered: 4 tiles read by window, every check of
    the full run (the to_zarr sub-area 512^2, read back by window)."""
    import os

    device = _card()
    folder, paths = file_paths
    view, request, _, _ = paths["file-read"]
    with config.set(FILE_LIMIT):
        read_values = evaluate_tiled(view, request, tile_size=chip_smoke.TILE,
                                     batch=chip_smoke.BATCH, device=device)["values"]
        launches, numbers = chip_smoke.check_zarr_store(
            "card", device, str(tmp_path), os.path.join(folder, "sheet.tif"),
            paths["file-read"], read_values, sub_px=512, sampled_tiles=4)
    assert launches["gaussian_blur"] >= 3  # the run, get_data's run and the to_zarr request
    assert numbers["tiles"] == 4 and numbers["plan_split_s"]["whole reads"] == 0.0


@pytest.mark.cuda
def test_netcdf_radar_phase_on_card(tmp_path):
    """chip_smoke's netcdf-radar phase over 36 frames of a 120^2 radar grid,
    1024^2 of 100 m in 256^2 tiles: every check of the full run (the
    windowed run under a limit of 1000 cells, the 256^2 export)."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        launches, numbers, (planes, sigma) = chip_smoke.check_netcdf_radar(
            "card", device, str(tmp_path), records=36, size=120, px=1024, hours=(0, 3),
            window_limit=1000, sampled_tiles=4, export_px=256)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 2 and launches["moving_max"] == 0
    assert numbers["tiles"] == 16 and planes == (24, 256, 256)
    assert numbers["export_err"] <= chip_smoke.RADAR_SCALE / 2 * 1.001


@pytest.mark.cuda
def test_hfa_roughness_phase_on_card(tmp_path):
    """chip_smoke's hfa-roughness phase over a 1024 x 768 land-use grid in
    256^2 tiles, batches of 8: every check of the full run."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        launches, numbers, kernel, lgn = chip_smoke.check_hfa_roughness(
            "card", device, str(tmp_path), width=1024, height=768, sampled_tiles=4)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 2 and launches["moving_max"] == 0
    assert numbers["tiles"] == 12 and 0 < numbers["rle_blocks"] < numbers["blocks"] == 192
    assert kernel["shape"] == [8, 266, 266] and kernel["max_abs_err"] == 0.0  # a 5 px margin
    assert lgn["classes"].shape == (768, 1024) and lgn["values"].shape == (1, 768, 1024)


@pytest.mark.cuda
def test_tile_pyramids_phase_on_card(tmp_path):
    """chip_smoke's tile-pyramids phase after hfa-roughness over a 1024 x
    768 land-use grid in 256^2 tiles, batches of 8: every check of the
    full run, the GeoPackage's answer equal to the .img's."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        lgn = chip_smoke.check_hfa_roughness(
            "card", device, str(tmp_path), width=1024, height=768, sampled_tiles=4)[3]
        launches, numbers = chip_smoke.check_tile_pyramids(
            "card", device, str(tmp_path), lgn, sampled_tiles=4)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 4 and launches["moving_max"] == 0
    assert numbers["batches_run"] >= 4 and numbers["gpkg_mb"] > 0 < numbers["mbtiles_mb"]
    assert lgn == {}  # the classes and the answer taken once used


@pytest.mark.cuda
def test_modis_ndvi_phase_on_card(tmp_path):
    """chip_smoke's modis-ndvi phase over a 960^2 tile in 96^2 chunks, in
    256^2 tiles, batches of 8, read by window under a limit of 10,000
    cells, (b) over a 512^2 box of RD New: every check of the full run."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        launches, numbers = chip_smoke.check_modis_ndvi(
            "card", device, str(tmp_path), size=960, chunk=96, window_limit=10000,
            rd_bbox=(100000.0, 400000.0, 151200.0, 451200.0), sampled_tiles=4)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 2 and launches["moving_max"] == 0
    assert numbers["file_mb"] > 0 and numbers["phase_s"] > 0


#: the grib-forecast phase at a small size: 320 x 75 points of 0.02
#: degree from 1.00 W (stored as 359.00 E) and 53.50 N, six hourly fields,
#: (b) over a 51.2 km box of RD New inside them at 1 km
GRIB_SMALL = dict(ni=320, nj=75, hours=6, origin=(53500000, 359000000),
                  rd_bbox=(20000.0, 520000.0, 71200.0, 571200.0), rd_cell=1000.0,
                  cog_cell=2000.0, rd_hours=6, sampled_tiles=1)


@pytest.mark.cuda
def test_grib_forecast_phase_on_card(tmp_path):
    """chip_smoke's grib-forecast phase at GRIB_SMALL (three fields in
    simple packing, three in complex packing with second-order spatial
    differencing), in 64^2 tiles, batches of 8: every check of the full
    run, and the Gaussian's records at (a)'s and (b)'s first batches."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 64, 8
    try:
        launches, numbers, kernels = chip_smoke.check_grib_forecast(
            "card", device, str(tmp_path), **GRIB_SMALL)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 2 and launches["moving_max"] == 0
    assert numbers["batches_a"] >= 1 and numbers["phase_s"] > 0
    assert [k["path"] for k in kernels] == ["grib-forecast (a)", "grib-forecast (b)"]
    assert all(k["max_abs_err"] == 0.0 for k in kernels)


#: chip_smoke's parcel-imagery phase at a small size (the CPU test's)
PARCELS_SMALL = dict(px=512, block=128, sampled=((0, 5), (0, 6), (2, 6), (6, 0), (7, 2), (4, 4)),
                     grid=16, cell=600.0, sub=((42, 349), (162, 469)))


@pytest.mark.cuda
def test_parcel_imagery_phase_on_card(tmp_path):
    """chip_smoke's parcel-imagery phase at PARCELS_SMALL (a 512^2 NITF
    scene in 128^2 blocks, 16 x 16 FlatGeobuf parcels), in 64^2 tiles,
    batches of 8: every check of the full run, and the Gaussian's record
    at (b)'s first batch."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 64, 8
    try:
        launches, numbers, kernels = chip_smoke.check_parcel_imagery(
            "card", device, str(tmp_path), **PARCELS_SMALL)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 8 and launches["moving_max"] == 0
    assert numbers["features_decoded"]["mean"] >= 256 and numbers["phase_s"] > 0
    assert [k["path"] for k in kernels] == ["parcel-imagery"]
    assert kernels[0]["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_ortho_jpeg_phase_on_card(tmp_path):
    """chip_smoke's ortho-jpeg phase at a small size on the card: a 1024^2
    orthophoto as a JPEG GeoTIFF by window under a lowered limit, a 512^2
    sub-area's pyramids, two GetMaps a zoom, the small files, in 256^2
    tiles, batches of 8: every check of the full run, the fixtures'
    hashes held by the native build, and the Gaussian's record at (a)."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        with config.set(FILE_LIMIT):
            launches, numbers, kernels = chip_smoke.check_ortho_jpeg(
                "card", device, str(tmp_path), px=1024, sub_px=512, sampled_tiles=2,
                wms_per_zoom=2, gif_px=256, nitf_px=512)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 10 and launches["moving_max"] == 0
    assert numbers["native_decodes"] >= 4 and numbers["gaussian_dtype"] == "float64"
    assert [k["path"] for k in kernels] == ["ortho-jpeg (a)"] and kernels[0]["max_abs_err"] == 0.0


@pytest.mark.cuda
def test_ortho_webp_phase_on_card(tmp_path):
    """chip_smoke's ortho-webp phase at a small size on the card: a 1024^2
    orthophoto as a WebP GeoTIFF by window under a lowered limit, a 512^2
    sub-area's pyramids and GDAL's contiguous layout, a 1024^2 lossy file
    of the committed chunks (g), in 256^2 tiles, batches of 8: every check
    of the full run, the fixtures' hashes held by the native build, and
    the Gaussian's record at (b)."""
    device = _card()
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        with config.set(FILE_LIMIT):
            launches, numbers, kernels = chip_smoke.check_ortho_webp(
                "card", device, str(tmp_path), px=1024, sub_px=512, sampled_tiles=2)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 7 and launches["moving_max"] == 0
    assert numbers["native_decodes"] >= 12 and numbers["gaussian_dtype"] == "float64"
    assert numbers["sampled_webp_share"] < numbers["sampled_deflate_share"]
    assert [k["path"] for k in kernels] == ["ortho-webp (b)"] and kernels[0]["max_abs_err"] == 0.0
    lossy = numbers["lossy"]
    assert lossy["chunks"] == 4 and lossy["native_decodes"] >= 4
    assert lossy["windows_checked"] >= 4 and lossy["gaussian_launches"] >= 1


def _nearest_flat_indices(device, src_gt, src_shape, bbox, width, height):
    """The flat source index each target cell samples, -1 outside: from
    warp_torch on ``device`` over a source whose cells hold their own
    index, and from the host's warp_indices."""
    from dask_geomodeling_tpu_torch.ops.warp import warp_indices, warp_torch

    h, w = src_shape
    values = torch.arange(h * w, dtype=torch.int64).reshape(1, h, w).to(device)
    got = warp_torch(values, tuple(src_gt), "EPSG:4326", None,
                     torch.tensor([bbox], dtype=torch.float64, device=device), "EPSG:4326",
                     width, height, np.dtype("int64"), -1)[0, 0].cpu().numpy()
    rows, cols, inside = warp_indices(tuple(src_gt), "EPSG:4326", (1, h, w), bbox,
                                      "EPSG:4326", width, height)
    return got, np.where(inside, rows * w + cols, -1)


@pytest.mark.cuda
def test_nearest_ties_on_card():
    """The card's nearest index grids equal the host's (warp_indices) bit
    for bit: ortho-jpeg's nitf-half geometry (the 1024^2 scene asked at
    512^2, every cell centre on the corner of four pixels), then random
    same-CRS geotransforms of non-dyadic cells, at half and at odd
    resolutions.  Before device.divide, torch's CUDA division by a Python
    number multiplied by the reciprocal and parted in 2 of nitf-half's 512
    columns."""
    device = _card()
    x0, dx, _, y0, _, dy = gt = chip_smoke.scene_geo_transform(1024)
    got, want = _nearest_flat_indices(device, gt, (1024, 1024),
                                      (x0, y0 + 1024 * dy, x0 + 1024 * dx, y0), 512, 512)
    assert (want >= 0).all() and np.array_equal(got, want)
    rng = np.random.default_rng(25)
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(50, 400, 2))
        a = float(rng.uniform(1e-5, 1e-3)) * (1 + 1e-7 * float(rng.integers(1, 99)))
        e = -a * float(rng.choice([1.0, 0.7, 1.3]))
        sx, sy = float(rng.uniform(-10, 10)), float(rng.uniform(40, 60))
        src_gt = (sx, a, 0.0, sy, 0.0, e)
        scale = float(rng.choice([2.0, 3.0, 0.5, 1.7]))
        width, height = max(1, int(w / scale)), max(1, int(h / scale))
        col0, row0 = int(rng.integers(0, w // 4 + 1)), int(rng.integers(0, h // 4 + 1))
        bbox = (sx + col0 * a, sy + (row0 + h - h // 4) * e, sx + (col0 + w - w // 4) * a,
                sy + row0 * e)
        got, want = _nearest_flat_indices(device, src_gt, (h, w), bbox, width, height)
        assert np.array_equal(got, want), (src_gt, bbox, width, height)


@pytest.mark.cuda
def test_lzw_sheet_phase_on_card(file_paths, tmp_path):
    """chip_smoke's lzw-sheet phase after hfa-roughness: the 1024^2 sheet
    as a tiled LZW GeoTIFF read by window under a lowered limit, and a
    1024 x 768 land use as PackBits, in 256^2 tiles, batches of 8: every
    check of the full run against file-read's and hfa-roughness' answers
    on the card, the pool's two workers, and the Gaussian's records at (a)
    and (b)."""
    import os

    device = _card()
    folder, paths = file_paths
    view, request, _, _ = paths["file-read"]
    tile, batch = chip_smoke.TILE, chip_smoke.BATCH
    chip_smoke.TILE, chip_smoke.BATCH = 256, 8
    try:
        with config.set(FILE_LIMIT):
            read_values = evaluate_tiled(view, request, tile_size=256, batch=8,
                                         device=device)["values"]
            lgn = chip_smoke.check_hfa_roughness(
                "card", device, str(tmp_path), width=1024, height=768, sampled_tiles=4)[3]
            launches, numbers, kernels = chip_smoke.check_lzw_sheet(
                "card", device, str(tmp_path), os.path.join(folder, "sheet.tif"),
                paths["file-read"], read_values, lgn, sampled_tiles=4)
    finally:
        chip_smoke.TILE, chip_smoke.BATCH = tile, batch
    assert launches["gaussian_blur"] >= 3 and launches["moving_max"] == 0
    assert numbers["native_decodes"] >= 16 and numbers["pool_status"]["completed"] > 0
    assert [k["path"] for k in kernels] == ["lzw-sheet (a)", "lzw-sheet (b)"]
    assert all(k["max_abs_err"] == 0.0 for k in kernels) and lgn == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_unsigned_source_on_card(dtype):
    """A uint16, uint32 or uint64 source warped on the card (whose
    torch.where lacks these dtypes) answers as compute_host, nodata and
    the fill outside the source included."""
    device = _card()
    values = (np.arange(3 * 40 * 50) % 1000).astype(dtype).reshape(3, 40, 50)
    values[:, 5:9, 7:11] = 7
    source = R.MemorySource(values, 7, "EPSG:28992", pixel_size=10,
                            pixel_origin=(135000, 456000), time_first=datetime(2000, 1, 1),
                            time_delta=timedelta(hours=1))
    request = dict(mode="vals", projection="EPSG:28992", bbox=(134900, 455500, 135600, 456100),
                   width=70, height=60, start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 2))
    card = source.get_data(device=device, **request)
    host = compute_host(*source.get_compute_graph(**request))
    assert card["values"].dtype == host["values"].dtype == np.dtype(dtype)
    assert card["no_data_value"] == host["no_data_value"]
    np.testing.assert_array_equal(card["values"], host["values"])


# --- building-heights at small size ---


@pytest.fixture(scope="module")
def buildings(file_paths):
    """A 1024^2 sheet and 400 footprints over it (chip_smoke's builders)."""
    folder, paths = file_paths
    sheet = paths["file-read"][0].store.url
    from dask_geomodeling_tpu_torch.raster import RasterFileSource

    bbox = RasterFileSource(sheet).geometry.bounds
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
    """chip_smoke's phase at small size: every check of the full run (the
    exports over a block of 3 x 3 of the 16 tiles)."""
    device = _card()
    folder, paths = file_paths
    sheet = paths["file-read"][0].store.url
    launches, numbers = chip_smoke.check_buildings("card", device, str(tmp_path), sheet,
                                                   count=400, tile=128.0, sub_size=200.0)
    assert launches["gaussian_blur"] == numbers["tiles"] == 9  # a block of 3 x 3 of the 16


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
    tiles = chip_smoke.xyz_tiles(Extent.from_geometry(view.geometry).transformed("EPSG:3857").bbox)
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
        launches, numbers = chip_smoke.check_wms_serving("card", device, wms_sheet, sample=8,
                                                         last_zoom_rows=3)
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
    bbox = RasterFileSource(sheet).geometry.bounds
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


def _formats_folder(file_paths, tmp_path, count=400, tile=128.0):
    """The sheet, and building-heights' GeoPackage export of ``count``
    footprints over it in ``tile`` m tiles on the card (``heights.gpkg``
    in ``tmp_path``, as check_building_formats expects it)."""
    from dask_geomodeling_tpu_torch.geometry.sinks import to_file

    _, paths = file_paths
    sheet = paths["file-read"][0].store.url
    bbox = R.RasterFileSource(sheet).geometry.bounds
    gpkg = chip_smoke.write_buildings(str(tmp_path), bbox, count)
    to_file(chip_smoke.build_buildings_view(gpkg, sheet), str(tmp_path / "heights.gpkg"),
            tile_size=tile, projection="EPSG:28992", mode="centroid", device=_card())
    return sheet, bbox


@pytest.mark.cuda
def test_building_formats_phase_on_card(file_paths, tmp_path):
    """chip_smoke's phase at small size: every check of the full run (the
    GML export over a block of 3 x 3 of the 16 tiles)."""
    device = _card()
    sheet, _ = _formats_folder(file_paths, tmp_path)
    launches, numbers = chip_smoke.check_building_formats(
        "card", device, str(tmp_path), sheet, side=256.0, tile=128.0, count=400)
    assert numbers["tiles"] == 9
    assert launches["gaussian_blur"] == numbers["tiles"] + len(chip_smoke.FORMAT_ROUND)
    assert launches["moving_max"] == 0
    assert sorted(numbers["formats"]) == sorted(f[0] for f in chip_smoke.FORMAT_ROUND)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [f[0] for f in chip_smoke.FORMAT_ROUND])
def test_format_aggregate_on_card_equals_cpu(file_paths, tmp_path, fmt):
    """Each format's building view over the square: the card's answer
    against the CPU's, every field bitwise but h_mean within a rounding
    step where float64 atomics move the unrounded mean."""
    from dask_geomodeling_tpu_torch.geo.geometry import box

    device = _card()
    _, paths = file_paths
    sheet = paths["file-read"][0].store.url
    bbox = R.RasterFileSource(sheet).geometry.bounds
    area = chip_smoke.rings_area(bbox, 256.0)
    square = chip_smoke.square_frame(bbox, area, 400)
    _, name, layer, crs = [f for f in chip_smoke.FORMAT_ROUND if f[0] == fmt][0]
    path = str(tmp_path / name)
    chip_smoke.write_format(fmt, square, path, crs)
    view = chip_smoke.build_buildings_view(path, sheet, layer=layer,
                                           buffer=chip_smoke.GPX_BUFFER if fmt == "gpx" else None)
    request = dict(mode="centroid", geometry=box(*area), projection="EPSG:28992")
    card = chip_smoke.frame_rows(view.get_data(device=device, **request)["features"])
    cpu = chip_smoke.frame_rows(view.get_data(device="cpu", **request)["features"])
    assert len(card) == len(square) > 20
    differ = chip_smoke.compare_heights(fmt, card, cpu, lambda fids: [
        0 if abs(card[f]["h_mean"] - cpu[f]["h_mean"]) <= 0.0100001 else 2 for f in fids])
    assert len(differ) <= 2


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


@pytest.mark.cuda
def test_border_reproject_on_card_equals_cpu():
    device = _card()
    _, view = chip_smoke.build_border_view(512)
    request = chip_smoke.border_request(view, 1024)
    card = evaluate_tiled(view, request, tile_size=256, batch=4, device=device)["values"]
    cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")["values"]
    np.testing.assert_array_equal(card, cpu)
    tile = tile_requests(request, 256)[0][0]
    np.testing.assert_array_equal(
        evaluate_tiled(view, tile, tile_size=256, batch=1, device=device)["values"],
        compute_host(*view.get_compute_graph(**tile))["values"])


@pytest.mark.cuda
@pytest.mark.parametrize("family", [f[0] for f in chip_smoke.CRS_FAMILIES])
def test_crs_family_on_card_equals_cpu(family):
    device = _card()
    _, projection, place = next(f for f in chip_smoke.CRS_FAMILIES if f[0] == family)
    view, request = chip_smoke.build_family_view(projection, place, px=256, cell=40.0)
    card = evaluate_tiled(view, request, tile_size=256, batch=4, device=device)["values"]
    cpu = evaluate_tiled(view, request, tile_size=256, batch=4, device="cpu")["values"]
    np.testing.assert_array_equal(card, cpu)
    # the coarse warp grid against the host's per-pixel transform: the
    # headline's share of differing cells
    host = compute_host(*view.get_compute_graph(**request))["values"]
    assert np.count_nonzero(card != host) <= chip_smoke.HEADLINE_SHARE * host.size


@pytest.mark.cuda
def test_crs_families_phase_on_card(tmp_path):
    device = _card()
    assert chip_smoke.check_crs_families(device, str(tmp_path), px=256) > 0


@pytest.mark.cuda
def test_nesting_and_json_integer_phases_on_card():
    device = _card()
    chip_smoke.check_nesting(device)
    chip_smoke.check_json_integer(device, px=256)


@pytest.mark.cuda
def test_dem_formats_view_on_card(tmp_path):
    """chip_smoke's dem-formats view at 512^2 over a 513^2 SRTM tile: the
    card's answer bitwise to the CPU's and to compute_host, both kernels
    launched on its int16 frames."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils

    device = _card()
    n = 513
    with config.set({"geomodeling.root": str(tmp_path)}):
        name = chip_smoke.write_dem_format("hgt", str(tmp_path), chip_smoke.dem_heights(n))
        view = chip_smoke.build_dem_view(name)
        assert view.args[0].dtype == np.int16
        x1, y1, x2, y2 = chip_smoke.dem_request(n)["bbox"]
        cell = (x2 - x1) / n
        request = dict(mode="vals", projection="EPSG:4326", width=512, height=512,
                       bbox=(x1 + cell, y1, x2, y2 - cell))
        cuda_stencils.reset_launches()
        card = evaluate_tiled(view, request, tile_size=512, batch=1, device=device)["values"]
        assert cuda_stencils.launches == 1 and cuda_stencils.moving_max_launches == 1
        cpu = evaluate_tiled(view, request, tile_size=512, batch=1, device="cpu")["values"]
        np.testing.assert_array_equal(card, cpu)
        np.testing.assert_array_equal(card, compute_host(*view.get_compute_graph(**request))["values"])


@pytest.mark.cuda
def test_dem_formats_phase_on_card(tmp_path):
    """chip_smoke's phase at small size (a 1441^2 tile, the text formats at
    481^2, RD at 2048^2 of 60 m): every check of the full run."""
    device = _card()
    launches, numbers, kernels = chip_smoke.check_dem_formats(
        "card", device, str(tmp_path), n=1441, text_n=481, rd_px=2048, rd_cell=60.0)
    assert launches["gaussian_blur"] > 0 and launches["moving_max"] > 0
    assert sorted(numbers) == sorted(["hgt", "rd", "hgt3", "asc3", "xyz3", "phase_s"]
                                     + [f for f in chip_smoke.DEM_FORMATS if f not in ("asc", "xyz")])
    assert [k["path"] for k in kernels] == ["dem-formats (int16)"] * 2
