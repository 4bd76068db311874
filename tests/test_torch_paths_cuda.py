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
against compute_host; the float64 discrete ops.  This file imports nothing
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
