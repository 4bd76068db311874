"""RasterFileSource, the read caches and the file sandbox, carried across
from the JAX package.

A JAX-package view over a GeoTIFF or VRT comes across with
``from_reference``; the port's ``compute_host`` and its ``get_data`` on
the CPU are held bitwise to the JAX package's numpy executor: whole-file
and windowed reads (``geomodeling.windowed-read-limit`` lowered in both
configs), overview reads, cross-CRS reads (the densified extent), point,
meta and time requests, an empty time window, a nodata value outside the
dtype's range, a VRT mosaic and a 5-band temporal file.  ``evaluate_tiled``
over a windowed source is bitwise to compute_host tile by tile and runs
as many batches as over a MemorySource of the same array.  The whole-file
cache decodes once per file and stamp (the JAX package's never hits) and
sees a rewrite.  A GeoPackage's tile layer and an MBTiles file go to their
readers, decode each tile once and are never read by window; a
GeoPackage of features raises the JAX package's error.
"""
import os
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.geo import safefiles as jax_safefiles
from dask_geomodeling_tpu.io.geotiff import write_geotiff
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch import raster as port
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import safefiles
from dask_geomodeling_tpu_torch.io import geotiff as port_geotiff
from dask_geomodeling_tpu_torch.runtime import executor, pipeline
from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

HEIGHT, WIDTH = 90, 120
ORIGIN = (135000.0, 456000.0)
CELL = 0.5
SHEET_BBOX = (ORIGIN[0], ORIGIN[1] - HEIGHT * CELL, ORIGIN[0] + WIDTH * CELL, ORIGIN[1])
NODATA = -9999.0


def sheet(bands=1, dtype="f4", seed=0):
    """Terrain-like values with 5% nodata and a nodata block."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:HEIGHT, 0:WIDTH]
    data = np.stack([5 + np.sin(x / 9.0 + b) * 3 + np.cos(y / 7.0) * 2 for b in range(bands)])
    data = (data + rng.rand(bands, HEIGHT, WIDTH) * 0.01).astype(dtype)
    data[rng.rand(bands, HEIGHT, WIDTH) < 0.05] = NODATA
    data[:, 10:30, 50:75] = NODATA
    return data


@pytest.fixture
def root(tmp_path):
    pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path)}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        yield tmp_path
    pipeline.clear_read_cache()


def write(root, name, data, no_data_value=NODATA, **kwargs):
    kwargs.setdefault("compress", "deflate")
    kwargs.setdefault("tiled", True)
    kwargs.setdefault("tile_size", 32)
    write_geotiff(str(root / name), data, (ORIGIN[0], CELL, 0.0, ORIGIN[1], 0.0, -CELL),
                  "EPSG:28992", no_data_value, **kwargs)
    return name


def both_configs(values):
    """The same settings in the JAX package's and the port's config."""
    class _Both:
        def __enter__(self):
            self.contexts = [jax_config.set(dict(values)), config.set(dict(values))]
            return self

        def __exit__(self, *exc):
            for context in self.contexts:
                context.__exit__(*exc)

    return _Both()


def vals(bbox=SHEET_BBOX, width=WIDTH, height=HEIGHT, projection="EPSG:28992", **extra):
    return dict(mode="vals", bbox=bbox, width=width, height=height, projection=projection,
                **extra)


def jax_numpy(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def assert_same(actual, expected, what="", atol=None):
    if expected is None or "values" not in expected:
        assert actual == expected, what
        return
    assert actual["values"].dtype == expected["values"].dtype, what
    assert actual["no_data_value"] == expected["no_data_value"], what
    if atol is None:
        np.testing.assert_array_equal(actual["values"], expected["values"], err_msg=what)
    else:
        nodata = expected["no_data_value"]
        np.testing.assert_array_equal(actual["values"] == nodata, expected["values"] == nodata)
        np.testing.assert_allclose(actual["values"], expected["values"], rtol=0, atol=atol)


def assert_agrees(jax_view, request, atol=None):
    """The port's view of ``jax_view``: compute_host bitwise and get_data
    on the CPU bitwise (or within ``atol``, nodata in the same cells) to
    the JAX package's numpy executor; returns the port's view and the
    expected answer."""
    expected = jax_numpy(jax_view, request)
    view = from_reference(jax_view.serialize())
    assert_same(compute_host(*view.get_compute_graph(**request)), expected, "compute_host")
    assert_same(view.get_data(device="cpu", **request), expected, "get_data", atol)
    return view, expected


def test_attributes(root):
    write(root, "a.tif", sheet(bands=3), metadata=["x", "y", "z"])
    jax_source = R.RasterFileSource("a.tif", time_first=datetime(2000, 1, 1),
                                    time_delta=timedelta(hours=1))
    source = from_reference(jax_source.serialize())
    assert source.url == jax_source.url == "file://" + str(root / "a.tif")
    for attribute in ("dtype", "fillvalue", "projection", "geo_transform", "extent", "period",
                      "timedelta", "temporal"):
        assert getattr(source, attribute) == getattr(jax_source, attribute), attribute
    assert len(source) == len(jax_source) == 3
    assert source.geometry.bounds == jax_source.geometry.bounds
    source.close_dataset()
    assert not hasattr(source, "_info")


@pytest.mark.parametrize("interpolation", ["nearest", "bilinear"])
@pytest.mark.parametrize("limit", [None, 1000])
@pytest.mark.parametrize("smooth", [False, True])
def test_whole_and_windowed_reads(root, limit, smooth, interpolation):
    write(root, "a.tif", sheet())
    jax_view = R.RasterFileSource("a.tif")
    if smooth:
        jax_view = R.Smooth(jax_view, 2)
    sub = (ORIGIN[0] + 7.3, ORIGIN[1] - 30.1, ORIGIN[0] + 41.9, ORIGIN[1] - 2.2)
    with both_configs({"geomodeling.windowed-read-limit": limit,
                       "geomodeling.warp-interpolation": interpolation}):
        view, _ = assert_agrees(jax_view, vals())
        assert_agrees(jax_view, vals(bbox=sub, width=57, height=41))
        request = vals(bbox=sub, width=57, height=41)
        source, jax_source = view, jax_view
        if smooth:  # the source's request: Smooth's, grown by its margin
            request = view.get_sources_and_requests(**request)[0][1]
            source, jax_source = view.store, jax_view.store
        plan = source.get_sources_and_requests(**request)[0][0]
        window = source._file_read_plan(request)
        assert window == jax_source._file_read_plan(request)
    assert plan.get("windowed", False) == (limit is not None)
    if limit is None:
        assert window is None and plan["raster_data"].array.shape == (1, HEIGHT, WIDTH)
    else:
        (row0, row1, col0, col1) = window[1]
        assert plan["raster_data"].array.shape == (1, row1 - row0, col1 - col0)
        assert (row1 - row0) * (col1 - col0) < HEIGHT * WIDTH


#: the bilinear warp across CRSes interpolates the coarse grid where the
#: host transforms every pixel (chip_smoke.BILINEAR_ATOL)
@pytest.mark.parametrize("interpolation, atol", [("nearest", None), ("bilinear", 1e-3)])
def test_cross_crs_windowed(root, interpolation, atol):
    from dask_geomodeling_tpu.geo import Extent

    write(root, "a.tif", sheet())
    jax_view = R.RasterFileSource("a.tif")
    bbox = Extent((ORIGIN[0] + 5, ORIGIN[1] - 40, ORIGIN[0] + 50, ORIGIN[1] - 3),
                  "EPSG:28992").transformed("EPSG:3857").bbox
    request = vals(bbox=bbox, width=64, height=48, projection="EPSG:3857")
    with both_configs({"geomodeling.windowed-read-limit": 1000,
                       "geomodeling.warp-interpolation": interpolation}):
        view, expected = assert_agrees(jax_view, request, atol)
        densified = view._densified_extent(bbox, "EPSG:3857", "EPSG:28992")
        assert densified == R.RasterFileSource._densified_extent(bbox, "EPSG:3857", "EPSG:28992")
        assert view._file_read_plan(request) == jax_view._file_read_plan(request)
    assert (expected["values"] != NODATA).mean() > 0.5


def test_overview_read(root):
    data = sheet()
    write(root, "cog.tif", data, cog=True, overviews=[2, 4], tile_size=16)
    jax_view = R.RasterFileSource("cog.tif")
    request = vals(width=30, height=22)
    with both_configs({"geomodeling.use-overviews": True}):
        view, expected = assert_agrees(jax_view, request)
        assert view._file_read_plan(request) == (2, (0, 23, 0, 30))
        with both_configs({"geomodeling.windowed-read-limit": 100}):
            assert view._file_read_plan(request) == jax_view._file_read_plan(request)
            assert_agrees(jax_view, request)
    with both_configs({"geomodeling.use-overviews": False}):
        full, _ = assert_agrees(jax_view, request)
        assert full._file_read_plan(request) is None


@pytest.mark.parametrize("limit", [None, 1000])
def test_point_meta_and_time_requests(root, limit):
    write(root, "t.tif", sheet(bands=5), metadata=["m%d" % k for k in range(5)])
    jax_view = R.RasterFileSource("t.tif", time_first=datetime(2000, 1, 1, 6),
                                  time_delta=timedelta(minutes=30))
    window = dict(start=datetime(2000, 1, 1, 6, 30), stop=datetime(2000, 1, 1, 7, 45))
    x, y = ORIGIN[0] + 20.3, ORIGIN[1] - 10.7
    with both_configs({"geomodeling.windowed-read-limit": limit}):
        view, expected = assert_agrees(jax_view, vals(bbox=(x, y, x, y), width=1, height=1,
                                                      **window))
        assert expected["values"].shape == (3, 1, 1)
        assert_agrees(jax_view, vals(**window))
        for mode in ("meta", "time"):
            request = vals(**window)
            request["mode"] = mode
            expected = jax_numpy(jax_view, request)
            assert view.get_data(**request) == expected  # no device resolved
            assert compute_host(*view.get_compute_graph(**request)) == expected
        assert expected["time"] == [datetime(2000, 1, 1, 6, 30) + k * timedelta(minutes=30)
                                    for k in range(3)]


def test_empty_time_window(root):
    write(root, "a.tif", sheet())
    jax_view = R.RasterFileSource("a.tif", time_first=datetime(2000, 1, 1))
    request = vals(start=datetime(2010, 1, 1), stop=datetime(2010, 1, 2))
    assert jax_numpy(jax_view, request) is None
    assert_agrees(jax_view, request)


@pytest.mark.parametrize("limit", [None, 1000])
@pytest.mark.parametrize("nodata", [-99999.0, 300.0, None])
def test_nodata_outside_the_dtype(root, nodata, limit):
    data = (sheet() * 20).astype("u1")
    write(root, "b.tif", data, no_data_value=nodata)
    jax_view = R.RasterFileSource("b.tif")
    with both_configs({"geomodeling.windowed-read-limit": limit}):
        view, expected = assert_agrees(jax_view, vals(width=60, height=45))
    assert view.fillvalue == jax_view.fillvalue == 255
    assert expected["no_data_value"] == 255


def test_vrt_mosaic(root):
    from dask_geomodeling_tpu.raster import to_file as jax_to_file

    data = sheet()
    memory = R.MemorySource(data, NODATA, "EPSG:28992", CELL, ORIGIN)
    with jax_config.set({"geomodeling.executor": "numpy"}):
        jax_to_file(memory, str(root / "m.vrt"), tile_size=50)
    jax_view = R.Smooth(R.RasterFileSource("m.vrt"), 1.5)
    for limit in (None, 1000):
        with both_configs({"geomodeling.windowed-read-limit": limit}):
            assert_agrees(jax_view, vals())
            assert_agrees(jax_view, vals(bbox=(ORIGIN[0] + 3, ORIGIN[1] - 44, ORIGIN[0] + 33,
                                               ORIGIN[1] - 4), width=60, height=80))


def test_temporal_file(root):
    write(root, "t.tif", sheet(bands=5), tiled=False)
    jax_view = R.TemporalAggregate(
        R.RasterFileSource("t.tif", time_first=datetime(2000, 1, 1), time_delta=3600000),
        "2h", statistic="max")
    request = vals(start=datetime(2000, 1, 1), stop=datetime(2000, 1, 1, 4))
    with both_configs({"geomodeling.windowed-read-limit": 1000}):
        view, expected = assert_agrees(jax_view, request)
    assert expected["values"].shape == (3, HEIGHT, WIDTH)


def _tiled_against_host(view, request, tile, batch):
    """evaluate_tiled bitwise to compute_host tile by tile; returns the
    number of batches it ran."""
    before = tile_runtime.batches_run
    out = evaluate_tiled(view, request, tile_size=tile, batch=batch, device="cpu")["values"]
    batches = tile_runtime.batches_run - before
    tiles, nx = tile_requests(request, tile)
    for index, tile_request in enumerate(tiles):
        j, i = divmod(index, nx)
        vw, vh = min(tile, request["width"] - i * tile), min(tile, request["height"] - j * tile)
        row_end = request["height"] - j * tile
        host = compute_host(*view.get_compute_graph(**tile_request))["values"]
        np.testing.assert_array_equal(
            out[:, row_end - vh : row_end, i * tile : i * tile + vw], host[:, tile - vh :, :vw],
            err_msg="tile %d" % index)
    return batches


@pytest.mark.parametrize("projection, beyond", [("EPSG:28992", 0), ("EPSG:3857", 0),
                                                ("EPSG:28992", 30)])
def test_windowed_tiles_batch_as_memory(root, projection, beyond):
    """``beyond`` metres of request past each edge of the file: tiles
    that miss it read the minimal corner window and answer fill."""
    from dask_geomodeling_tpu.geo import Extent

    data = sheet()
    write(root, "a.tif", data)
    file_view = port.Smooth(port.RasterFileSource(str(root / "a.tif")), 2)
    memory_view = port.Smooth(port.MemorySource(data, NODATA, "EPSG:28992", CELL, ORIGIN), 2)
    x1, y1, x2, y2 = SHEET_BBOX
    bbox = (x1 - beyond, y1 - beyond, x2 + beyond, y2 + beyond)
    request = vals(bbox=Extent(bbox, "EPSG:28992").transformed(projection).bbox,
                   projection=projection, width=WIDTH + 4 * beyond, height=HEIGHT + 4 * beyond)
    runs = executor.host_node_runs
    with config.set({"geomodeling.windowed-read-limit": 1000}):
        file_batches = _tiled_against_host(file_view, request, tile=24, batch=4)
    assert executor.host_node_runs == runs, "a node ran on the host"
    memory_batches = _tiled_against_host(memory_view, request, tile=24, batch=4)
    assert file_batches == memory_batches
    if projection == "EPSG:28992" and not beyond:
        assert file_batches == 5  # 20 tiles in batches of 4
    with config.set({"geomodeling.windowed-read-limit": 1000}):
        windowed = evaluate_tiled(file_view, request, tile_size=24, batch=4, device="cpu")
    np.testing.assert_array_equal(
        windowed["values"],
        evaluate_tiled(file_view, request, tile_size=24, batch=4, device="cpu")["values"])


def test_whole_file_cache_decodes_once_per_stamp(root, monkeypatch):
    path = root / write(root, "a.tif", sheet())
    decodes = []
    original = port_geotiff.read_geotiff
    monkeypatch.setattr(port_geotiff, "read_geotiff",
                        lambda p: decodes.append(p) or original(p))
    source = port.RasterFileSource(str(path))
    request = vals(width=40, height=30)
    first = source.get_sources_and_requests(**request)[0][0]["raster_data"]
    second = source.get_sources_and_requests(**request)[0][0]["raster_data"]
    assert first is second and len(decodes) == 1
    tiles, _ = tile_requests(vals(), 32)
    arrays = {id(source.get_sources_and_requests(**t)[0][0]["raster_data"].array) for t in tiles}
    assert len(arrays) == 1 and len(decodes) == 1
    # a rewrite (new size, newer mtime) is seen and decoded again
    stamp = os.stat(path).st_mtime_ns
    write(root, "a.tif", sheet(seed=1) + 1, tiled=False)
    os.utime(path, ns=(stamp + 10**9, stamp + 10**9))
    third = source.get_sources_and_requests(**request)[0][0]["raster_data"]
    assert len(decodes) == 2 and third is not first
    np.testing.assert_array_equal(third.array, sheet(seed=1) + 1)
    assert source.get_sources_and_requests(**request)[0][0]["raster_data"] is third


def test_window_cache(root, monkeypatch):
    path = root / write(root, "a.tif", sheet())
    decodes = []
    original = port_geotiff.read_geotiff_window
    monkeypatch.setattr(port_geotiff, "read_geotiff_window",
                        lambda *a, **k: decodes.append(a) or original(*a, **k))
    first = pipeline.read_geotiff_window_cached(str(path), 3, 40, 5, 60)
    assert pipeline.read_geotiff_window_cached(str(path), 3, 40, 5, 60) is first
    assert pipeline.read_geotiff_window_cached(str(path), 3, 40, 5, 61) is not first
    assert len(decodes) == 2


def c8_nitf():
    """The bytes of a NITF 2.1 file of one JPEG 2000-compressed (IC = C8)
    4 x 4 segment, written with tests/test_nitf.py's encoder."""
    import tests.test_nitf as nitf_tests

    values = np.zeros((1, 4, 4), np.uint8)
    subheader = nitf_tests._image_subheader(values, icords=" ", ic=b"C8")
    payload = b"\xff\x4f\xff\x51"
    return nitf_tests._file_header([(subheader, payload)]) + subheader + payload


@pytest.mark.parametrize("name, module", [("a.jp2", "io/jp2.py"), ("a.ntf", "io/nitf.py"),
                                          ("a.bmp", "io/jpeg.py"), ("a.j2k", "io/jp2.py"),
                                          ("a.gif", "io/jpeg.py"),
                                          ("a.jpg", "io/jpeg.py")])
def test_unported_format_names_its_module(root, name, module):
    """A raster format the port does not read raises NotImplementedError
    naming the JAX module that reads it; a NITF file is read but for its
    JPEG 2000 (C8) segments.  JPEG, BMP and GIF (io/jpeg.py) are read:
    a file of none of them raises OSError in both packages, as Pillow's
    UnidentifiedImageError does."""
    (root / name).write_bytes(c8_nitf() if name.endswith(".ntf") else b"not read")
    source = port.RasterFileSource(name)
    if module == "io/jpeg.py":
        with pytest.raises(OSError, match="cannot identify image file"):
            source.info
        with pytest.raises(OSError, match="cannot identify image file"):
            pipeline.read_geotiff_cached(str(root / name))
        with pytest.raises(OSError, match="cannot identify image file"):
            jax_pipeline.read_geotiff_cached(str(root / name))
        return
    with pytest.raises(NotImplementedError, match=module):
        source.info
    with pytest.raises(NotImplementedError, match=module):
        pipeline.read_geotiff_cached(str(root / name))


def _pyramid(root, name):
    from dask_geomodeling_tpu.io.gpkg_raster import write_gpkg_raster
    from dask_geomodeling_tpu.io.mbtiles import write_mbtiles

    values = (np.arange(40 * 70) % 251).astype("u1").reshape(1, 40, 70)
    if name.endswith(".gpkg"):
        write_gpkg_raster(str(root / name), values, (ORIGIN[0], CELL, 0.0, ORIGIN[1], 0.0, -CELL),
                          projection="EPSG:28992", tile_size=32)
    else:
        res = 2 * 20037508.342789244 / (256 * 2**14)
        write_mbtiles(str(root / name), values, (-20037508.342789244 + 8400 * 256 * res, res, 0.0,
                                                 20037508.342789244 - 5390 * 256 * res, 0.0, -res))
    return values


@pytest.mark.parametrize("name, module, reader", [("a.gpkg", "gpkg_raster", "read_gpkg_raster"),
                                                  ("a.mbtiles", "mbtiles", "read_mbtiles")])
def test_tile_pyramids_read_whole(root, name, module, reader, monkeypatch):
    """A GeoPackage's tile layer and an MBTiles file go to their readers
    in the read cache and in info alike, decode once per stamp and are
    never read by window; a GeoPackage of features raises the JAX
    package's error."""
    from dask_geomodeling_tpu_torch.io import gpkg_raster, mbtiles

    values = _pyramid(root, name)
    reader = getattr({"gpkg_raster": gpkg_raster, "mbtiles": mbtiles}[module], reader)
    path = str(root / name)
    assert pipeline.whole_file_reader(path) is reader
    decodes = []
    monkeypatch.setattr(gpkg_raster, "_decode_tile",
                        lambda blob, decode=gpkg_raster._decode_tile: decodes.append(1)
                        or decode(blob))
    source = port.RasterFileSource(name)
    request = vals(bbox=source.geometry.bounds, width=35, height=20)
    with both_configs({"geomodeling.windowed-read-limit": 10}):
        assert source._file_read_plan(request) is None
        first = pipeline.read_geotiff_cached(path)
        assert source.info.width == first.array.shape[2] and pipeline.read_geotiff_cached(
            path) is first
    assert len(decodes) == first.array.shape[1] * first.array.shape[2] // (
        32 * 32 if name.endswith(".gpkg") else 256 * 256)
    np.testing.assert_array_equal(first.array[:, :40, :70], values)
    if name.endswith(".gpkg"):
        (root / "features.gpkg").write_bytes((root / name).read_bytes())
        import sqlite3

        con = sqlite3.connect(str(root / "features.gpkg"))
        con.execute("UPDATE gpkg_contents SET data_type = 'features'")
        con.commit()
        con.close()
        with pytest.raises(IOError, match="No tile layers in '"):
            port.RasterFileSource("features.gpkg").info


URLS = ["a.tif", "sub/../a.tif", "/elsewhere/a.tif", "file:///elsewhere/b.tif", "file://rel.tif"]


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("url", URLS)
def test_sandbox_as_the_jax_package(root, url, strict):
    def answer(module):
        try:
            return module.safe_file_url(url), module.safe_abspath(url)
        except IOError as e:
            return type(e), str(e)

    with both_configs({"geomodeling.strict-file-paths": strict}):
        assert answer(safefiles) == answer(jax_safefiles)
    with pytest.raises(NotImplementedError, match="Unknown protocol"):
        safefiles.safe_file_url("s3://bucket/a.tif")
