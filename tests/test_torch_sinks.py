"""RasterTiler, RasterFileSink, ``to_file`` and ``to_cog``, carried across
from the JAX package.

The cases of tests/test_raster_parallelize.py, tests/test_raster_sinks.py,
tests/test_vrt_window.py and tests/test_cog.py, each run on a JAX-package
view and on the port's view of it (``from_reference``, ``device="cpu"``):
the port plans the same subrequests, answers as the JAX package's numpy
executor does, and writes the same files: the same names (each tile's
token), the same bytes, the same VRT XML but for its directory, and a
byte-identical COG.  A view with a tiler or a sink at its root runs
through ``compute_torch``: its subrequests' twins run on the device, and
the tiler and the sink get each result copied to the host once.
"""
import builtins
import os
import struct
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.io.geotiff import _read_ifd
from dask_geomodeling_tpu_torch import from_reference
from dask_geomodeling_tpu_torch import raster as port
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io.geotiff import (
    read_geotiff,
    read_geotiff_overviews,
    read_geotiff_window,
    write_geotiff,
)
from dask_geomodeling_tpu_torch.io.vrt import read_vrt, read_vrt_info, read_vrt_window
from dask_geomodeling_tpu_torch.runtime import executor, pipeline
from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime

T0 = datetime(2000, 1, 1)


def jax_numpy(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def jax_numpy_call(func, *args, **kwargs):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return func(*args, **kwargs)


def assert_same(actual, expected):
    if expected is None or "values" not in expected:
        assert actual == expected
        return
    assert actual["values"].dtype == expected["values"].dtype
    assert actual["no_data_value"] == expected["no_data_value"]
    np.testing.assert_array_equal(actual["values"], expected["values"])


@pytest.fixture
def root(tmp_path):
    pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path)}), \
            config.set({"geomodeling.root": str(tmp_path)}):
        yield tmp_path


def files_of(directory):
    """{name: bytes} of the .tif files in ``directory``."""
    if not os.path.isdir(directory):
        return {}
    return {name: open(os.path.join(directory, name), "rb").read()
            for name in sorted(os.listdir(directory)) if name.endswith(".tif")}


# --- RasterTiler (tests/test_raster_parallelize.py) ---


@pytest.fixture
def empty_source():
    return R.MemorySource(data=np.empty((0, 0, 0), np.uint8), no_data_value=255,
                          projection="EPSG:28992", pixel_size=1.0, pixel_origin=(0, 0))


@pytest.fixture
def source():
    data = np.arange(75, dtype=np.uint8).reshape(3, 5, 5) % 250
    data[2] = 255  # nodata frame
    data[0, 0, 0] = 1
    data[1, 0, 0] = 7
    return R.MemorySource(data=data, no_data_value=255, projection="EPSG:28992",
                          pixel_size=1.0, pixel_origin=(135000, 456000), time_first=T0,
                          time_delta=timedelta(hours=1),
                          metadata=["meta%d" % i for i in range(3)])


def test_tiler_defaults(empty_source):
    block = from_reference(R.RasterTiler(empty_source, 10).serialize())
    assert isinstance(block, port.RasterTiler) and isinstance(block.store, port.MemorySource)
    assert list(block.tile_size) == [10, 10]


@pytest.mark.parametrize("bad", ["a", 0, [1], [2, 3, 3]])
def test_tiler_validation(bad):
    source = port.MemorySource(np.zeros((1, 2, 2), np.uint8), 255, "EPSG:28992", 1.0, (0, 0))
    with pytest.raises(TypeError):
        port.RasterTiler("a", 10)
    with pytest.raises(ValueError):
        port.RasterTiler(source, bad)


@pytest.mark.parametrize("cellsize", [(1, 1), (2, 2), (3, 3), (2, 3), (1, 4)])
@pytest.mark.parametrize("bbox", [
    (0.0, 0.0, 7.0, 7.0), (2.0, -1.0, 9.0, 6.0), (2.0, 7.0, 7.0, 14.0), (0.0, 0.0, 14.0, 7.0),
    (0.0, 0.0, 7.0, 14.0), (10.0, -10.0, 20.0, 2.0), (3.0, 3.0, 15.0, 15.0),
])
def test_tiler_plans_the_jax_subrequests(empty_source, bbox, cellsize):
    request = dict(mode="vals", bbox=bbox, projection="EPSG:28992",
                   width=int((bbox[2] - bbox[0]) / cellsize[0]),
                   height=int((bbox[3] - bbox[1]) / cellsize[1]))
    jax_block = R.RasterTiler(empty_source, 7)
    block = from_reference(jax_block.serialize())
    got = list(block.get_sources_and_requests(**request))
    want = list(jax_block.get_sources_and_requests(**request))
    assert got[0][0] == want[0][0]
    assert [r for _, r in got[1:]] == [r for _, r in want[1:]]


@pytest.mark.parametrize("bbox_offset", [(0, -5, 5, 0), (0, -5, 6, 0), (0, -6, 5, 0),
                                         (-1, -5, 5, 0), (0, -5, 5, 1)])
def test_tiler_process(source, bbox_offset):
    ox, oy = 135000, 456000
    request = dict(mode="vals", bbox=(ox + bbox_offset[0], oy + bbox_offset[1],
                                      ox + bbox_offset[2], oy + bbox_offset[3]),
                   width=(bbox_offset[2] - bbox_offset[0]) * 2,
                   height=(bbox_offset[3] - bbox_offset[1]) * 2,
                   projection="EPSG:28992", start=T0, stop=datetime(2000, 1, 1, 2))
    jax_view = R.RasterTiler(source, 2)
    expected = jax_numpy(jax_view, request)
    assert_same(expected, jax_numpy(source, request))
    view = from_reference(jax_view.serialize())
    before = tile_runtime.batches_run
    assert_same(view.get_data(device="cpu", **request), expected)
    assert tile_runtime.batches_run == before  # the tiler's own grid, not the runtime's


def test_tiler_point_and_passthrough(source):
    view = from_reference(R.RasterTiler(source, 2).serialize())
    point = dict(mode="vals", bbox=(135000.5, 455999.5, 135000.5, 455999.5), width=1, height=1,
                 projection="EPSG:28992", start=T0, stop=datetime(2000, 1, 1, 2))
    assert view.get_data(device="cpu", **point)["values"].tolist() == [[[1]], [[7]], [[255]]]
    for mode in ("meta", "time"):
        request = dict(point, mode=mode, bbox=(135000, 455995, 135005, 456000), width=5,
                       height=5)
        assert view.get_data(**request) == jax_numpy(R.RasterTiler(source, 2), request)


def test_tiler_over_a_twin_chain_fetches_each_subrequest(source, monkeypatch):
    """The subrequests' twins run on the device; the tiler gets each
    result copied to the host once (executor.to_host)."""
    jax_view = R.RasterTiler(R.Smooth(R.Multiply(source, 1.5), 1.5), 2)
    request = dict(mode="vals", bbox=(135000, 455995, 135005, 456000), width=10, height=10,
                   projection="EPSG:28992", start=T0, stop=datetime(2000, 1, 1, 2))
    view = from_reference(jax_view.serialize())
    fetched = []
    original = executor.to_host
    monkeypatch.setattr(executor, "to_host", lambda obj: fetched.append(1) or original(obj))
    runs = executor.host_node_runs
    assert_same(view.get_data(device="cpu", **request), jax_numpy(jax_view, request))
    assert len(fetched) == 25  # 5 x 5 subrequests of 2^2 px; the root is on the host
    assert executor.host_node_runs == runs + 1  # the tiler's assembly alone


def test_tiler_over_smooth_on_an_integer_source(source):
    """Smooth over the uint8 source itself: the numpy process stores each
    axis pass in uint8, truncated, and so does the twin."""
    jax_view = R.RasterTiler(R.Smooth(source, 1.5), 2)
    request = dict(mode="vals", bbox=(135000, 455995, 135005, 456000), width=10, height=10,
                   projection="EPSG:28992", start=T0, stop=datetime(2000, 1, 1, 2))
    view = from_reference(jax_view.serialize())
    expected = jax_numpy(jax_view, request)
    assert expected["values"].dtype == np.uint8
    assert_same(view.get_data(device="cpu", **request), expected)


# --- RasterFileSink and to_file (tests/test_raster_sinks.py) ---


@pytest.fixture
def sink_source():
    return R.MemorySource(data=np.arange(64, dtype=np.uint8).reshape(1, 8, 8),
                          no_data_value=255, projection="EPSG:28992", pixel_size=1.0,
                          pixel_origin=(135000, 456000), time_first=T0,
                          time_delta=timedelta(hours=1))


SINK_REQUEST = dict(mode="vals", bbox=(135000, 455992, 135008, 456000),
                    projection="EPSG:28992", width=8, height=8, start=T0)


def test_sink_writes_the_jax_file(sink_source, root):
    jax_sink = R.RasterFileSink(sink_source, "jax")
    assert jax_numpy(jax_sink, SINK_REQUEST) is None
    sink = from_reference(R.RasterFileSink(sink_source, "port").serialize())
    assert sink.url == "file://" + str(root / "port")
    assert sink.get_data(device="cpu", **SINK_REQUEST) is None
    assert sink.get_data(device="cpu", **SINK_REQUEST) is None  # the same name again
    port_files, jax_files = files_of(root / "port"), files_of(root / "jax")
    assert port_files == jax_files and len(port_files) == 1
    written = read_geotiff(str(root / "port" / list(port_files)[0]))
    np.testing.assert_array_equal(written.array[0], np.arange(64, dtype=np.uint8).reshape(8, 8))
    assert written.no_data_value == 255 and written.projection == "EPSG:28992"


@pytest.mark.parametrize("overrides", [{"start": datetime(2099, 1, 1), "stop": datetime(2099, 1, 1)},
                                       {"bbox": (1135000, 1456000, 1135008, 1456008)}])
def test_sink_without_data_writes_nothing(sink_source, root, overrides):
    sink = from_reference(R.RasterFileSink(sink_source, "empty_tiles").serialize())
    request = dict(SINK_REQUEST, **overrides)
    assert sink.get_data(device="cpu", **request) is None
    assert files_of(root / "empty_tiles") == {}


def test_sink_bool_is_written_as_uint8(sink_source, root):
    jax_view = R.RasterFileSink(R.Greater(sink_source, 20), "jax")
    jax_numpy(jax_view, SINK_REQUEST)
    from_reference(R.RasterFileSink(R.Greater(sink_source, 20), "port").serialize()).get_data(
        device="cpu", **SINK_REQUEST)
    port_files = files_of(root / "port")
    assert port_files == files_of(root / "jax") and len(port_files) == 1
    assert read_geotiff(str(root / "port" / list(port_files)[0])).array.dtype == np.uint8


def test_sink_rejects_multiband_and_forwards_time(source, root):
    sink = from_reference(R.RasterFileSink(source, "tiles").serialize())
    request = dict(mode="vals", bbox=(135000, 455995, 135005, 456000), width=5, height=5,
                   projection="EPSG:28992", start=T0, stop=datetime(2000, 1, 1, 2))
    with pytest.raises(ValueError, match="single-band"):
        sink.get_data(device="cpu", **request)
    result = sink.get_data(**dict(request, mode="time", stop=T0))
    assert result == {"time": [T0]}
    with pytest.raises(TypeError):
        port.RasterFileSink("not a raster", "tiles")


@pytest.mark.parametrize("tile_size", [3, 4, [5, 3], 8])
def test_to_file_as_the_jax_package(sink_source, root, tile_size):
    jax_numpy_call(R.to_file, sink_source, str(root / "jax" / "out.vrt"), tile_size=tile_size,
                   start=T0)
    view = from_reference(sink_source.serialize())
    view.to_file(str(root / "port" / "out.vrt"), tile_size=tile_size, start=T0, device="cpu")
    port_files = files_of(root / "port" / "tiles")
    assert port_files == files_of(root / "jax" / "tiles")
    with open(root / "port" / "out.vrt") as f, open(root / "jax" / "out.vrt") as g:
        assert f.read().replace(str(root / "port"), "") == g.read().replace(str(root / "jax"), "")
    mosaic = read_vrt(str(root / "port" / "out.vrt"))
    np.testing.assert_array_equal(mosaic.array[0], np.arange(64, dtype=np.uint8).reshape(8, 8))
    reread = port.RasterFileSource("port/out.vrt", time_delta=timedelta(hours=1))
    assert reread.dtype == np.uint8
    data = reread.get_data(device="cpu", **dict(SINK_REQUEST, start=datetime(1970, 1, 1)))
    np.testing.assert_array_equal(data["values"][0], mosaic.array[0])


def test_to_file_errors(sink_source, root):
    view = from_reference(sink_source.serialize())
    target = root / "out.vrt"
    target.write_text("occupied")
    with pytest.raises(IOError):
        port.to_file(view, str(target), tile_size=4, start=T0, device="cpu")
    port.to_file(view, str(root / "out_a.vrt"), tile_size=4, start=T0, device="cpu")
    port.RasterFileSink.merge_files(str(root / "tiles"), str(root / "exists.vrt"))
    with pytest.raises(IOError):
        port.RasterFileSink.merge_files(str(root / "tiles"), str(root / "exists.vrt"))
    (root / "empty_dir").mkdir()
    with pytest.raises(IOError):
        port.RasterFileSink.merge_files(str(root / "empty_dir"), str(root / "none.vrt"))
    empty = port.MemorySource(np.empty((0, 0, 0), np.uint8), 255, "EPSG:28992", 1.0, (0, 0))
    with pytest.raises(ValueError, match="Cannot determine the extent"):
        port.to_file(empty, str(root / "e.vrt"), tile_size=4, device="cpu")
    with pytest.raises(ValueError, match="no data"):
        port.to_cog(empty, "x.tif", bbox=(0, 0, 4, 4), width=4, height=4, device="cpu")


def test_to_file_over_a_file_source(root):
    """Smooth over a windowed RasterFileSource, exported by both packages:
    the same files, byte for byte."""
    rng = np.random.RandomState(0)
    data = (rng.rand(1, 70, 90) * 100).astype(np.float32)
    data[:, 5:20, 10:40] = -9999.0
    write_geotiff(str(root / "src.tif"), data, (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.5),
                  "EPSG:28992", -9999.0, tiled=True, tile_size=16)
    jax_view = R.Smooth(R.RasterFileSource("src.tif"), 2)
    limits = {"geomodeling.windowed-read-limit": 1000}
    with jax_config.set(limits), config.set(limits):
        jax_numpy_call(R.to_file, jax_view, str(root / "jax" / "out.vrt"), tile_size=32)
        port.to_file(from_reference(jax_view.serialize()), str(root / "port" / "out.vrt"),
                     tile_size=32, device="cpu")
    port_files = files_of(root / "port" / "tiles")
    assert len(port_files) == 9 and port_files == files_of(root / "jax" / "tiles")


# --- windowed VRT reads (tests/test_vrt_window.py) ---


@pytest.fixture
def mosaic(root):
    """A 2x2-tile VRT (each tile 50x50) written through the port's to_file."""
    data = ((np.arange(100 * 100) * 7) % 251).astype("u1").reshape(1, 100, 100)
    source = port.MemorySource(data=data, no_data_value=255, projection="EPSG:28992",
                               pixel_size=1.0, pixel_origin=(0, 100))
    port.to_file(source, str(root / "out.vrt"), tile_size=50, bbox=(0, 0, 100, 100),
                 width=100, height=100, projection="EPSG:28992", device="cpu")
    return str(root / "out.vrt"), data


def _counting_open(monkeypatch):
    opened = []
    original = open

    def counting_open(file, *args, **kwargs):
        if os.fspath(file).endswith(".tif"):
            opened.append(os.fspath(file))
        return original(file, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", counting_open)
    return opened


@pytest.mark.parametrize("window", [(0, 100, 0, 100), (10, 90, 25, 75), (49, 51, 49, 51),
                                    (0, 1, 99, 100)])
def test_vrt_window_equals_whole_slice(mosaic, window):
    path, data = mosaic
    whole = read_vrt(path)
    np.testing.assert_array_equal(whole.array, data)
    r0, r1, c0, c1 = window
    got = read_vrt_window(path, r0, r1, c0, c1)
    np.testing.assert_array_equal(got.array, whole.array[:, r0:r1, c0:c1])
    gt = whole.geo_transform
    assert got.geo_transform == (gt[0] + c0 * gt[1], gt[1], 0, gt[3] + r0 * gt[5], 0, gt[5])
    assert got.no_data_value == whole.no_data_value


def test_vrt_untouched_members_never_open(mosaic, monkeypatch):
    path, _ = mosaic
    opened = _counting_open(monkeypatch)
    assert read_vrt_window(path, 5, 40, 5, 40).array.shape == (1, 35, 35)
    assert len(set(opened)) == 1
    opened.clear()
    info = read_vrt_info(path)
    assert opened == [] and (info.width, info.height) == (100, 100)


def test_vrt_file_source_windowed_equals_whole(mosaic):
    request = dict(mode="vals", bbox=(10.0, 10.0, 90.0, 90.0), projection="EPSG:28992",
                   width=80, height=80)
    source = port.RasterFileSource("out.vrt")
    whole = source.get_data(device="cpu", **request)
    pipeline.clear_read_cache()
    with config.set({"geomodeling.windowed-read-limit": 100}):
        windowed = source.get_data(device="cpu", **request)
        assert source._file_read_plan(request) == (0, (8, 93, 8, 93))
    np.testing.assert_array_equal(whole["values"], windowed["values"])


# --- cloud-optimized GeoTIFFs (tests/test_cog.py) ---


def _ifd_layout(path):
    """[(ifd_file_offset, [tile_offsets...])] along the IFD chain."""
    out = []
    with open(path, "rb") as f:
        header = f.read(4)
        byte_order = "<" if header[:2] == b"II" else ">"
        (magic,) = struct.unpack(byte_order + "H", header[2:4])
        if magic == 43:
            f.seek(8)
            (offset,) = struct.unpack(byte_order + "Q", f.read(8))
        else:
            (offset,) = struct.unpack(byte_order + "I", f.read(4))
        while offset:
            f.seek(offset)
            tags, next_offset = _read_ifd(f, byte_order, magic == 43)
            out.append((offset, list(tags.get(324, []))))
            offset = next_offset
    return out


@pytest.fixture
def checkers():
    y, x = np.mgrid[0:600, 0:700]
    return (((x // 25) + (y // 25)) % 7).astype(np.uint8)[np.newaxis] * 30


@pytest.mark.parametrize("kwargs", [{}, {"overviews": [2, 4]}, {"bigtiff": True, "byte_order": ">"}])
def test_cog_layout(tmp_path, checkers, kwargs):
    path = str(tmp_path / "out.tif")
    write_geotiff(path, checkers, (0.0, 10.0, 0.0, 6000.0, 0.0, -10.0), "EPSG:28992", 255.0,
                  cog=True, **kwargs)
    data = read_geotiff(path)
    np.testing.assert_array_equal(data.array, checkers)
    assert data.geo_transform == (0.0, 10.0, 0.0, 6000.0, 0.0, -10.0)
    layout = _ifd_layout(path)
    assert all(offsets for _, offsets in layout)
    assert min(min(o) for _, o in layout) > max(pos for pos, _ in layout)
    mins = [min(offsets) for _, offsets in layout]
    assert mins == sorted(mins, reverse=True)
    expected = [(350, 300), (175, 150)] if "overviews" in kwargs else [(350, 300)]
    assert read_geotiff_overviews(path) == expected
    for level, (width, height) in enumerate(expected, 1):
        np.testing.assert_array_equal(
            read_geotiff_window(path, 0, height, 0, width, level=level).array,
            checkers[:, :: 2**level, :: 2**level])
    np.testing.assert_array_equal(read_geotiff_window(path, 100, 400, 250, 650).array,
                                  checkers[:, 100:400, 250:650])


@pytest.mark.parametrize("resampling", ["nearest", "average"])
def test_to_cog_as_the_jax_package(root, resampling):
    data = (np.arange(900 * 800, dtype=np.float64) % 251).reshape(1, 900, 800)
    data[:, 100:200, 300:420] = 255.0
    jax_view = R.MemorySource(data=data, no_data_value=255.0, projection="EPSG:28992",
                              pixel_size=0.5, pixel_origin=(155000, 463000)) + 1.0
    jax_numpy_call(R.to_cog, jax_view, "jax.tif", overview_resampling=resampling)
    port.to_cog(from_reference(jax_view.serialize()), "port.tif",
                overview_resampling=resampling, device="cpu")
    with open(root / "jax.tif", "rb") as f, open(root / "port.tif", "rb") as g:
        assert f.read() == g.read()
    out = port.RasterFileSource("port.tif")
    assert out.projection == "EPSG:28992"
    request = dict(mode="vals", projection="EPSG:28992", width=800, height=900,
                   bbox=(155000, 463000 - 450, 155000 + 400, 463000))
    assert_same(out.get_data(device="cpu", **request), jax_numpy(jax_view, request))
    assert read_geotiff_overviews(str(root / "port.tif")) == [(400, 450)]
