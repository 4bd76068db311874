"""The port's Zarr v2 stores (io/zarr.py, the CF helpers of io/netcdf.py),
their dispatch in the read caches and ``RasterFileSource``, and
``to_zarr``, held on the CPU to the JAX package's.

Every case of tests/test_zarr.py and the ``grid.zarr`` cases of
tests/test_format_matrix.py run once in each package (``run_both`` of
tests/test_torch_raster_formats.py): the stores written are
byte-identical, and the payloads, answers and errors the same.  The
writers write the same trees under hypothesis and each package reads
the other's; windows equal the whole read's slice under hypothesis over
hand-built stores (each stdlib compressor, ``/`` keys, missing chunks,
big-endian, south-up, scale/offset); a store above a lowered
``geomodeling.windowed-read-limit`` comes across with ``from_reference``
and answers the JAX numpy executor bitwise, read by window only, its
``info`` decoding no chunk; ``variable`` selects one of two arrays in
both caches; the store stamp sees a chunk rewritten in a subdirectory;
chip_smoke's zarr-store view over a small sheet answers what the
GeoTIFF view answers.
"""
import builtins
import dataclasses
import json
import os
import shutil
import time
import zlib

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.core import Block as JaxBlock
from dask_geomodeling_tpu.io import zarr as jax_zarr
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import evaluate_tiled
from dask_geomodeling_tpu_torch import raster as port_raster
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.core import Block as PortBlock
from dask_geomodeling_tpu_torch.geo import Extent
from dask_geomodeling_tpu_torch.io import zarr
from dask_geomodeling_tpu_torch.runtime import pipeline
from dask_geomodeling_tpu_torch.runtime import tiles as tile_runtime
from tests.test_torch_file_sources import assert_agrees, both_configs
from tests.test_torch_raster_formats import (
    MATRIX_GT,
    MATRIX_PROJECTION,
    MATRIX_VALUES,
    _files,
    _kit,
    assert_same,
    run_both,
)
from tests.test_zarr import GRID, _coords, _mkstore


def _zkit(port):
    """``_kit`` with the package's Zarr module, read caches, Block and
    ``to_zarr`` (the JAX package's on its numpy executor)."""
    kit = _kit(port)
    kit.zarr = zarr if port else jax_zarr
    kit.pipeline = pipeline if port else jax_pipeline
    kit.Block = PortBlock if port else JaxBlock
    if port:
        kit.to_zarr = lambda source, url, **request: port_raster.to_zarr(
            source, url, device="cpu", **request)
    else:
        def to_zarr(source, url, **request):
            with kit.config.set({"geomodeling.executor": "numpy"}):
                jax_raster.to_zarr(source, url, **request)
        kit.to_zarr = to_zarr
    return kit


def run_zarr(tmp_path, case):
    """``run_both`` with the Zarr kits."""
    return run_both(tmp_path, lambda k, root: case(_zkit(k.port), root))


def info_fields(info):
    """A GeoTIFFInfo of either package as a dict, to compare."""
    return dataclasses.asdict(info)


def error(raised, root):
    """A raised error's type and message, its paths made relative."""
    return type(raised.value).__name__, str(raised.value).replace(str(root), "")


class opens_counted:
    """Count the files ``open`` opens whose path ``keep(path)`` selects."""

    def __init__(self, keep):
        self.keep = keep
        self.opened = []

    def __enter__(self):
        self.original = builtins.open

        def counting_open(file, *args, **kwargs):
            if self.keep(os.fspath(file)):
                self.opened.append(os.fspath(file))
            return self.original(file, *args, **kwargs)

        builtins.open = counting_open
        return self

    def __exit__(self, *exc):
        builtins.open = self.original


# --- tests/test_zarr.py, each case in each package ---


def _hand_built_group_store(k, root):
    _mkstore(root / "s.zarr", "rain", GRID, (4, 3),
             {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": -1.0})
    _coords(root / "s.zarr", 100.5 + np.arange(8), 55.5 - np.arange(6))
    data = k.zarr.read_zarr(str(root / "s.zarr"))
    np.testing.assert_array_equal(data.array[0], GRID)
    np.testing.assert_allclose(data.geo_transform, (100.0, 1.0, 0.0, 56.0, 0.0, -1.0))
    assert data.no_data_value == -1.0
    return data


def _missing_chunk_and_south_up(k, root):
    _mkstore(root / "s.zarr", "v", GRID, (4, 4),
             {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": -7.0}, fill_value=-7.0,
             missing=((1, 1),))
    _coords(root / "s.zarr", 0.5 + np.arange(8), 0.5 + np.arange(6))
    data = k.zarr.read_zarr(str(root / "s.zarr"))
    flipped = data.array[0][::-1]
    assert (flipped[4:6, 4:8] == -7.0).all()
    np.testing.assert_array_equal(flipped[:4, :4], GRID[:4, :4])
    assert data.geo_transform[5] == -1.0
    return data


def _slash_separator_and_root_array(k, root):
    _mkstore(root / "bare.zarr", "", GRID, (6, 8), sep="/")
    data = k.zarr.read_zarr(str(root / "bare.zarr"))
    np.testing.assert_array_equal(data.array[0], GRID)
    return data


def _stdlib_compressor(compressor):
    def case(k, root):
        _mkstore(root / "c.zarr", "v", GRID, (6, 8), {"_ARRAY_DIMENSIONS": ["y", "x"]},
                 compressor=compressor)
        _coords(root / "c.zarr", np.arange(8) + 0.5, 5.5 - np.arange(6))
        data = k.zarr.read_zarr(str(root / "c.zarr"))
        np.testing.assert_array_equal(data.array[0], GRID)
        return data
    return case


def _blosc_clear_error(k, root):
    _mkstore(root / "b.zarr", "v", GRID.copy(), (6, 8), {"_ARRAY_DIMENSIONS": ["y", "x"]},
             compressor="blosc")
    with pytest.raises(NotImplementedError, match="blosc") as raised:
        k.zarr.read_zarr(str(root / "b.zarr"))
    return error(raised, root)


def _scale_offset_unpacking(k, root):
    packed = np.arange(12, dtype="<i2").reshape(3, 4)
    _mkstore(root / "p.zarr", "t", packed, (3, 4), {
        "_ARRAY_DIMENSIONS": ["y", "x"], "scale_factor": 0.5, "add_offset": 100.0,
        "_FillValue": 11})
    _coords(root / "p.zarr", np.arange(4) + 0.5, 2.5 - np.arange(3))
    data = k.zarr.read_zarr(str(root / "p.zarr"))
    expected = packed.astype("f4") * 0.5 + 100.0
    out = data.array[0]
    assert out[2, 3] == data.no_data_value
    mask = packed != 11
    np.testing.assert_allclose(out[mask], expected[mask])
    return data


def _writer_roundtrip_and_consolidated(k, root):
    path = str(root / "w.zarr")
    values = (np.arange(2 * 30 * 40) % 200).reshape(2, 30, 40).astype("f8")
    gt = (1000.0, 5.0, 0.0, 2000.0, 0.0, -5.0)
    k.zarr.write_zarr(path, values, gt, projection="EPSG:28992", no_data_value=-9999.0)
    data = k.zarr.read_zarr(path)
    np.testing.assert_array_equal(data.array, values)
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.no_data_value == -9999.0
    assert k.crs.get_epsg_or_wkt(data.projection) == "EPSG:28992"
    for name in ("data", "x", "y", "spatial_ref"):
        os.unlink(os.path.join(path, name, ".zarray"))
    consolidated = k.zarr.read_zarr(path)
    np.testing.assert_array_equal(consolidated.array, values)
    return data, consolidated


def _raster_file_source_integration(k, root):
    values = np.arange(100, dtype="f4").reshape(1, 10, 10)
    k.zarr.write_zarr(str(root / "r.zarr"), values, (0.0, 1.0, 0.0, 10.0, 0.0, -1.0),
                      projection="EPSG:28992", no_data_value=-1.0)
    source = k.R.RasterFileSource("r.zarr")
    assert source.projection == "EPSG:28992"
    out = k.get_data(source, mode="vals", bbox=(0, 0, 10, 10), projection="EPSG:28992",
                     width=10, height=10)
    np.testing.assert_array_equal(out["values"], values)
    assert out["no_data_value"] == -1.0
    return out


def _not_a_store(k, root):
    os.makedirs(str(root / "e.zarr"))
    with pytest.raises(IOError, match="Zarr") as raised:
        k.zarr.read_zarr(str(root / "e.zarr"))
    return error(raised, root)


def _to_zarr_export(k, root):
    data = (np.arange(400, dtype="f8") % 37).reshape(1, 20, 20)
    source = k.R.MemorySource(data=data, no_data_value=255.0, projection="EPSG:28992",
                              pixel_size=2.0, pixel_origin=(1000, 2000))
    k.to_zarr(source + 1.0, "export.zarr")
    back = k.R.RasterFileSource("export.zarr")
    assert back.projection == "EPSG:28992"
    out = k.get_data(back, mode="vals", bbox=(1000, 1960, 1040, 2000),
                     projection="EPSG:28992", width=20, height=20)
    np.testing.assert_array_equal(out["values"], data + 1.0)
    return out


def _window_store(root, south_up=False, scale=False):
    """TestWindowedReads' store: 60 x 80 int16 in 16^2 chunks, one missing."""
    data = ((np.arange(60 * 80) * 7) % 251).astype("<i2").reshape(60, 80)
    attrs = {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": -5}
    if scale:
        attrs.update(scale_factor=0.25, add_offset=10.0)
    _mkstore(root / "big.zarr", "v", data[::-1] if south_up else data, (16, 16), attrs,
             fill_value=-5, missing=((2, 2),))
    _coords(root / "big.zarr", 0.5 + np.arange(80),
            (0.5 + np.arange(60)) if south_up else (59.5 - np.arange(60)))
    return str(root / "big.zarr")


def _window_equals_whole_slice(south_up, scale):
    def case(k, root):
        path = _window_store(root, south_up, scale)
        whole = k.zarr.read_zarr(path)
        windows = []
        for r0, r1, c0, c1 in [(0, 60, 0, 80), (10, 50, 5, 70), (30, 42, 30, 35),
                               (0, 16, 64, 80), (59, 60, 0, 1)]:
            window = k.zarr.read_zarr_window(path, r0, r1, c0, c1)
            np.testing.assert_array_equal(window.array, whole.array[:, r0:r1, c0:c1])
            gt = whole.geo_transform
            np.testing.assert_allclose(window.geo_transform, (
                gt[0] + c0 * gt[1], gt[1], 0.0, gt[3] + r0 * gt[5], 0.0, gt[5]))
            assert window.no_data_value == whole.no_data_value
            windows.append(window)
        return whole, windows
    return case


def _chunk_file(path):
    return os.sep + "v" + os.sep in path and not path.endswith((".zarray", ".zattrs"))


def _window_reads_only_touched_chunks(k, root):
    path = _window_store(root)
    with opens_counted(_chunk_file) as counted:
        window = k.zarr.read_zarr_window(path, 0, 16, 0, 16)
    assert len(counted.opened) == 1
    return window


def _file_source_windowed_equals_whole(k, root):
    _window_store(root)
    request = dict(mode="vals", bbox=(10.0, 10.0, 50.0, 40.0), projection="EPSG:4326",
                   width=40, height=30)
    source = k.R.RasterFileSource("big.zarr")
    whole = k.get_data(source, **request)
    k.pipeline.clear_read_cache()
    with k.config.set({"geomodeling.windowed-read-limit": 100}):
        windowed = k.get_data(source, **request)
    np.testing.assert_array_equal(whole["values"], windowed["values"])
    return windowed


def _info_is_metadata_only(k, root):
    path = _window_store(root)
    whole = k.zarr.read_zarr(path)
    with opens_counted(lambda p: os.sep + "v" + os.sep in p
                       and not os.path.basename(p).startswith(".")) as counted:
        source = k.R.RasterFileSource("big.zarr")
        assert source.projection == "EPSG:4326"
        np.testing.assert_allclose(tuple(source.geo_transform), whole.geo_transform)
        assert source.fillvalue == whole.no_data_value
        assert len(source) == 1
    assert counted.opened == []
    return info_fields(source.info)


def _one_pixel_window_keeps_cell_size(k, root):
    grid = np.arange(100, dtype="<f4").reshape(10, 10)
    _mkstore(root / "cells.zarr", "v", grid, (10, 10), {"_ARRAY_DIMENSIONS": ["y", "x"]})
    _coords(root / "cells.zarr", 1000.0 + 10.0 * (np.arange(10) + 0.5),
            2000.0 - 10.0 * (np.arange(10) + 0.5))
    window = k.zarr.read_zarr_window(str(root / "cells.zarr"), 0, 1, 0, 1)
    np.testing.assert_allclose(window.geo_transform, (1000.0, 10.0, 0.0, 2000.0, 0.0, -10.0))
    assert window.array.shape == (1, 1, 1) and window.array[0, 0, 0] == 0.0
    return window


def _cache_sees_inplace_chunk_rewrites(k, root):
    path = str(root / "mut.zarr")
    k.zarr.write_zarr(path, np.zeros((1, 4, 4), dtype="f8"), (0, 1, 0, 4, 0, -1))
    first = k.pipeline.read_geotiff_cached(path)
    assert (first.array == 0).all()
    time.sleep(0.01)
    with open(os.path.join(path, "data", "0.0.0"), "wb") as f:
        f.write(zlib.compress(np.full((1, 4, 4), 7.0).astype("<f8").tobytes(), 6))
    second = k.pipeline.read_geotiff_cached(path)
    assert (second.array == 7.0).all()
    return first, second


def _info_with_list_valued_fill(k, root):
    grid = np.arange(16, dtype="<i2").reshape(4, 4)
    _mkstore(root / "lf.zarr", "v", grid, (4, 4),
             {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": [-9999]})
    _coords(root / "lf.zarr", np.arange(4) + 0.5, 3.5 - np.arange(4))
    info = k.zarr.read_zarr_info(str(root / "lf.zarr"))
    data = k.zarr.read_zarr(str(root / "lf.zarr"))
    assert info.no_data_value == -9999.0 == data.no_data_value
    return info_fields(info), data


def _variable_selection(k, root):
    rain = np.full((4, 4), 3.0, dtype="<f4")
    temp = np.full((4, 4), 21.0, dtype="<f4")
    _mkstore(root / "multi.zarr", "rain", rain, (4, 4), {"_ARRAY_DIMENSIONS": ["y", "x"]})
    _mkstore(root / "multi.zarr", "temp", temp, (4, 4), {"_ARRAY_DIMENSIONS": ["y", "x"]})
    _coords(root / "multi.zarr", np.arange(4) + 0.5, 3.5 - np.arange(4))
    request = dict(mode="vals", bbox=(0, 0, 4, 4), projection="EPSG:4326", width=4, height=4)
    got_rain = k.get_data(k.R.RasterFileSource("multi.zarr", variable="rain"), **request)
    got_temp = k.get_data(k.R.RasterFileSource("multi.zarr", variable="temp"), **request)
    np.testing.assert_array_equal(got_rain["values"][0], rain)
    np.testing.assert_array_equal(got_temp["values"][0], temp)
    a = k.R.RasterFileSource("x.zarr", variable="rain")
    b = k.R.RasterFileSource("x.zarr", variable="temp")
    assert a.token != b.token
    rebuilt = k.Block.from_json(k.R.RasterFileSource("x.zarr").to_json())
    assert rebuilt.variable is None
    return got_rain, got_temp


def _non_epsg_crs_roundtrip(k, root):
    proj4 = "+proj=sinu +lon_0=10 +a=6371007.181 +b=6371007.181 +units=m"
    path = str(root / "sinu.zarr")
    k.zarr.write_zarr(path, np.zeros((1, 4, 4), "u1"), (0, 1, 0, 4, 0, -1), projection=proj4)
    back = k.zarr.read_zarr(path)
    a = k.crs.get_transform_func("EPSG:4326", proj4)(np.array([12.0]), np.array([45.0]))
    b = k.crs.get_transform_func("EPSG:4326", back.projection)(np.array([12.0]),
                                                                np.array([45.0]))
    np.testing.assert_allclose(a, b, atol=1e-6)
    return back, tuple(np.asarray(v) for v in b)


JAX_CASES = {
    "hand-built-group-store": _hand_built_group_store,
    "missing-chunk-and-south-up": _missing_chunk_and_south_up,
    "slash-separator-and-root-array": _slash_separator_and_root_array,
    "stdlib-compressor-bz2": _stdlib_compressor("bz2"),
    "stdlib-compressor-lzma": _stdlib_compressor("lzma"),
    "stdlib-compressor-none": _stdlib_compressor(None),
    "blosc-clear-error": _blosc_clear_error,
    "scale-offset-unpacking": _scale_offset_unpacking,
    "writer-roundtrip-and-consolidated": _writer_roundtrip_and_consolidated,
    "raster-file-source-integration": _raster_file_source_integration,
    "not-a-store": _not_a_store,
    "to-zarr-export": _to_zarr_export,
    "window-equals-whole-slice": _window_equals_whole_slice(False, False),
    "window-equals-whole-slice-scale": _window_equals_whole_slice(False, True),
    "window-equals-whole-slice-south-up": _window_equals_whole_slice(True, False),
    "window-equals-whole-slice-south-up-scale": _window_equals_whole_slice(True, True),
    "window-reads-only-touched-chunks": _window_reads_only_touched_chunks,
    "file-source-windowed-equals-whole": _file_source_windowed_equals_whole,
    "info-is-metadata-only": _info_is_metadata_only,
    "one-pixel-window-keeps-cell-size": _one_pixel_window_keeps_cell_size,
    "cache-sees-inplace-chunk-rewrites": _cache_sees_inplace_chunk_rewrites,
    "info-with-list-valued-fill": _info_with_list_valued_fill,
    "variable-selection": _variable_selection,
    "non-epsg-crs-roundtrip": _non_epsg_crs_roundtrip,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_zarr.py, run in each package."""
    run_zarr(tmp_path, JAX_CASES[name])


# --- the grid.zarr cases of tests/test_format_matrix.py ---


def _matrix_zarr(k, root):
    k.zarr.write_zarr(str(root / "grid.zarr"), MATRIX_VALUES, MATRIX_GT,
                      projection=MATRIX_PROJECTION, no_data_value=255.0)


def _matrix_native(k, root):
    _matrix_zarr(k, root)
    source = k.R.RasterFileSource("grid.zarr")
    np.testing.assert_allclose(tuple(source.geo_transform), MATRIX_GT)
    data = k.get_data(source, mode="vals", projection=MATRIX_PROJECTION, width=128, height=96,
                      bbox=(MATRIX_GT[0], MATRIX_GT[3] - 96 * 2.0, MATRIX_GT[0] + 128 * 2.0,
                            MATRIX_GT[3]))
    np.testing.assert_array_equal(data["values"], MATRIX_VALUES)
    assert data["values"].dtype == MATRIX_VALUES.dtype
    return data


def _matrix_cross_crs(k, root):
    from dask_geomodeling_tpu.io.geotiff import write_geotiff

    _matrix_zarr(k, root)
    write_geotiff(str(root / "reference.tif"), MATRIX_VALUES, MATRIX_GT, MATRIX_PROJECTION, 255.0)
    x1, y1 = MATRIX_GT[0] + 30.0, MATRIX_GT[3] - 96 * 2.0 + 30.0
    x2, y2 = MATRIX_GT[0] + 128 * 2.0 - 30.0, MATRIX_GT[3] - 30.0
    bbox = k.crs.transform_extent((x1, y1, x2, y2), MATRIX_PROJECTION, "EPSG:4326")
    request = dict(mode="vals", bbox=bbox, projection="EPSG:4326", width=64, height=48)
    result = k.get_data(k.R.RasterFileSource("grid.zarr"), **request)
    reference = k.get_data(k.R.RasterFileSource("reference.tif"), **request)
    np.testing.assert_array_equal(result["values"], reference["values"])
    return result


@pytest.mark.parametrize("matrix", [_matrix_native, _matrix_cross_crs],
                         ids=["format_matrix", "format_matrix_cross_crs_consistency"])
def test_format_matrix_case(tmp_path, matrix):
    run_zarr(tmp_path, matrix)


# --- the writers' bytes, and each package reading the other's stores ---

SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])
DTYPES = ["f8", "f4", "u1", "i1", "i2", "u2", "i4", "u4", "i8", ">f4", ">i2"]


def _tree(root):
    return {name: (root / name).read_bytes() for name in _files(root)}


@SETTINGS
@given(dtype=st.sampled_from(DTYPES), bands=st.integers(1, 3), height=st.integers(1, 9),
       width=st.integers(1, 9), seed=st.integers(0, 2**32 - 1),
       nodata=st.sampled_from([None, 0.0, -1.0, 255.0]),
       projection=st.sampled_from([None, "EPSG:28992", "EPSG:4326", "EPSG:3857"]))
def test_writer_bytes_and_each_package_reads_the_other(tmp_path, dtype, bands, height, width,
                                                       seed, nodata, projection):
    values = (np.random.RandomState(seed).rand(bands, height, width) * 120).astype(dtype)
    gt = (155000.0, 0.5, 0.0, 463000.0, 0.0, -0.5)
    trees = {}
    for side, module in (("jax", jax_zarr), ("port", zarr)):
        path = tmp_path / side / "w.zarr"
        shutil.rmtree(str(path), ignore_errors=True)
        module.write_zarr(str(path), values, gt, projection=projection, no_data_value=nodata)
        trees[side] = _tree(path)
    assert trees["port"] == trees["jax"]
    expected = jax_zarr.read_zarr(str(tmp_path / "port" / "w.zarr"))
    assert_same(zarr.read_zarr(str(tmp_path / "jax" / "w.zarr")), expected)
    assert_same(info_fields(zarr.read_zarr_info(str(tmp_path / "jax" / "w.zarr"))),
                info_fields(jax_zarr.read_zarr_info(str(tmp_path / "port" / "w.zarr"))))
    np.testing.assert_array_equal(expected.array, values)


# --- windows against the whole read, under hypothesis ---


@st.composite
def _stores(draw):
    height, width = draw(st.integers(1, 40)), draw(st.integers(1, 40))
    chunks = (draw(st.integers(1, 16)), draw(st.integers(1, 16)))
    grid_shape = (-(-height // chunks[0]), -(-width // chunks[1]))
    missing = draw(st.sets(st.tuples(st.integers(0, grid_shape[0] - 1),
                                     st.integers(0, grid_shape[1] - 1)), max_size=3))
    r0, r1 = sorted(draw(st.lists(st.integers(0, height), min_size=2, max_size=2)))
    c0, c1 = sorted(draw(st.lists(st.integers(0, width), min_size=2, max_size=2)))
    return dict(
        shape=(height, width), chunks=chunks, missing=tuple(missing),
        dtype=draw(st.sampled_from(["<f4", ">f4", "<i2", ">i2", "<u1", "<f8"])),
        compressor=draw(st.sampled_from(["zlib", "bz2", "lzma", None])),
        sep=draw(st.sampled_from([".", "/"])), south_up=draw(st.booleans()),
        scale=draw(st.booleans()), seed=draw(st.integers(0, 2**32 - 1)),
        window=(r0, r1, c0, c1))


@SETTINGS
@given(store=_stores())
def test_window_equals_whole_slice_hypothesis(tmp_path, store):
    """Each package reads the hand-built store's window as the slice of
    its whole read, and the two packages alike."""
    root = tmp_path / ("s%d.zarr" % store["seed"])
    shutil.rmtree(str(root), ignore_errors=True)
    height, width = store["shape"]
    data = (np.random.RandomState(store["seed"]).rand(height, width) * 100).astype(store["dtype"])
    attrs = {"_ARRAY_DIMENSIONS": ["y", "x"], "_FillValue": 7}
    if store["scale"]:
        attrs.update(scale_factor=0.5, add_offset=-3.0)
    _mkstore(root, "v", data[::-1] if store["south_up"] else data, store["chunks"], attrs,
             compressor=store["compressor"], sep=store["sep"], fill_value=7,
             missing=store["missing"])
    ys = (0.5 + np.arange(height)) if store["south_up"] else (height - 0.5 - np.arange(height))
    _coords(root, 0.5 + np.arange(width), ys)
    r0, r1, c0, c1 = store["window"]
    whole = jax_zarr.read_zarr(str(root))
    assert_same(zarr.read_zarr(str(root)), whole)
    window = jax_zarr.read_zarr_window(str(root), r0, r1, c0, c1)
    assert_same(zarr.read_zarr_window(str(root), r0, r1, c0, c1), window)
    if r1 > r0 and c1 > c0:
        np.testing.assert_array_equal(window.array, whole.array[:, r0:r1, c0:c1])
    assert_same(info_fields(zarr.read_zarr_info(str(root))),
                info_fields(jax_zarr.read_zarr_info(str(root))))


# --- RasterFileSource over a store read by window ---

STORE_LIMIT = 2000


def _sheet_store(root, name="sheet.zarr", projection="EPSG:28992"):
    """The 90 x 120 sheet of tests/test_torch_file_sources.py as the JAX
    writer writes it, then rechunked by hand into 16 x 24 chunks with "/"
    keys, so that a window touches only some chunks."""
    from tests.test_torch_file_sources import CELL, NODATA, ORIGIN, sheet

    values = sheet()[0]
    path = root / name
    _mkstore(path, "data", values, (16, 24), {"_ARRAY_DIMENSIONS": ["y", "x"],
                                               "_FillValue": NODATA, "grid_mapping": "spatial_ref"},
             sep="/", fill_value=NODATA)
    height, width = values.shape
    _coords(path, ORIGIN[0] + CELL * (np.arange(width) + 0.5),
            ORIGIN[1] - CELL * (np.arange(height) + 0.5))
    _mkstore(path, "spatial_ref", np.zeros((), "<i4"), (), {
        "_ARRAY_DIMENSIONS": [], "spatial_ref": _wkt(projection)}, compressor=None)
    return name, values


def _wkt(projection):
    from dask_geomodeling_tpu.geo.crs import get_sr

    return get_sr(projection).ExportToWkt()


def test_file_source_by_window_against_jax_numpy(tmp_path, monkeypatch):
    """Above a lowered windowed-read-limit the store is read by window
    only (no whole read, no whole-read cache entry), Smooth over it
    answers the JAX numpy executor bitwise at its CRS and in EPSG:3857,
    and info decodes no chunk; the CRS reads back as EPSG:28992."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    name, _ = _sheet_store(tmp_path)
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": STORE_LIMIT}):
        def refuse(raw, compressor):  # the coordinate arrays are stored raw
            if compressor is not None:
                raise AssertionError("info decoded a chunk")
            return raw

        with monkeypatch.context() as patch:
            patch.setattr(zarr, "_decompress", refuse)
            patch.setattr(jax_zarr, "_decompress", refuse)
            port_source = port_raster.RasterFileSource(name)
            jax_source = jax_raster.RasterFileSource(name)
            assert info_fields(port_source.info) == info_fields(jax_source.info)
            assert port_source.projection == jax_source.projection == "EPSG:28992"
        whole = []
        monkeypatch.setattr(zarr, "read_zarr", lambda *a, **k: whole.append(a))
        x1, y1, _, _ = jax_source.geometry.bounds
        same_crs = dict(mode="vals", projection="EPSG:28992", width=37, height=29,
                        bbox=(x1 + 3.0, y1 + 5.0, x1 + 21.5, y1 + 19.5))
        bbox_3857 = Extent((x1 + 4, y1 + 4, x1 + 30, y1 + 24),
                           "EPSG:28992").transformed("EPSG:3857").bbox
        web = dict(mode="vals", projection="EPSG:3857", width=33, height=27, bbox=bbox_3857)
        for request in (same_crs, web):
            assert port_source._file_read_plan(request) is not None
            for view in (jax_source, jax_raster.Smooth(jax_source, 1.5)):
                assert_agrees(view, request)
        assert whole == [] and not any(key[0] == str(tmp_path / name)
                                       for key in pipeline._READ_CACHE)


def test_store_tiles_batch_as_the_geotiff_does(tmp_path):
    """evaluate_tiled over a windowed store runs as many batches as over
    the GeoTIFF of the same grid, bitwise to it tile for tile."""
    from tests.test_torch_file_sources import write

    pipeline.clear_read_cache()
    name, values = _sheet_store(tmp_path)
    tif = write(tmp_path, "sheet.tif", values[None])
    with config.set({"geomodeling.root": str(tmp_path),
                     "geomodeling.windowed-read-limit": STORE_LIMIT}):
        answers = {}
        for url in (name, tif):
            source = port_raster.RasterFileSource(url)
            x1, y1, x2, y2 = source.geometry.bounds
            request = dict(mode="vals", projection="EPSG:28992", width=120, height=90,
                           bbox=(x1, y1, x2, y2))
            view = port_raster.Smooth(source, 1.5)
            before = tile_runtime.batches_run
            answers[url] = evaluate_tiled(view, request, tile_size=32, batch=4, device="cpu")
            answers[url]["batches"] = tile_runtime.batches_run - before
    assert answers[name]["batches"] == answers[tif]["batches"] == 3
    np.testing.assert_array_equal(answers[name]["values"], answers[tif]["values"])


def test_two_variables_in_one_store_and_both_caches(tmp_path):
    """``variable`` selects each array through the whole-read cache and
    the window cache, and neither cache hands one out for the other."""
    pipeline.clear_read_cache()
    path = tmp_path / "multi.zarr"
    rain = (np.arange(48 * 40, dtype="<f4") % 13).reshape(48, 40)
    temp = rain + 100
    for var, grid in (("rain", rain), ("temp", temp)):
        _mkstore(path, var, grid, (16, 16), {"_ARRAY_DIMENSIONS": ["y", "x"]})
    _coords(path, np.arange(40) + 0.5, 47.5 - np.arange(48))
    for var, grid in (("rain", rain), ("temp", temp)):
        np.testing.assert_array_equal(pipeline.read_geotiff_cached(str(path), var).array[0], grid)
        window = pipeline.read_geotiff_window_cached(str(path), 3, 20, 5, 30, variable=var)
        np.testing.assert_array_equal(window.array[0], grid[3:20, 5:30])
    assert pipeline.read_geotiff_cached(str(path), "rain") is pipeline.read_geotiff_cached(
        str(path), "rain")
    request = dict(mode="vals", bbox=(2.0, 5.0, 30.0, 40.0), projection="EPSG:4326", width=28,
                   height=35)
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 100}):
        for var, grid in (("rain", rain), ("temp", temp)):
            view, expected = assert_agrees(jax_raster.RasterFileSource("multi.zarr", variable=var),
                                           request)
            np.testing.assert_array_equal(expected["values"][0], grid[8:43, 2:30])


def test_stamp_sees_a_chunk_rewritten_in_a_subdirectory(tmp_path):
    """A chunk under "/" keys (data/1/0) rewritten in place invalidates
    the whole-read and the window entries; neither the root directory's
    mtime nor any metadata document changes."""
    pipeline.clear_read_cache()
    path = tmp_path / "nested.zarr"
    grid = np.arange(32 * 32, dtype="<f4").reshape(32, 32)
    _mkstore(path, "data", grid, (16, 16), {"_ARRAY_DIMENSIONS": ["y", "x"]}, sep="/")
    _coords(path, np.arange(32) + 0.5, 31.5 - np.arange(32))
    whole = pipeline.read_geotiff_cached(str(path))
    window = pipeline.read_geotiff_window_cached(str(path), 10, 30, 0, 20)
    assert pipeline.read_geotiff_cached(str(path)) is whole
    assert pipeline.read_geotiff_window_cached(str(path), 10, 30, 0, 20) is window
    root_stamp = os.stat(str(path)).st_mtime_ns
    chunk = path / "data" / "1" / "0"
    time.sleep(0.01)
    chunk.write_bytes(zlib.compress(np.full((16, 16), -3, "<f4").tobytes(), 1))
    assert os.stat(str(path)).st_mtime_ns == root_stamp
    whole_after = pipeline.read_geotiff_cached(str(path))
    window_after = pipeline.read_geotiff_window_cached(str(path), 10, 30, 0, 20)
    assert (whole_after.array[0, 16:, :16] == -3).all()
    assert (window_after.array[0, 6:, :16] == -3).all()
    np.testing.assert_array_equal(window_after.array[0, :6], grid[10:16, :20])
    assert_same(whole_after, jax_pipeline.read_geotiff_cached(str(path)))


@pytest.mark.parametrize("limit", [3, 8, 8192])
def test_zarr_stamp_as_the_jax_package(tmp_path, monkeypatch, limit):
    """The stamp walk as the JAX package's, at the default entry budget
    and past a lowered one (the coarse stamp)."""
    path = tmp_path / "s.zarr"
    _mkstore(path, "v", GRID, (2, 2), {"_ARRAY_DIMENSIONS": ["y", "x"]}, sep="/")
    monkeypatch.setattr(pipeline, "_ZARR_STAMP_LIMIT", limit)
    monkeypatch.setattr(jax_pipeline, "_ZARR_STAMP_LIMIT", limit)
    stamp = pipeline._zarr_stamp(str(path))
    assert stamp == jax_pipeline._zarr_stamp(str(path))
    assert (stamp[0] == "coarse") == (limit < 8192)
    assert pipeline._store_stamp(str(path)) == jax_pipeline._raster_stamp(str(path))


def test_netcdf_still_names_its_module(tmp_path):
    """Every netCDF suffix reads a CDF-1 file through the read cache, as
    the JAX package's reads it."""
    from dask_geomodeling_tpu.io.netcdf import write_netcdf

    values = np.arange(12, dtype="f4").reshape(1, 3, 4)
    for suffix in (".nc", ".cdf", ".nc3", ".nc4", ".h5", ".hdf5"):
        path = str(tmp_path / ("a" + suffix))
        write_netcdf(path, values, (0.0, 1.0, 0.0, 3.0, 0.0, -1.0), no_data_value=-1.0)
        assert_same(pipeline.read_geotiff_cached(path), jax_pipeline.read_geotiff_cached(path))


# --- chip_smoke's zarr-store helper, small ---


def test_sheet_store_answers_what_the_geotiff_answers(tmp_path):
    """chip_smoke.write_sheet_zarr over a small sheet: the JAX package
    reads the same payload; file-read's view over the store, read by
    window, answers what it answers over the GeoTIFF, bitwise, and the
    JAX numpy executor agrees on a tile."""
    sheet = chip_smoke.write_sheet(str(tmp_path), width=300, height=200, block=40)
    store, size = chip_smoke.write_sheet_zarr(str(tmp_path), sheet, chunk=64)
    assert size > 0 and sorted(os.listdir(store)) == [
        ".zattrs", ".zgroup", ".zmetadata", chip_smoke.ZARR_VARIABLE, "spatial_ref", "x", "y"]
    with open(os.path.join(store, ".zmetadata")) as f:
        assert json.load(f)["zarr_consolidated_format"] == 1
    assert_same(zarr.read_zarr(store), jax_zarr.read_zarr(store))
    pipeline.clear_read_cache()
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 10_000}):
        view, request, _, _ = chip_smoke.build_file_paths(sheet, reproject_px=64)["file-read"]
        source = port_raster.RasterFileSource(store)
        assert source.projection == "EPSG:28992"
        assert tuple(source.geo_transform) == tuple(view.store.geo_transform)
        assert source._file_read_plan(request) is not None
        zarr_view = port_raster.Smooth(source, 3)
        got = evaluate_tiled(zarr_view, request, tile_size=128, batch=4, device="cpu")
        want = evaluate_tiled(view, request, tile_size=128, batch=4, device="cpu")
        np.testing.assert_array_equal(got["values"], want["values"])
        tile = dict(request, width=128, height=128, bbox=chip_smoke.sheet_sub_area(request, 128))
        assert_agrees(jax_raster.Smooth(jax_raster.RasterFileSource(store), 3), tile)
