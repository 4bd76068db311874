"""The port's raster tile pyramids (io/gpkg_raster.py, io/mbtiles.py), their
dispatch in the read cache and ``RasterFileSource``, and Block pickling with
the token normalizer registry, held on the CPU to the JAX package's.

Every case of ``TestGpkgRaster`` and ``TestMbtiles``
(tests/test_png_netcdf.py) runs once in each package (``run_pyramids``, the
``run_both`` of tests/test_torch_raster_formats.py for SQLite files): the
files written hold the same tables row for row, tile blobs byte for byte,
and the payloads, answers and errors are the same (arrays bitwise with
their dtypes).  A WebP or JPEG tile, which the JAX package decodes with
Pillow, raises NotImplementedError naming its JAX module in the port.
Under hypothesis, uint8 and uint16 frames of 1-4 bands (GeoPackage origins
on and off the tile grid, MBTiles origins on the zoom ladder and inside a
tile) give equal tables and payloads from both writers, and sparse
pyramids with mixed gray and RGB tiles read alike.  A ``RasterFileSource``
over each format comes across with ``from_reference`` and answers the JAX
numpy executor bitwise; chip_smoke's tile-pyramids writers and view at a
small size answer as the JAX package's, the GeoPackage's answer equal to
hfa-roughness'.  Pickling: the JAX package's ``test_pickle`` case in both
packages, a view through a worker process, and a registered normalizer's
precedence over ``__token__`` with the same tokens in both packages.
"""
import os
import pickle
import sqlite3
import subprocess
import sys
import tempfile
import types
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.core import tokens as jax_tokens
from dask_geomodeling_tpu.io import gpkg_raster as jax_gpkg
from dask_geomodeling_tpu.io import mbtiles as jax_mbtiles
from dask_geomodeling_tpu.io import pam as jax_pam
from dask_geomodeling_tpu.io import png as jax_png
from dask_geomodeling_tpu.io import vectorfile as jax_vectorfile
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import evaluate_tiled
from dask_geomodeling_tpu_torch.core import Block, tokens
from dask_geomodeling_tpu_torch.io import gpkg_raster, mbtiles, png, vectorfile
from dask_geomodeling_tpu_torch.runtime import pipeline
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests
from tests import test_core
from tests.test_png_netcdf import TestMbtiles as JaxTestMbtiles
from tests.test_torch_file_sources import assert_agrees, both_configs
from tests.test_torch_raster_formats import _files, _kit, assert_same, same_crs_history
from tests.test_torch_vector_formats import sqlite_contents

RES = JaxTestMbtiles.RES
ORIGIN = 20037508.342789244
START = datetime(2000, 1, 1)


def _pkit(port):
    """``_kit`` with the package's pyramid, PNG and vector modules."""
    kit = _kit(port)
    kit.gpkg = gpkg_raster if port else jax_gpkg
    kit.mbtiles = mbtiles if port else jax_mbtiles
    kit.png = png if port else jax_png
    kit.vf = vectorfile if port else jax_vectorfile
    return kit


def assert_same_files(ours, theirs):
    """Two files alike: SQLite files table for table and row for row (tile
    blobs byte for byte), any other byte for byte."""
    if ours.endswith((".gpkg", ".mbtiles")):
        assert sqlite_contents(ours) == sqlite_contents(theirs), ours
    else:
        with open(ours, "rb") as a, open(theirs, "rb") as b:
            assert a.read() == b.read(), ours


def run_pyramids(tmp_path, case):
    """Run ``case(kit, root)`` for the JAX package in ``tmp_path/jax`` and
    for the port in ``tmp_path/port`` (each its ``geomodeling.root``), from
    the same CRS history: the same files come out (``assert_same_files``)
    and the same results; returns the port's."""
    results = {}
    with same_crs_history():
        for side in ("jax", "port"):
            root = tmp_path / side
            root.mkdir()
            kit = _pkit(side == "port")
            pipeline.clear_read_cache()
            jax_pipeline.clear_read_cache()
            with kit.config.set({"geomodeling.root": str(root)}):
                results[side] = case(kit, root)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port")
    for name in names:
        assert_same_files(str(tmp_path / "port" / name), str(tmp_path / "jax" / name))
    assert_same(results["port"], results["jax"])
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    return results["port"]


def raised(call, root):
    """``call()``'s error: its type's name and its message, paths made
    relative to ``root``."""
    try:
        call()
    except Exception as error:  # the same error in both packages
        return type(error).__name__, str(error).replace(str(root), "")
    raise AssertionError("no error raised")


def _grid_aligned_gt(col, row_xyz, px_off=0, py_off=0):
    return JaxTestMbtiles()._grid_aligned_gt(col, row_xyz, px_off, py_off)


# --- tests/test_png_netcdf.py: TestGpkgRaster ---


def _gpkg_roundtrip_via_file_source(k, root):
    values = np.arange(3 * 300 * 520, dtype=np.uint8).reshape(3, 300, 520) % 251
    gt = (10000.0, 2.0, 0.0, 50000.0, 0.0, -2.0)
    path = str(root / "tiles.gpkg")
    k.gpkg.write_gpkg_raster(path, values, gt, projection="EPSG:28992")
    data = k.gpkg.read_gpkg_raster(path)
    assert data.array.shape == (3, 512, 768)
    np.testing.assert_array_equal(data.array[:, :300, :520], values)
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.projection == "EPSG:28992"
    source = k.R.RasterFileSource("tiles.gpkg", time_first=START)
    assert source.projection == "EPSG:28992"
    result = k.get_data(source, mode="vals", bbox=(10000.0, 50000.0 - 64.0, 10064.0, 50000.0),
                        projection="EPSG:28992", width=32, height=32, start=START)
    np.testing.assert_array_equal(result["values"], values[:1, :32, :32])
    return data, result


def _gpkg_sparse_pyramid_offsets(k, root):
    values = np.ones((1, 256, 256), dtype=np.uint8)
    gt = (0.0, 1.0, 0.0, 1024.0, 0.0, -1.0)
    path = str(root / "sparse.gpkg")
    k.gpkg.write_gpkg_raster(path, values, gt, projection="EPSG:28992")
    con = sqlite3.connect(path)
    con.execute("UPDATE tiles SET tile_column = 2, tile_row = 3")
    con.commit()
    con.close()
    data = k.gpkg.read_gpkg_raster(path)
    assert data.array.shape == (1, 256, 256)
    np.testing.assert_allclose(data.geo_transform, (512.0, 1.0, 0.0, 1024.0 - 768.0, 0.0, -1.0))
    return data


def _features_gpkg(k, path):
    """A GeoPackage of one feature, written by the package's vector writer."""
    if k.port:
        from dask_geomodeling_tpu_torch.geo.features import GeoDataFrame
        from dask_geomodeling_tpu_torch.geo.geometry import box

        frame = GeoDataFrame({"v": [1], "geometry": [box(0, 0, 1, 1)]}, crs="EPSG:4326")
    else:
        import pandas as pd

        from dask_geomodeling_tpu.geo.features import GeoDataFrame
        from dask_geomodeling_tpu.geo.geometry import box

        frame = GeoDataFrame(pd.DataFrame({"v": [1]}), geometry=[box(0, 0, 1, 1)],
                             crs="EPSG:4326")
    k.vf.write_vector(frame, path)


def _gpkg_vector_still_reads_as_vector(k, root):
    path = str(root / "vec.gpkg")
    _features_gpkg(k, path)
    assert not k.gpkg.is_raster_gpkg(path)
    # a raster reader reads a .gpkg as tiles: a GeoPackage of features raises
    errors = (raised(lambda: k.R.RasterFileSource("vec.gpkg").info, root),
              raised(lambda: k.gpkg.read_gpkg_raster(path, layer="tiles"), root))
    os.remove(path)  # its contents are the vector writers' (stamped with the time of writing)
    return errors


def _gpkg_named_layer(k, root):
    values = np.full((1, 20, 30), 5, np.uint8)
    path = str(root / "layers.gpkg")
    k.gpkg.write_gpkg_raster(path, values, (0.0, 1.0, 0.0, 20.0, 0.0, -1.0), layer="lgn",
                             tile_size=16)
    data = k.gpkg.read_gpkg_raster(path, layer="lgn")
    assert data.array.shape == (1, 32, 32) and data.projection is None
    return data, raised(lambda: k.gpkg.read_gpkg_raster(path, layer="other"), root)


# --- tests/test_png_netcdf.py: TestMbtiles ---


def _mb_roundtrip_via_file_source(k, root):
    values = np.arange(3 * 300 * 520, dtype=np.uint8).reshape(3, 300, 520) % 251
    gt = _grid_aligned_gt(col=520, row_xyz=330)
    path = str(root / "tiles.mbtiles")
    k.mbtiles.write_mbtiles(path, values, gt, projection="EPSG:3857")
    data = k.mbtiles.read_mbtiles(path)
    assert data.array.shape == (3, 512, 768)
    np.testing.assert_array_equal(data.array[:, :300, :520], values)
    np.testing.assert_allclose(data.geo_transform, gt, rtol=1e-12)
    assert data.projection == "EPSG:3857"
    source = k.R.RasterFileSource("tiles.mbtiles", time_first=START)
    assert source.projection == "EPSG:3857"
    result = k.get_data(source, mode="vals",
                        bbox=(gt[0], gt[3] - 32 * RES, gt[0] + 32 * RES, gt[3]),
                        projection="EPSG:3857", width=32, height=32, start=START)
    np.testing.assert_array_equal(result["values"], values[:1, :32, :32])
    return data, result


def _mb_mid_tile_origin_pads_to_boundary(k, root):
    values = np.full((1, 100, 100), 7, dtype=np.uint8)
    gt = _grid_aligned_gt(col=100, row_xyz=200, px_off=40, py_off=60)
    path = str(root / "offset.mbtiles")
    k.mbtiles.write_mbtiles(path, values, gt)
    data = k.mbtiles.read_mbtiles(path)
    np.testing.assert_array_equal(data.array[0, 60:160, 40:140], values[0])
    assert data.array[0, 0, 0] == 0
    np.testing.assert_allclose(data.geo_transform[0], gt[0] - 40 * RES, rtol=1e-12)
    np.testing.assert_allclose(data.geo_transform[3], gt[3] + 60 * RES, rtol=1e-12)
    return data


def _mb_tms_row_flip(k, root):
    top = np.full((1, 256, 256), 9, dtype=np.uint8)
    bottom = np.full((1, 256, 256), 4, dtype=np.uint8)
    values = np.concatenate([top, bottom], axis=1)
    path = str(root / "rows.mbtiles")
    k.mbtiles.write_mbtiles(path, values, _grid_aligned_gt(col=12, row_xyz=34))
    con = sqlite3.connect(path)
    rows = dict(con.execute("SELECT tile_row, tile_data FROM tiles").fetchall())
    con.close()
    assert len(rows) == 2 and max(rows) == min(rows) + 1
    data = k.mbtiles.read_mbtiles(path)
    assert (data.array[0, :256] == 9).all() and (data.array[0, 256:] == 4).all()
    return data, sorted(rows)


def _mb_metadata_and_validation(k, root):
    values = np.ones((1, 256, 256), dtype=np.uint8)
    gt = _grid_aligned_gt(col=512, row_xyz=512)
    path = str(root / "meta.mbtiles")
    k.mbtiles.write_mbtiles(path, values, gt, name="rain")
    con = sqlite3.connect(path)
    meta = dict(con.execute("SELECT name, value FROM metadata"))
    con.close()
    assert meta["format"] == "png" and meta["minzoom"] == meta["maxzoom"] == "10"
    w, s, e, n = [float(v) for v in meta["bounds"].split(",")]
    assert w == 0.0 and n == 0.0 and 0 < e < 1 and -1 < s < 0
    errors = [
        raised(lambda: k.mbtiles.write_mbtiles(str(root / "x.mbtiles"), values, gt,
                                               projection="EPSG:28992"), root),
        raised(lambda: k.mbtiles.write_mbtiles(str(root / "y.mbtiles"), values,
                                               (0, 123.456, 0, 0, 0, -123.456)), root),
    ]
    vt = str(root / "vec.mbtiles")
    con = sqlite3.connect(vt)
    con.execute("CREATE TABLE metadata (name TEXT, value TEXT)")
    con.execute("INSERT INTO metadata VALUES ('format', 'pbf')")
    con.commit()
    con.close()
    errors.append(raised(lambda: k.mbtiles.read_mbtiles(vt), root))
    assert "Web Mercator" in errors[0][1] and "zoom ladder" in errors[1][1]
    assert "vector tiles" in errors[2][1]
    return meta, errors, k.mbtiles.read_mbtiles(path).metadata


def _mb_mixed_grayscale_and_rgb_tiles(k, root):
    values = np.full((1, 256, 512), 7, dtype=np.uint8)
    path = str(root / "mixed.mbtiles")
    k.mbtiles.write_mbtiles(path, values, _grid_aligned_gt(col=3, row_xyz=5))
    rgb = np.zeros((3, 256, 256), dtype=np.uint8)
    rgb[0], rgb[1], rgb[2] = 200, 100, 50
    con = sqlite3.connect(path)
    (max_col,) = con.execute("SELECT MAX(tile_column) FROM tiles").fetchone()
    con.execute("UPDATE tiles SET tile_data = ? WHERE tile_column = ?",
                (k.png.write_png_bytes(rgb), max_col))
    con.commit()
    con.close()
    data = k.mbtiles.read_mbtiles(path)
    assert data.array.shape == (3, 256, 512)
    assert (data.array[:, :, :256] == 7).all()
    assert (data.array[0, :, 256:] == 200).all() and (data.array[2, :, 256:] == 50).all()
    return data


def _mb_all_zero_data_roundtrips(k, root):
    values = np.zeros((1, 256, 512), dtype=np.uint8)
    values[0, 10, 300] = 1
    gt = _grid_aligned_gt(col=9, row_xyz=9)
    path = str(root / "zeros.mbtiles")
    k.mbtiles.write_mbtiles(path, values, gt)
    data = k.mbtiles.read_mbtiles(path)
    assert data.array.shape == (1, 256, 512)
    np.testing.assert_allclose(data.geo_transform, gt, rtol=1e-12)
    np.testing.assert_array_equal(data.array, values)
    return data


def _mb_not_mbtiles(k, root):
    empty = str(root / "empty.mbtiles")
    con = sqlite3.connect(empty)
    con.execute("CREATE TABLE tiles (zoom_level INTEGER, tile_column INTEGER, "
                "tile_row INTEGER, tile_data BLOB)")
    con.commit()
    con.close()
    sqlite3.connect(str(root / "bare.mbtiles")).close()
    return (raised(lambda: k.mbtiles.read_mbtiles(empty), root),
            raised(lambda: k.mbtiles.read_mbtiles(str(root / "bare.mbtiles")), root))


JAX_CASES = {
    "gpkg-roundtrip-via-file-source": _gpkg_roundtrip_via_file_source,
    "gpkg-sparse-pyramid-offsets": _gpkg_sparse_pyramid_offsets,
    "gpkg-vector-still-reads-as-vector": _gpkg_vector_still_reads_as_vector,
    "gpkg-named-layer": _gpkg_named_layer,
    "mbtiles-roundtrip-via-file-source": _mb_roundtrip_via_file_source,
    "mbtiles-mid-tile-origin-pads": _mb_mid_tile_origin_pads_to_boundary,
    "mbtiles-tms-row-flip": _mb_tms_row_flip,
    "mbtiles-metadata-and-validation": _mb_metadata_and_validation,
    "mbtiles-mixed-gray-and-rgb": _mb_mixed_grayscale_and_rgb_tiles,
    "mbtiles-all-zero-data": _mb_all_zero_data_roundtrips,
    "mbtiles-not-mbtiles": _mb_not_mbtiles,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of the JAX package's pyramid tests, run in each package."""
    run_pyramids(tmp_path, JAX_CASES[name])


# --- JPEG and WebP tiles: Pillow in the JAX package; the port decodes JPEG
# with its native codec and refuses WebP ---


def _image_blob(fmt):
    from io import BytesIO

    from PIL import Image

    buf = BytesIO()
    Image.fromarray(np.full((256, 256), 123, np.uint8), mode="L").save(
        buf, format=fmt, **({"lossless": True} if fmt == "WEBP" else {"quality": 100}))
    return buf.getvalue()


@pytest.mark.parametrize("fmt", ["WEBP", "JPEG"])
def test_webp_and_jpeg_mbtiles_tiles(tmp_path, fmt):
    """tests/test_png_netcdf.py:test_webp_mbtiles_tiles_decode: the JAX
    package decodes the file with Pillow.  A JPEG tile and (since the
    port's lossless WebP codec) a WebP tile: the port's payload is the JAX
    package's, from the reader and through RasterFileSource."""
    path = str(tmp_path / "webp.mbtiles")
    jax_mbtiles.write_mbtiles(path, np.full((1, 256, 256), 123, np.uint8),
                              _grid_aligned_gt(col=7, row_xyz=7))
    con = sqlite3.connect(path)
    con.execute("UPDATE tiles SET tile_data = ?", (_image_blob(fmt),))
    con.execute("UPDATE metadata SET value = ? WHERE name = 'format'", (fmt.lower(),))
    con.commit()
    con.close()
    data = jax_mbtiles.read_mbtiles(path)
    if fmt == "WEBP":
        assert (data.array[:, :256, :256] == 123).all()
    else:
        assert np.abs(data.array.astype(int) - 123).max() <= 2
    pipeline.clear_read_cache()
    assert_same(mbtiles.read_mbtiles(path), data)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        source = __import__("dask_geomodeling_tpu_torch.raster",
                            fromlist=["x"]).RasterFileSource("webp.mbtiles")
        assert source.info.width == data.array.shape[2]
        assert source.info.dtype == "uint8"


def test_jpeg_gpkg_tile_refused(tmp_path):
    """A JPEG tile in a GeoPackage: the JAX package decodes it with Pillow,
    the port with its native codec, to the same payload."""
    path = str(tmp_path / "j.gpkg")
    jax_gpkg.write_gpkg_raster(path, np.full((1, 256, 256), 123, np.uint8),
                               (0.0, 1.0, 0.0, 256.0, 0.0, -1.0), projection="EPSG:28992")
    con = sqlite3.connect(path)
    con.execute("UPDATE tiles SET tile_data = ?", (_image_blob("JPEG"),))
    con.commit()
    con.close()
    expected = jax_gpkg.read_gpkg_raster(path)
    assert np.abs(expected.array.astype(int) - 123).max() <= 2
    assert_same(gpkg_raster.read_gpkg_raster(path), expected)


# --- the writers and readers under hypothesis ---


def _write_both(write, suffix, *args, **kwargs):
    """Write with the JAX writer and the port's into a fresh folder; the
    tables are equal; returns (the folder, the JAX file, the port's)."""
    folder = Path(tempfile.mkdtemp())
    theirs, ours = str(folder / ("jax" + suffix)), str(folder / ("port" + suffix))
    write[0](theirs, *args, **kwargs)
    write[1](ours, *args, **kwargs)
    assert sqlite_contents(ours) == sqlite_contents(theirs)
    return folder, theirs, ours


def _read_alike(read, theirs, ours):
    """Each package reads both files alike."""
    expected = read[0](theirs)
    for path in (theirs, ours):
        assert_same(read[1](path), expected)
        assert_same(read[1](path), read[0](path))
    return expected


def frames(max_side=300):
    return st.tuples(st.sampled_from(["u1", "u2"]), st.integers(1, 4), st.integers(1, max_side),
                     st.integers(1, max_side), st.integers(0, 2**32 - 1))


def _frame(dtype, bands, height, width, seed):
    info = np.iinfo(dtype)
    return np.random.RandomState(seed).randint(0, int(info.max) + 1, (bands, height, width),
                                               dtype=np.int64).astype(dtype)


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(frames(), st.integers(-3, 3), st.integers(-3, 3), st.booleans(),
       st.sampled_from([16, 64, 256]), st.sampled_from([None, "EPSG:28992", "EPSG:4326"]))
def test_gpkg_writers_and_readers_agree(frame, col, row, off_grid, tile, projection):
    """Both GeoPackage writers write the same tables, and both readers the
    same payload, origins on the tile grid and off it."""
    values = _frame(*frame)
    cell = 0.5 if projection != "EPSG:4326" else 1e-4
    ox = 100000.0 + col * tile * cell + (cell * 3.25 if off_grid else 0.0)
    oy = 400000.0 - row * tile * cell - (cell * 7.5 if off_grid else 0.0)
    gt = (ox, cell, 0.0, oy, 0.0, -cell)
    folder, theirs, ours = _write_both((jax_gpkg.write_gpkg_raster, gpkg_raster.write_gpkg_raster),
                                       ".gpkg", values, gt, projection=projection, tile_size=tile)
    data = _read_alike((jax_gpkg.read_gpkg_raster, gpkg_raster.read_gpkg_raster), theirs, ours)
    np.testing.assert_array_equal(data.array[:, :values.shape[1], :values.shape[2]], values)
    assert data.array.dtype == values.dtype
    for path in (theirs, ours):
        os.remove(path)
    folder.rmdir()


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(frames(), st.integers(0, 2**10 - 2), st.integers(0, 2**10 - 2), st.integers(0, 255),
       st.integers(0, 255), st.sampled_from([8, 10, 12]))
def test_mbtiles_writers_and_readers_agree(frame, col, row, px_off, py_off, zoom):
    """Both MBTiles writers write the same tables, and both readers the
    same payload, for origins on the zoom ladder, at a tile corner or
    inside a tile."""
    values = _frame(*frame)
    res = 2 * ORIGIN / (256 * 2**zoom)
    col, row = col % (2**zoom - 1), row % (2**zoom - 1)
    gt = (-ORIGIN + (col * 256 + px_off) * res, res, 0.0, ORIGIN - (row * 256 + py_off) * res,
          0.0, -res)
    folder, theirs, ours = _write_both((jax_mbtiles.write_mbtiles, mbtiles.write_mbtiles),
                                       ".mbtiles", values, gt, name="n%d" % zoom)
    data = _read_alike((jax_mbtiles.read_mbtiles, mbtiles.read_mbtiles), theirs, ours)
    height, width = values.shape[1:]
    np.testing.assert_array_equal(data.array[:, py_off:py_off + height, px_off:px_off + width],
                                  values)
    for path in (theirs, ours):
        os.remove(path)
    folder.rmdir()


@settings(max_examples=30, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.integers(1, 4), st.integers(1, 4), st.integers(0, 2**32 - 1),
       st.sampled_from(["gpkg", "mbtiles"]))
def test_sparse_and_mixed_pyramids_read_alike(n_rows, n_cols, seed, kind):
    """A pyramid with tiles deleted (one kept at least) and tiles replaced
    by blobs of other band counts (gray, gray and alpha, RGB, RGBA) reads
    alike in both packages."""
    rng = np.random.RandomState(seed)
    tile = 32
    values = rng.randint(0, 256, (1, n_rows * tile, n_cols * tile)).astype(np.uint8)
    folder = Path(tempfile.mkdtemp())
    path = str(folder / ("p." + kind))
    if kind == "gpkg":
        jax_gpkg.write_gpkg_raster(path, values, (0.0, 2.0, 0.0, 640.0, 0.0, -2.0),
                                   projection="EPSG:28992", tile_size=tile)
        table, read = "tiles", (jax_gpkg.read_gpkg_raster, gpkg_raster.read_gpkg_raster)
    else:
        res = 2 * ORIGIN / (tile * 2**12)
        jax_mbtiles.write_mbtiles(path, values, (-ORIGIN + 100 * tile * res, res, 0.0,
                                                 ORIGIN - 200 * tile * res, 0.0, -res),
                                  tile_size=tile)
        table, read = "tiles", (jax_mbtiles.read_mbtiles, mbtiles.read_mbtiles)
    con = sqlite3.connect(path)
    keys = con.execute("SELECT rowid FROM %s" % table).fetchall()
    keep = rng.randint(len(keys))
    for index, (rowid,) in enumerate(keys):
        fate = rng.randint(3)
        if fate == 0 and index != keep:
            con.execute("DELETE FROM %s WHERE rowid = ?" % table, (rowid,))
        elif fate == 1:
            bands = int(rng.randint(1, 5))
            blob = jax_png.write_png_bytes(rng.randint(0, 256, (bands, tile, tile)).astype(np.uint8))
            con.execute("UPDATE %s SET tile_data = ? WHERE rowid = ?" % table, (blob, rowid))
    con.commit()
    con.close()
    _read_alike(read, path, path)
    os.remove(path)
    folder.rmdir()


# --- RasterFileSource through from_reference ---


@pytest.mark.parametrize("suffix, projection", [(".gpkg", "EPSG:28992"), (".gpkg", "EPSG:4326"),
                                                (".mbtiles", "EPSG:3857"),
                                                (".mbtiles", "EPSG:28992")])
def test_file_source_against_jax_numpy(tmp_path, suffix, projection):
    """A JAX RasterFileSource over each pyramid comes across with
    from_reference and answers the JAX numpy executor bitwise, in the
    file's CRS and across CRSes, time frames the bands; its info is the
    whole decode's and its read is never windowed."""
    values = ((np.arange(3 * 200 * 300) * 7) % 251).astype("u1").reshape(3, 200, 300)
    if suffix == ".gpkg":
        gt = (135000.0, 2.0, 0.0, 456000.0, 0.0, -2.0)
        jax_gpkg.write_gpkg_raster(str(tmp_path / ("a" + suffix)), values, gt,
                                   projection="EPSG:28992")
        native = "EPSG:28992"
    else:
        res = 2 * ORIGIN / (256 * 2**14)  # zoom 14, over RD New's south-west
        gt = (-ORIGIN + (8400 * 256 + 17) * res, res, 0.0, ORIGIN - (5390 * 256 + 30) * res,
              0.0, -res)
        jax_mbtiles.write_mbtiles(str(tmp_path / ("a" + suffix)), values, gt)
        native = "EPSG:3857"
    from dask_geomodeling_tpu_torch.geo import Extent

    bbox = (gt[0] + 30 * gt[1], gt[3] + 150 * gt[5], gt[0] + 250 * gt[1], gt[3] + 20 * gt[5])
    bbox = Extent(bbox, native).transformed(projection).bbox
    request = dict(mode="vals", bbox=bbox, projection=projection, width=110, height=65,
                   start=START, stop=datetime(2000, 1, 1, 0, 10))
    with both_configs({"geomodeling.root": str(tmp_path),
                       "geomodeling.windowed-read-limit": 1000}):
        jax_source = jax_raster.RasterFileSource("a" + suffix, time_first=START)
        view, expected = assert_agrees(jax_source, request)
        assert expected["values"].shape == (3, 65, 110)
        assert (expected["values"] != expected["no_data_value"]).any()
        assert view._file_read_plan(request) is None
        for field in ("width", "height", "bands", "dtype", "projection", "geo_transform",
                      "no_data_value", "metadata"):
            assert_same(getattr(view.info, field), getattr(jax_source.info, field), field)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()


# --- chip_smoke's tile-pyramids writers and view, small ---


def _jax_pyramid_view(name, classes):
    data = jax_pam.rat_as_reclassify_data(chip_smoke.lgn_rat(classes), "MANNING")
    return jax_raster.Smooth(jax_raster.Reclassify(jax_raster.RasterFileSource(name), data,
                                                   select=True), chip_smoke.LGN_SMOOTH_M)


def _tiles_against_jax(view, jax_view, request, tile=64):
    """evaluate_tiled of the port's view, tile by tile, against the JAX
    numpy executor's answer to each tile."""
    width, height = request["width"], request["height"]
    tiled = evaluate_tiled(view, request, tile_size=tile, batch=4, device="cpu")
    tiles, nx = tile_requests(request, tile)
    for index, tile_request in enumerate(tiles):
        (rows, cols), (tile_rows, tile_cols) = chip_smoke.tile_cells(index, nx, width, height,
                                                                     tile)
        with jax_config.set({"geomodeling.executor": "numpy"}):
            want = jax_view.get_data(**tile_request)["values"]
        np.testing.assert_array_equal(tiled["values"][:, rows, cols],
                                      want[:, tile_rows, tile_cols])


def test_gpkg_landuse_against_jax_and_hfa(tmp_path):
    """chip_smoke's GeoPackage writer over 256 x 192 land-use classes: both
    packages read the file alike; the pyramid view comes across with
    from_reference and answers the JAX numpy executor bitwise, whole and
    in 64^2 tiles, as chip_smoke's build does; and its answer is
    hfa-roughness' over the same classes as an .img (class 0, nodata there
    and data here, and the padding past the grid's edge both reclassify to
    nodata)."""
    classes = chip_smoke.lgn_classes(256, 192)
    path = chip_smoke.write_lgn_gpkg(str(tmp_path), classes)
    assert_same(gpkg_raster.read_gpkg_raster(path), jax_gpkg.read_gpkg_raster(path))
    mosaic = gpkg_raster.read_gpkg_raster(path).array[0]
    assert mosaic.shape == (256, 256) and not mosaic[192:].any()
    request = chip_smoke.lgn_request(256, 192)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_view = _jax_pyramid_view("lgn.gpkg", classes)
        view, expected = assert_agrees(jax_view, request)
        assert_same(chip_smoke.build_pyramid_view(path, classes).get_data(device="cpu", **request),
                    expected)
        _tiles_against_jax(view, jax_view, request)
        hfa_path, hfa_classes, _ = chip_smoke.write_lgn(str(tmp_path), 256, 192)
        assert np.array_equal(hfa_classes, classes)
        hfa = chip_smoke.build_lgn_view(hfa_path).get_data(device="cpu", **request)
        assert_same(hfa, expected)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()


def test_mbtiles_landuse_against_jax(tmp_path):
    """chip_smoke's MBTiles writer at the 2 x 2-tile zoom-14 box around a
    2400 x 1600 m RD New request: both packages read the file alike, its
    mosaic the classes drawn; the pyramid view, asked in RD New, answers
    the JAX numpy executor bitwise, whole and in 64^2 tiles."""
    request = chip_smoke.lgn_request(480, 320)
    gt, width, height = chip_smoke.mercator_box(request)
    assert (width, height) == (512, 512)
    path, classes, geo_transform = chip_smoke.write_lgn_mbtiles(str(tmp_path), request)
    assert geo_transform == gt and classes.shape == (512, 512)
    data = mbtiles.read_mbtiles(path)
    assert_same(data, jax_mbtiles.read_mbtiles(path))
    assert np.array_equal(data.array[0], classes) and data.metadata == ["lgn"]
    assert np.allclose(data.geo_transform, gt, rtol=1e-12)
    request = chip_smoke.lgn_request(480, 320)
    request = dict(request, width=240, height=160)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_view = _jax_pyramid_view("lgn.mbtiles", classes)
        view, expected = assert_agrees(jax_view, request)
        assert (expected["values"] != expected["no_data_value"]).mean() > 0.5
        assert_same(chip_smoke.build_pyramid_view(path, classes).get_data(device="cpu", **request),
                    expected)
        _tiles_against_jax(view, jax_view, request)
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()


def test_pyramid_refusals_as_the_jax_package(tmp_path):
    """chip_smoke's refusals: a GeoPackage of features and an MBTiles file
    of vector tiles raise the JAX package's errors; an animated WebP tile
    (the port decodes still WebP only) raises NotImplementedError naming
    the JAX module, which decodes it with Pillow."""
    refusals = chip_smoke.pyramid_refusals(str(tmp_path))
    assert [kind for kind, _ in refusals] == [OSError, NotImplementedError, OSError]
    assert refusals[0][1].startswith("No tile layers in '") and "vector tiles" in refusals[2][1]
    assert "dask_geomodeling_tpu/io/gpkg_raster.py" in refusals[1][1]
    assert os.listdir(str(tmp_path)) == []


# --- pickling and the normalizer registry ---


class MockBlock(Block):
    """tests/test_core.py:MockBlock with the port's Block."""

    def __init__(self, *args):
        for arg in args:
            if isinstance(arg, str):
                raise TypeError("MockBlock does not accept strings")
        super().__init__(*args)


class Add(MockBlock):
    @staticmethod
    def process(a, b):
        return a + b


@pytest.mark.parametrize("kit", [types.SimpleNamespace(Add=test_core.Add,
                                                       MockBlock=test_core.MockBlock),
                                 types.SimpleNamespace(Add=Add, MockBlock=MockBlock)],
                         ids=["jax", "port"])
def test_pickle(kit):
    """tests/test_core.py:TestSerialization.test_pickle in each package; the
    copy is constructed without validation (its token from its key)."""
    view = kit.Add(kit.MockBlock(1), 2)
    view2 = pickle.loads(pickle.dumps(view))
    assert view.token == view2.token
    assert type(view2) is kit.Add and view2.args[1] == 2
    assert type(view2.args[0]) is kit.MockBlock and view2.args[0].token == view.args[0].token


def test_pickled_view_answers_alike_in_a_worker(tmp_path):
    """A pyramid view pickled here and unpickled in another process keeps
    its class and token; unpickled here, it answers a tile as the original
    does."""
    classes = chip_smoke.lgn_classes(128, 96)
    path = chip_smoke.write_lgn_gpkg(str(tmp_path), classes)
    view = chip_smoke.build_pyramid_view(path, classes)
    request = chip_smoke.lgn_request(128, 96)
    expected = view.get_data(device="cpu", **request)
    blob = pickle.dumps(view)
    copy = pickle.loads(blob)
    assert type(copy) is type(view) and copy.token == view.token
    assert not hasattr(copy.args[0].args[0], "_info")
    assert_same(copy.get_data(device="cpu", **request), expected)
    worker = subprocess.run(
        [sys.executable, "-c", "import pickle, sys; view = pickle.loads(sys.stdin.buffer.read()); "
         "print(type(view).__module__, type(view).__name__, view.token)"],
        input=blob, capture_output=True, check=True,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert worker.stdout.decode().split() == [type(view).__module__, "Smooth", view.token]
    pipeline.clear_read_cache()


class Point:
    """An object without a canonical form, but for its normalizer."""

    def __init__(self, x, y):
        self.x, self.y = x, y

    def __token__(self):
        return ("token", self.x)


class SubPoint(Point):
    pass


@pytest.fixture
def registered():
    """A normalizer for Point in both packages' registries, taken out
    after the test."""
    def normalize(point):
        return ("point", point.x, point.y)

    for module in (jax_tokens, tokens):
        module.register_normalizer(Point)(normalize)
    yield normalize
    for module in (jax_tokens, tokens):
        module._NORMALIZERS.pop(Point)


def test_normalizer_registry_precedes_token(registered):
    """A registered normalizer wins over ``__token__``, for the class and
    (along the MRO) its subclasses, and both packages give the same
    tokens; without it ``__token__`` decides, alike in both."""
    before = {module: module.tokenize(Point(1, 2)) for module in (jax_tokens, tokens)}
    for module in (jax_tokens, tokens):
        assert module.tokenize(Point(1, 2)) != module.tokenize(Point(1, 3))
        assert module.tokenize(SubPoint(1, 2)) == module.tokenize(Point(1, 2))
        assert module.normalize_token(Point(1, 2)) == module.normalize_token(SubPoint(1, 2))
    assert tokens.tokenize(Point(1, 2)) == jax_tokens.tokenize(Point(1, 2))
    assert tokens.normalize_token(Point(4, 5)) == jax_tokens.normalize_token(Point(4, 5))
    assert tokens.tokenize({"p": [Point(1, 2)]}) == jax_tokens.tokenize({"p": [Point(1, 2)]})
    from dask_geomodeling_tpu_torch import core

    assert core.register_normalizer is tokens.register_normalizer
    assert set(tokens.__all__) == set(jax_tokens.__all__)
    tokens._NORMALIZERS.pop(Point)
    jax_tokens._NORMALIZERS.pop(Point)
    try:
        for module in (jax_tokens, tokens):
            # __token__ decides: only x counts
            assert module.tokenize(Point(1, 2)) == module.tokenize(Point(1, 3))
        assert tokens.tokenize(Point(1, 2)) == jax_tokens.tokenize(Point(1, 2))
        assert before[tokens] != tokens.tokenize(Point(1, 2))
    finally:
        for module in (jax_tokens, tokens):
            module.register_normalizer(Point)(registered)


@pytest.mark.parametrize("value", [None, 3, 2.5, "a", b"b", (1, [2.0, "x"]), {"k": {1, 2}},
                                   np.arange(6, dtype="i2").reshape(2, 3), np.float32(1.5),
                                   datetime(2000, 1, 2, 3), np.dtype("f8")])
def test_normalize_token_as_the_jax_package(value):
    """normalize_token gives the JAX package's token for plain values."""
    assert tokens.normalize_token(value) == jax_tokens.normalize_token(value)
    assert tokens.tokenize(value) == jax_tokens.tokenize(value)
