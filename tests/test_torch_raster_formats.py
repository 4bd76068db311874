"""The port's plain-grid raster formats (io/dem.py, io/asciigrid.py,
io/simplegrids.py, io/envi.py) and their dispatch in the read cache and
``RasterFileSource``, held on the CPU to the JAX package's.

Every case of tests/test_dem.py, tests/test_asciigrid.py,
tests/test_simplegrids.py, the ``TestEnvi`` cases of
tests/test_png_netcdf.py and the ENVI, Surfer and SAGA cases of
tests/test_format_matrix.py runs once in each package (``run_both``), on
the same files: the files written are byte-identical and the payloads,
answers and errors the same (arrays with ``np.array_equal`` and their
dtypes exactly).  Each package reads the other's files; each writer
writes the JAX writer's bytes and round-trips under hypothesis (Surfer,
SAGA, ENVI, and ENVI files in each interleave and byte order); a view
over every suffix comes across with ``from_reference`` and answers the
JAX numpy executor bitwise; an ENVI pair's cache stamp sees a rewritten
header; an HFA ``.img`` reads as the JAX package's, and a stub with its
magic raises the same error.  chip_smoke.py's
dem-formats view over a small tile in each format it writes answers the
JAX numpy executor bitwise.
"""
import contextlib
import os
import struct
import types
from datetime import datetime

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.geo import crs as jax_crs
from dask_geomodeling_tpu.io import asciigrid as jax_asciigrid
from dask_geomodeling_tpu.io import dem as jax_dem
from dask_geomodeling_tpu.io import envi as jax_envi
from dask_geomodeling_tpu.io import hfa as jax_hfa
from dask_geomodeling_tpu.io import simplegrids as jax_simplegrids
from dask_geomodeling_tpu.io.geotiff import write_geotiff as jax_write_geotiff
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import raster as port_raster
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.geo import crs as port_crs
from dask_geomodeling_tpu_torch.io import asciigrid, dem, envi, hfa, simplegrids
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_asciigrid import ASC
from tests.test_dem import build_dted
from tests.test_simplegrids import EXPECT_GT, GRID, XLO, XHI, YHI, YLO
from tests.test_torch_file_sources import assert_agrees, both_configs


def _kit(port):
    """What a case needs of one package: its format modules, its raster
    blocks, its CRS layer and a ``get_data`` (the port's on the CPU, the
    JAX package's on its numpy executor)."""
    if port:
        return types.SimpleNamespace(
            port=True, dem=dem, asc=asciigrid, sg=simplegrids, envi=envi, R=port_raster,
            crs=port_crs, config=config,
            get_data=lambda block, **request: block.get_data(device="cpu", **request))

    def get_data(block, **request):
        with jax_config.set({"geomodeling.executor": "numpy"}):
            return block.get_data(**request)
    return types.SimpleNamespace(
        port=False, dem=jax_dem, asc=jax_asciigrid, sg=jax_simplegrids, envi=jax_envi,
        R=jax_raster, crs=jax_crs, config=jax_config, get_data=get_data)


def assert_same(ours, theirs, what="result"):
    """The port's ``ours`` holds what the JAX package's ``theirs`` holds:
    payloads field by field, arrays with their dtypes, bitwise."""
    if hasattr(theirs, "geo_transform") and hasattr(theirs, "array"):  # a RasterData
        for field in ("array", "projection", "geo_transform", "no_data_value", "metadata"):
            assert_same(getattr(ours, field), getattr(theirs, field), what + "." + field)
    elif isinstance(theirs, np.ndarray):
        assert isinstance(ours, np.ndarray) and ours.dtype == theirs.dtype, what
        assert np.array_equal(ours, theirs, equal_nan=theirs.dtype.kind == "f"), what
    elif isinstance(theirs, dict):
        assert sorted(ours) == sorted(theirs), what
        for key in theirs:
            assert_same(ours[key], theirs[key], "%s[%r]" % (what, key))
    elif isinstance(theirs, (list, tuple)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs), what
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same(a, b, "%s[%d]" % (what, i))
    else:
        assert type(ours) is type(theirs) and ours == theirs, (what, ours, theirs)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


@contextlib.contextmanager
def same_crs_history():
    """Both packages' CRS layers from the same history while it is open.

    Each layer interns a datum it does not know in its module-level
    ``DATUMS`` and ``ELLIPSOIDS`` under a ``custom:`` key, named after the
    first CRS that used the ellipsoid, and later parses with that
    ellipsoid reuse the key: a file written with such a CRS carries the
    name of whichever parse came first in the process.  This sets aside
    the interned entries of both layers and clears the caches of parsed
    CRSes (``get_sr``, ``get_transform_func``), so that both packages
    start from their built-in tables; on leaving, both tables are put
    back as they were and the caches cleared again, so no parse of the
    case outlives it."""
    saved = []
    for crs in (jax_crs, port_crs):
        tables = (crs.DATUMS, crs.ELLIPSOIDS)
        saved.append((crs, tables, [dict(table) for table in tables]))
        for table in tables:
            for key in [k for k in table if "custom:" in k]:
                del table[key]
        crs.get_sr.cache_clear()
        crs.get_transform_func.cache_clear()
    try:
        yield
    finally:
        for crs, tables, copies in saved:
            for table, copy in zip(tables, copies):
                table.clear()
                table.update(copy)
            crs.get_sr.cache_clear()
            crs.get_transform_func.cache_clear()


def run_both(tmp_path, case):
    """Run ``case(kit, root)`` for the JAX package in ``tmp_path/jax`` and
    for the port in ``tmp_path/port`` (each its ``geomodeling.root``),
    both from the same CRS history (``same_crs_history``): the same files
    come out, byte for byte, and the same results; returns the port's."""
    results = {}
    with same_crs_history():
        for side in ("jax", "port"):
            root = tmp_path / side
            root.mkdir()
            kit = _kit(side == "port")
            pipeline.clear_read_cache()
            jax_pipeline.clear_read_cache()
            with kit.config.set({"geomodeling.root": str(root)}):
                results[side] = case(kit, root)
    names = _files(tmp_path / "jax")
    assert names == _files(tmp_path / "port")
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    assert_same(results["port"], results["jax"])
    return results["port"]


def write_hgt(path, grid):
    np.asarray(grid, ">i2").tofile(str(path))


# --- tests/test_dem.py ---


def _hgt_georeferencing(k, root):
    n = 5
    grid = np.arange(n * n, dtype=np.int16).reshape(n, n)
    write_hgt(root / "N34W119.hgt", grid)
    data = k.dem.read_hgt(str(root / "N34W119.hgt"))
    np.testing.assert_array_equal(data.array[0], grid)
    assert data.array.dtype == np.int16 and data.no_data_value == -32768.0
    res = 1.0 / (n - 1)
    np.testing.assert_allclose(data.geo_transform, (-119 - res / 2, res, 0.0, 35 + res / 2, 0.0, -res))
    assert data.projection == "EPSG:4326"
    return data


def _hgt_hemispheres(k, root):
    write_hgt(root / "s02e045.hgt", np.zeros((3, 3), np.int16))
    data = k.dem.read_hgt(str(root / "s02e045.hgt"))
    assert data.geo_transform[0] == pytest.approx(45 - 0.25)
    assert data.geo_transform[3] == pytest.approx(-1 + 0.25)
    return data


def _hgt_bad_name_and_size(k, root):
    write_hgt(root / "elevation.hgt", np.zeros((3, 3), np.int16))
    with pytest.raises(ValueError, match="SW corner") as bad_name:
        k.dem.read_hgt(str(root / "elevation.hgt"))
    np.zeros(7, ">i2").tofile(str(root / "N00E000.hgt"))
    with pytest.raises(ValueError, match="square") as bad_size:
        k.dem.read_hgt(str(root / "N00E000.hgt"))
    return str(bad_name.value).replace(str(root), ""), str(bad_size.value)


def _hgt_file_source(k, root):
    n = 5
    grid = (np.arange(n * n, dtype=np.int16) * 10).reshape(n, n)
    write_hgt(root / "N34W119.hgt", grid)
    source = k.R.RasterFileSource("N34W119.hgt", time_first=datetime(2000, 1, 1))
    assert source.projection == "EPSG:4326" and source.dtype == np.int16
    res = 1.0 / (n - 1)
    result = k.get_data(source, mode="vals", bbox=(-119 - res / 2, 35 + res / 2 - 2 * res,
                                                   -119 - res / 2 + 3 * res, 35 + res / 2),
                        projection="EPSG:4326", width=3, height=2, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"][0], grid[:2, :3])
    return result


def _dted_georeferencing(k, root):
    rng = np.random.RandomState(0)
    grid_sn = rng.randint(-500, 4000, (4, 3)).astype(np.int16)
    (root / "n34.dt1").write_bytes(build_dted("1170000W", "0340000N", grid_sn))
    data = k.dem.read_dted(str(root / "n34.dt1"), check_checksums=True)
    np.testing.assert_array_equal(data.array[0], grid_sn.T[::-1])
    assert data.no_data_value == -32767.0
    step = 300 / 36000.0
    np.testing.assert_allclose(
        data.geo_transform, (-117 - step / 2, step, 0.0, 34 + 2 * step + step / 2, 0.0, -step))
    return data


def _dted_sign_magnitude(k, root):
    grid_sn = np.array([[-12, -32767], [7, 0]], np.int32)
    (root / "d.dt0").write_bytes(build_dted("0003000E", "0450000N", grid_sn))
    data = k.dem.read_dted(str(root / "d.dt0"))
    np.testing.assert_array_equal(data.array[0], grid_sn.T[::-1])
    return data


def _dted_sentinel_and_checksum(k, root):
    grid_sn = np.zeros((3, 3), np.int16)
    path = root / "bad.dt1"
    path.write_bytes(build_dted("1170000W", "0340000N", grid_sn, corrupt_sentinel=True))
    with pytest.raises(ValueError, match="sentinel"):
        k.dem.read_dted(str(path))
    path.write_bytes(build_dted("1170000W", "0340000N", grid_sn, corrupt_checksum=True))
    data = k.dem.read_dted(str(path))  # checksums ignored by default
    with pytest.raises(ValueError, match="checksum") as failed:
        k.dem.read_dted(str(path), check_checksums=True)
    return data, str(failed.value)


def _dted_truncated(k, root):
    path = root / "trunc.dt2"
    raw = build_dted("1170000W", "0340000N", np.zeros((3, 3), np.int16))
    path.write_bytes(raw[:-10])
    with pytest.raises(ValueError, match="truncated") as truncated:
        k.dem.read_dted(str(path))
    path.write_bytes(b"NOPE" + raw[4:])
    with pytest.raises(ValueError, match="UHL"):
        k.dem.read_dted(str(path))
    return str(truncated.value)


def _dted_file_source(k, root):
    grid_sn = (np.arange(12, dtype=np.int16) * 5).reshape(4, 3)
    (root / "n34.dt1").write_bytes(build_dted("1170000W", "0340000N", grid_sn))
    source = k.R.RasterFileSource("n34.dt1", time_first=datetime(2000, 1, 1))
    assert source.projection == "EPSG:4326"
    step = 300 / 36000.0
    top = 34 + 2 * step + step / 2
    result = k.get_data(source, mode="vals", bbox=(-117 - step / 2, top - 3 * step,
                                                   -117 - step / 2 + 4 * step, top),
                        projection="EPSG:4326", width=4, height=3, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"][0], grid_sn.T[::-1])
    return result


# --- tests/test_asciigrid.py ---


def _asc_int_grid(k, root):
    (root / "grid.asc").write_text(ASC)
    data = k.asc.read_ascii_grid(str(root / "grid.asc"))
    assert data.array.dtype == np.int32 and data.array.shape == (1, 3, 4)
    np.testing.assert_array_equal(data.array[0, 0], [1, 2, 3, 4])
    assert data.array[0, 1, 1] == -9999 and data.no_data_value == -9999
    assert data.geo_transform == (1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0)
    return data


def _asc_float_center(k, root):
    (root / "grid.asc").write_text(
        "ncols 2\nnrows 2\nxllcenter 10.0\nyllcenter 20.0\ncellsize 2.0\n1.5 2.5\n3.5 4.5\n")
    data = k.asc.read_ascii_grid(str(root / "grid.asc"))
    assert data.array.dtype == np.float32
    assert data.geo_transform[0] == 9.0 and data.geo_transform[3] == 23.0
    return data


def _asc_sidecar_prj(k, root):
    (root / "grid.asc").write_text(ASC)
    (root / "grid.prj").write_text("EPSG:28992")
    data = k.asc.read_ascii_grid(str(root / "grid.asc"))
    assert data.projection == "EPSG:28992"
    return data


def _asc_file_source(k, root):
    (root / "grid.asc").write_text(ASC)
    source = k.R.RasterFileSource("grid.asc", time_first=datetime(2000, 1, 1))
    assert source.dtype == np.int32
    result = k.get_data(source, mode="vals", bbox=(1000.0, 2000.0, 1200.0, 2150.0),
                        projection=source.projection, width=4, height=3,
                        start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"][0],
                                  [[1, 2, 3, 4], [5, -9999, 7, 8], [9, 10, 11, 12]])
    return result


def _xyz_grid(k, root):
    lines = ["%s %s %s" % (x, y, x + y) for y in [30.0, 10.0, 20.0]
             for x in [100.0, 110.0, 120.0, 130.0]]
    (root / "pts.xyz").write_text("\n".join(lines) + "\n")
    data = k.asc.read_xyz(str(root / "pts.xyz"))
    assert data.array.shape == (1, 3, 4)
    np.testing.assert_array_equal(data.array[0, 0], [130, 140, 150, 160])
    np.testing.assert_array_equal(data.array[0, 2], [110, 120, 130, 140])
    assert data.geo_transform == (95.0, 10.0, 0.0, 35.0, 0.0, -10.0)
    return data


def _xyz_missing_cells(k, root):
    (root / "pts.xyz").write_text("0 0 1\n1 0 2\n0 1 3\n")
    data = k.asc.read_xyz(str(root / "pts.xyz"))
    assert data.array.shape == (1, 2, 2) and (data.array == data.no_data_value).sum() == 1
    return data


def _xyz_comma_separated(k, root):
    (root / "pts.xyz").write_text("0,0,1\n1,0,2\n0,1,3\n1,1,4\n")
    data = k.asc.read_xyz(str(root / "pts.xyz"))
    np.testing.assert_array_equal(data.array[0], [[3, 4], [1, 2]])
    return data


def _asc_wrapped_rows(k, root):
    (root / "wrapped.asc").write_text(
        "ncols 4\nnrows 2\nxllcorner 0\nyllcorner 0\ncellsize 1\n1 2\n3 4\n5 6 7 8\n")
    data = k.asc.read_ascii_grid(str(root / "wrapped.asc"))
    np.testing.assert_array_equal(data.array[0], [[1, 2, 3, 4], [5, 6, 7, 8]])
    return data


# --- tests/test_simplegrids.py ---


def _surfer_ascii(k, root):
    lines = ["DSAA", "3 4", "100 101", "50 53", "10 42"]
    lines += [" ".join("%g" % v for v in row) for row in GRID[::-1]]
    (root / "g.grd").write_text("\n".join(lines) + "\n")
    data = k.sg.read_surfer(str(root / "g.grd"))
    np.testing.assert_array_equal(data.array[0], GRID)
    np.testing.assert_allclose(data.geo_transform, EXPECT_GT)
    return data


def _surfer6_blanks(k, root):
    grid = GRID.copy()
    grid[1, 2] = 1.70141e38
    (root / "g6.grd").write_bytes(
        b"DSBB" + struct.pack("<hh", 3, 4) + struct.pack("<6d", XLO, XHI, YLO, YHI, 10, 42)
        + grid[::-1].astype("<f4").tobytes())
    data = k.sg.read_surfer(str(root / "g6.grd"))
    np.testing.assert_allclose(data.geo_transform, EXPECT_GT)
    assert data.array[0, 1, 2] == data.no_data_value
    mask = np.ones_like(GRID, dtype=bool)
    mask[1, 2] = False
    np.testing.assert_array_equal(data.array[0][mask], GRID[mask])
    return data


def _surfer7(k, root):
    grid_header = struct.pack("<II8d", 4, 3, XLO, YLO, 0.5, 1.0, 10.0, 42.0, 0.0, 1.70141e38)
    body = GRID[::-1].astype("<f8").tobytes()
    (root / "g7.grd").write_bytes(
        struct.pack("<III", 0x42525344, 4, 1)
        + struct.pack("<II", 0x44495247, len(grid_header)) + grid_header
        + struct.pack("<II", 0x41544144, len(body)) + body)
    data = k.sg.read_surfer(str(root / "g7.grd"))
    np.testing.assert_array_equal(data.array[0], GRID)
    np.testing.assert_allclose(data.geo_transform, EXPECT_GT)
    return data


def _surfer_writer(fmt):
    def case(k, root):
        grid = GRID.copy()
        grid[0, 0] = -9.0
        k.sg.write_surfer(str(root / "out.grd"), grid[np.newaxis], EXPECT_GT,
                          no_data_value=-9.0, fmt=fmt)
        data = k.sg.read_surfer(str(root / "out.grd"))
        assert data.array[0, 0, 0] == data.no_data_value
        np.testing.assert_allclose(data.array[0, 1:], GRID[1:])
        np.testing.assert_allclose(data.geo_transform, EXPECT_GT)
        return data
    return case


def _surfer_not_surfer(k, root):
    (root / "x.grd").write_bytes(b"NOPE" + bytes(64))
    with pytest.raises(IOError, match="Surfer") as raised:
        k.sg.read_surfer(str(root / "x.grd"))
    return str(raised.value).replace(str(root), "")


def _saga_pair(root, top_to_bottom=False, big=False):
    grid = GRID if top_to_bottom else GRID[::-1]
    (root / "g.sdat").write_bytes(grid.astype(">f4" if big else "<f4").tobytes())
    (root / "g.sgrd").write_text(
        "NAME\t= g\nDATAFORMAT\t= FLOAT\nDATAFILE_OFFSET\t= 0\n"
        "BYTEORDER_BIG\t= %s\nPOSITION_XMIN\t= 100.0\n"
        "POSITION_YMIN\t= 50.0\nCELLCOUNT_X\t= 3\nCELLCOUNT_Y\t= 4\n"
        "CELLSIZE\t= 1.0\nNODATA_VALUE\t= -99999.0\nTOPTOBOTTOM\t= %s\n"
        % ("TRUE" if big else "FALSE", "TRUE" if top_to_bottom else "FALSE"))
    return str(root / "g.sgrd")


def _saga_read(top_to_bottom, big):
    def case(k, root):
        data = k.sg.read_saga(_saga_pair(root, top_to_bottom, big))
        np.testing.assert_array_equal(data.array[0], GRID)
        np.testing.assert_allclose(data.geo_transform, (99.5, 1.0, 0.0, 53.5, 0.0, -1.0))
        assert data.no_data_value == -99999.0
        return data
    return case


def _saga_via_sdat(k, root):
    _saga_pair(root)
    data = k.sg.read_saga(str(root / "g.sdat"))
    np.testing.assert_array_equal(data.array[0], GRID)
    return data


def _saga_writer(k, root):
    k.sg.write_saga(str(root / "out.sgrd"), GRID.astype("f4")[np.newaxis],
                    (99.5, 1.0, 0.0, 53.5, 0.0, -1.0))
    data = k.sg.read_saga(str(root / "out.sgrd"))
    np.testing.assert_array_equal(data.array[0], GRID)
    np.testing.assert_allclose(data.geo_transform, (99.5, 1.0, 0.0, 53.5, 0.0, -1.0))
    return data


def _idrisi_pair(root, dtype="real", ref="utm-31n", flag="-9999"):
    np_dtype = {"byte": "u1", "integer": "<i2", "real": "<f4"}[dtype]
    (root / "g.rst").write_bytes(GRID.astype(np_dtype).tobytes())
    (root / "g.rdc").write_text(
        "file format : IDRISI Raster A.1\nfile title  : test\n"
        "data type   : %s\nfile type   : binary\ncolumns     : 3\nrows        : 4\n"
        "ref. system : %s\nref. units  : m\nunit dist.  : 1.0\n"
        "min. X      : 100.0\nmax. X      : 103.0\nmin. Y      : 50.0\nmax. Y      : 54.0\n"
        "pos'n error : unknown\nresolution  : 1.0\nmin. value  : 10\nmax. value  : 42\n"
        "display min : 10\ndisplay max : 42\nvalue units : m\nvalue error : unknown\n"
        "flag value  : %s\nflag def'n  : missing data\n" % (dtype, ref, flag))
    return str(root / "g.rst")


def _idrisi_types(dtype):
    def case(k, root):
        data = k.sg.read_idrisi(_idrisi_pair(root, dtype=dtype))
        np.testing.assert_array_equal(data.array[0], GRID)
        np.testing.assert_allclose(data.geo_transform, (100.0, 1.0, 0.0, 54.0, 0.0, -1.0))
        assert data.no_data_value == -9999.0 and data.projection == "EPSG:32631"
        return data
    return case


def _idrisi_latlong_no_flag(k, root):
    data = k.sg.read_idrisi(_idrisi_pair(root, ref="latlong", flag="none"))
    assert data.projection == "EPSG:4326"
    assert data.no_data_value == float(np.finfo("f4").max)
    return data


def _surfer_file_source(k, root):
    k.sg.write_surfer(str(root / "grid.grd"), GRID[np.newaxis], EXPECT_GT, no_data_value=None)
    source = k.R.RasterFileSource("grid.grd")
    assert len(source) == 1
    out = k.get_data(source, mode="vals", bbox=(99.75, 49.5, 101.25, 53.5),
                     projection=source.projection or "EPSG:28992", width=3, height=4)
    np.testing.assert_array_equal(out["values"][0], GRID)
    return out


def _idrisi_uppercase(k, root):
    (root / "MAP.RST").write_bytes(GRID.astype("<f4").tobytes())
    (root / "MAP.RDC").write_text(
        "data type   : real\ncolumns     : 3\nrows        : 4\n"
        "ref. system : plane\nmin. X      : 100.0\nmax. X      : 103.0\n"
        "min. Y      : 50.0\nmax. Y      : 54.0\nflag value  : none\n")
    data = k.sg.read_idrisi(str(root / "MAP.RST"))
    np.testing.assert_array_equal(data.array[0], GRID)
    return data


# --- the TestEnvi cases of tests/test_png_netcdf.py ---


def _envi_bsq_wkt(k, root):
    values = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    gt = (500000.0, 10.0, 0.0, 4649776.0, 0.0, -10.0)
    k.envi.write_envi(str(root / "scene.img"), values, geo_transform=gt,
                      projection="EPSG:32631", no_data_value=-9999.0, band_names=["b1", "b2"])
    data = k.envi.read_envi(str(root / "scene.img"))
    np.testing.assert_array_equal(data.array, values)
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.no_data_value == -9999.0 and data.metadata == ["b1", "b2"]
    assert k.crs.get_epsg_or_wkt(data.projection) == "EPSG:32631"
    via_header = k.envi.read_envi(str(root / "scene.img.hdr"))
    np.testing.assert_array_equal(via_header.array, values)
    return data, via_header


def _envi_interleave(interleave):
    def case(k, root):
        values = np.arange(24, dtype=">i2").reshape(2, 3, 4)
        on_disk = values.transpose(1, 0, 2) if interleave == "bil" else values.transpose(1, 2, 0)
        np.ascontiguousarray(on_disk).tofile(str(root / "raw.dat"))
        (root / "raw.hdr").write_text(
            "ENVI\nsamples = 4\nlines = 3\nbands = 2\n"
            "data type = 2\ninterleave = %s\nbyte order = 1\n" % interleave)
        data = k.envi.read_envi(str(root / "raw.dat"))
        np.testing.assert_array_equal(data.array, values.astype("=i2"))
        return data
    return case


def _envi_utm(k, root):
    np.zeros(12, dtype=np.uint8).tofile(str(root / "utm.bsq"))
    (root / "utm.hdr").write_text(
        "ENVI\nsamples = 4\nlines = 3\nbands = 1\ndata type = 1\ninterleave = bsq\n"
        "map info = {UTM, 1.0, 1.0, 500000.0, 4649776.0, 30.0, 30.0,"
        " 31, North, WGS-84, units=Meters}\n")
    data = k.envi.read_envi(str(root / "utm.bsq"))
    assert data.projection == "EPSG:32631"
    np.testing.assert_allclose(data.geo_transform, (500000.0, 30.0, 0.0, 4649776.0, 0.0, -30.0))
    return data


def _envi_file_source(k, root):
    values = np.arange(12, dtype=np.uint8).reshape(1, 3, 4)
    k.envi.write_envi(str(root / "src.img"), values,
                      geo_transform=(1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0),
                      projection="EPSG:28992")
    source = k.R.RasterFileSource("src.img", time_first=datetime(2000, 1, 1))
    assert source.projection == "EPSG:28992"
    result = k.get_data(source, mode="vals", bbox=(1000.0, 2000.0, 1200.0, 2150.0),
                        projection="EPSG:28992", width=4, height=3, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"], values)
    return result


def _envi_semicolons(k, root):
    np.full(12, 7, dtype=np.uint8).tofile(str(root / "c.bsq"))
    (root / "c.hdr").write_text(
        "ENVI\n; a leading comment line\n"
        "description = {File Imported into ENVI; georeferenced}\n"
        "samples = 4\nlines = 3\nbands = 1\ndata type = 1\ninterleave = bsq\n"
        "data ignore value = {255}\n")
    data = k.envi.read_envi(str(root / "c.bsq"))
    assert data.array.shape == (1, 3, 4) and data.no_data_value == 255.0
    return data


def _envi_rejects_rotated(k, root):
    values = np.zeros((1, 2, 2), dtype=np.uint8)
    with pytest.raises(NotImplementedError):
        k.envi.write_envi(str(root / "r.img"), values, geo_transform=(0, 10, 5, 0, 5, -10))
    with pytest.raises(NotImplementedError) as south_up:
        k.envi.write_envi(str(root / "s.img"), values, geo_transform=(0, 10, 0, 0, 0, 10))
    return str(south_up.value)


def _envi_hdr_target(k, root):
    values = np.arange(6, dtype=np.int16).reshape(1, 2, 3)
    k.envi.write_envi(str(root / "t.hdr"), values)
    assert (root / "t.img").exists()
    data = k.envi.read_envi(str(root / "t.hdr"))
    np.testing.assert_array_equal(data.array, values)
    return data


def _envi_raw_file_source(k, root):
    values = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    k.envi.write_envi(str(root / "r.raw"), values, geo_transform=(0.0, 1.0, 0.0, 3.0, 0.0, -1.0),
                      projection="EPSG:28992")
    source = k.R.RasterFileSource("r.raw", time_first=datetime(2000, 1, 1))
    out = k.get_data(source, mode="vals", bbox=(0.0, 0.0, 4.0, 3.0), projection="EPSG:28992",
                     width=4, height=3, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(out["values"], values)
    return out


JAX_CASES = {
    "dem-hgt-georeferencing": _hgt_georeferencing,
    "dem-hgt-hemispheres": _hgt_hemispheres,
    "dem-hgt-bad-name-and-size": _hgt_bad_name_and_size,
    "dem-hgt-file-source": _hgt_file_source,
    "dem-dted-georeferencing": _dted_georeferencing,
    "dem-dted-sign-magnitude": _dted_sign_magnitude,
    "dem-dted-sentinel-checksum": _dted_sentinel_and_checksum,
    "dem-dted-truncated": _dted_truncated,
    "dem-dted-file-source": _dted_file_source,
    "asc-int-grid": _asc_int_grid,
    "asc-float-center": _asc_float_center,
    "asc-sidecar-prj": _asc_sidecar_prj,
    "asc-file-source": _asc_file_source,
    "xyz-grid": _xyz_grid,
    "xyz-missing-cells": _xyz_missing_cells,
    "xyz-comma-separated": _xyz_comma_separated,
    "asc-wrapped-rows": _asc_wrapped_rows,
    "surfer-ascii": _surfer_ascii,
    "surfer-binary6-blanks": _surfer6_blanks,
    "surfer-binary7": _surfer7,
    "surfer-writer-binary": _surfer_writer("binary"),
    "surfer-writer-ascii": _surfer_writer("ascii"),
    "surfer-not-surfer": _surfer_not_surfer,
    "saga-read": _saga_read(False, False),
    "saga-read-top-to-bottom": _saga_read(True, False),
    "saga-read-big": _saga_read(False, True),
    "saga-read-top-to-bottom-big": _saga_read(True, True),
    "saga-via-sdat": _saga_via_sdat,
    "saga-writer": _saga_writer,
    "idrisi-byte": _idrisi_types("byte"),
    "idrisi-integer": _idrisi_types("integer"),
    "idrisi-real": _idrisi_types("real"),
    "idrisi-latlong-no-flag": _idrisi_latlong_no_flag,
    "surfer-file-source": _surfer_file_source,
    "idrisi-uppercase": _idrisi_uppercase,
    "envi-bsq-wkt": _envi_bsq_wkt,
    "envi-bil": _envi_interleave("bil"),
    "envi-bip": _envi_interleave("bip"),
    "envi-utm": _envi_utm,
    "envi-file-source": _envi_file_source,
    "envi-semicolons-braced-scalars": _envi_semicolons,
    "envi-rejects-rotated": _envi_rejects_rotated,
    "envi-hdr-target": _envi_hdr_target,
    "envi-raw-file-source": _envi_raw_file_source,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of the JAX package's format tests, run in each package."""
    run_both(tmp_path, JAX_CASES[name])


# --- the ENVI, Surfer and SAGA cases of tests/test_format_matrix.py ---

MATRIX_VALUES = ((np.arange(96 * 128) * 31) % 251).astype("u1").reshape(1, 96, 128)
MATRIX_GT = (84000.0, 2.0, 0.0, 444000.0, 0.0, -2.0)
MATRIX_PROJECTION = "EPSG:28992"


def _matrix_write(k, root, name):
    path = str(root / name)
    if name.endswith(".hdr"):
        k.envi.write_envi(path, MATRIX_VALUES, geo_transform=MATRIX_GT,
                          projection=MATRIX_PROJECTION, no_data_value=255.0)
        return
    if name.endswith(".grd"):
        k.sg.write_surfer(path, MATRIX_VALUES.astype("f8"), MATRIX_GT)
    else:
        k.sg.write_saga(path, MATRIX_VALUES, MATRIX_GT)
    with open(os.path.splitext(path)[0] + ".prj", "w") as f:
        f.write(k.crs.get_sr(MATRIX_PROJECTION).ExportToWkt())


def _matrix_native(name):
    def case(k, root):
        _matrix_write(k, root, name)
        source = k.R.RasterFileSource(name)
        np.testing.assert_allclose(tuple(source.geo_transform), MATRIX_GT)
        data = k.get_data(source, mode="vals", projection=MATRIX_PROJECTION, width=128,
                          height=96, bbox=(MATRIX_GT[0], MATRIX_GT[3] - 96 * 2.0,
                                           MATRIX_GT[0] + 128 * 2.0, MATRIX_GT[3]))
        np.testing.assert_array_equal(np.asarray(data["values"], dtype="u1"), MATRIX_VALUES)
        assert np.asarray(data["values"]).shape == MATRIX_VALUES.shape
        return data
    return case


def _matrix_cross_crs(name):
    def case(k, root):
        _matrix_write(k, root, name)
        jax_write_geotiff(str(root / "reference.tif"), MATRIX_VALUES, MATRIX_GT,
                          MATRIX_PROJECTION, 255.0)
        x1, y1 = MATRIX_GT[0] + 30.0, MATRIX_GT[3] - 96 * 2.0 + 30.0
        x2, y2 = MATRIX_GT[0] + 128 * 2.0 - 30.0, MATRIX_GT[3] - 30.0
        bbox = k.crs.transform_extent((x1, y1, x2, y2), MATRIX_PROJECTION, "EPSG:4326")
        request = dict(mode="vals", bbox=bbox, projection="EPSG:4326", width=64, height=48)
        result = k.get_data(k.R.RasterFileSource(name), **request)
        reference = k.get_data(k.R.RasterFileSource("reference.tif"), **request)
        np.testing.assert_array_equal(np.asarray(result["values"], dtype="u1"),
                                      np.asarray(reference["values"], dtype="u1"))
        return result
    return case


@pytest.mark.parametrize("name", ["grid.hdr", "grid.grd", "grid.sgrd"])
@pytest.mark.parametrize("matrix", [_matrix_native, _matrix_cross_crs],
                         ids=["format_matrix", "format_matrix_cross_crs_consistency"])
def test_format_matrix_case(tmp_path, matrix, name):
    run_both(tmp_path, matrix(name))


# --- each package reads the other's files; the writers' bytes ---

HEIGHTS = ((np.arange(37 * 41) * 7919) % 3001 - 500).astype(np.int16).reshape(37, 41)
HEIGHTS[3:6, 10:14] = -32768
GT_RD = (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.5)


def _write(k, root, name):
    """Write HEIGHTS as ``name`` with ``k``'s writer (Surfer, SAGA, ENVI)
    or composed bytes (the formats neither package writes); returns the
    path a reader takes."""
    path = str(root / name)
    stem, suffix = os.path.splitext(name)
    if suffix in (".grd", ".sgrd", ".asc", ".xyz"):  # the CRS of a sidecar
        (root / (stem + ".prj")).write_text("EPSG:28992")
    if suffix == ".grd":
        k.sg.write_surfer(path, HEIGHTS[None], GT_RD, no_data_value=-32768)
    elif suffix == ".sgrd":
        k.sg.write_saga(path, HEIGHTS[None], GT_RD, no_data_value=-32768)
    elif suffix in (".bil", ".img"):
        k.envi.write_envi(path, HEIGHTS[None], geo_transform=GT_RD, projection="EPSG:28992",
                          no_data_value=-32768, band_names=["height"])
    elif suffix == ".hgt":
        write_hgt(path, HEIGHTS[:37, :37])
    elif suffix == ".dt2":  # columns south to north, DTED's void for SRTM's
        columns = np.where(HEIGHTS == -32768, -32767, HEIGHTS)[::-1].T
        (root / name).write_bytes(build_dted("0050000E", "0510000N", columns))
    elif suffix == ".asc":
        with open(path, "w") as f:
            f.write("ncols 41\nnrows 37\nxllcorner 135000\nyllcorner 455981.5\ncellsize 0.5\n"
                    "NODATA_value -32768\n")
            f.write("\n".join(" ".join(map(str, row)) for row in HEIGHTS.tolist()) + "\n")
    elif suffix == ".xyz":
        with open(path, "w") as f:
            for r, row in enumerate(HEIGHTS.tolist()):
                f.write("".join("%r;%r;%d\n" % (135000.25 + 0.5 * c, 455999.75 - 0.5 * r, z)
                                for c, z in enumerate(row) if z != -32768))
    return path


READERS = {".grd": "sg.read_surfer", ".sgrd": "sg.read_saga", ".bil": "envi.read_envi",
           ".img": "envi.read_envi", ".hgt": "dem.read_hgt", ".dt2": "dem.read_dted",
           ".asc": "asc.read_ascii_grid", ".xyz": "asc.read_xyz"}
CROSS_NAMES = ["N51E005.hgt", "n51.dt2", "h.asc", "h.xyz", "h.grd", "h.sgrd", "h.bil", "h.img"]


def _reader(k, name):
    module, function = READERS[os.path.splitext(name)[1]].split(".")
    return getattr(getattr(k, module), function)


@pytest.mark.parametrize("name", CROSS_NAMES)
def test_each_package_reads_the_others_file(tmp_path, name):
    """A file written by each package (the same bytes) reads to the same
    payload in both."""
    jax_kit, port_kit = _kit(False), _kit(True)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_path = _write(jax_kit, tmp_path / "jax", name)
    port_path = _write(port_kit, tmp_path / "port", name)
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")
    for f in _files(tmp_path / "jax"):
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes(), f
    expected = _reader(jax_kit, name)(jax_path)
    assert_same(_reader(port_kit, name)(jax_path), expected)
    assert_same(_reader(port_kit, name)(port_path), _reader(jax_kit, name)(port_path))
    assert_same(pipeline.read_geotiff_cached(jax_path), jax_pipeline.read_geotiff_cached(port_path))


# --- RasterFileSource over every suffix, against the JAX numpy executor ---

#: (file name, how to write it): every suffix the port now reads
SOURCE_NAMES = [
    "N51E005.hgt", "n51.dt0", "n51.dt1", "n51.dt2", "h.asc", "h.agr", "h.xyz", "h.grd",
    "h6.grd", "h.sgrd", "h.sdat", "h.rst", "h.hdr", "h.bsq", "h.bil", "h.bip", "h.envi",
    "h.img", "h.dat", "h.raw",
]


def _write_source(root, name):
    """Write HEIGHTS under ``name`` with the JAX package's writers or as
    composed bytes; returns the name a RasterFileSource opens."""
    jax_kit = _kit(False)
    stem, suffix = os.path.splitext(name)
    if suffix in (".dt0", ".dt1"):
        _write(jax_kit, root, stem + ".dt2")
        os.rename(str(root / (stem + ".dt2")), str(root / name))
    elif suffix == ".agr":
        _write(jax_kit, root, stem + ".asc")
        os.rename(str(root / (stem + ".asc")), str(root / name))
    elif name == "h6.grd":  # a Surfer 7 grid, float64 with its own blank value
        grid = HEIGHTS[::-1].astype("<f8")
        grid[grid == -32768] = 1e30
        header = struct.pack("<II8d", 37, 41, 135000.25, 455981.75, 0.5, 0.5, -500.0, 2500.0,
                             0.0, 1e30)
        body = grid.tobytes()
        (root / name).write_bytes(
            struct.pack("<III", 0x42525344, 4, 1) + struct.pack("<II", 0x44495247, len(header))
            + header + struct.pack("<II", 0x41544144, len(body)) + body)
        (root / (stem + ".prj")).write_text("EPSG:28992")
    elif suffix == ".sdat":
        _write(jax_kit, root, stem + ".sgrd")
    elif suffix == ".rst":
        HEIGHTS.astype("<i2").tofile(str(root / name))
        (root / (stem + ".rdc")).write_text(
            "data type   : integer\ncolumns     : 41\nrows        : 37\n"
            "ref. system : utm-31n\nmin. X      : 600000.0\nmax. X      : 600410.0\n"
            "min. Y      : 5700000.0\nmax. Y      : 5700370.0\nflag value  : -32768\n")
    elif suffix in (".hdr", ".bsq", ".bip", ".envi", ".dat", ".raw"):
        data_name = stem + (".img" if suffix == ".hdr" else suffix)
        bands = np.stack([HEIGHTS, HEIGHTS // 2])
        on_disk = {".bip": bands.transpose(1, 2, 0)}.get(suffix, bands)
        np.ascontiguousarray(on_disk, ">i2" if suffix == ".raw" else "<i2").tofile(
            str(root / data_name))
        (root / (stem + ".hdr")).write_text(
            "ENVI\nsamples = 41\nlines = 37\nbands = 2\nheader offset = 0\ndata type = 2\n"
            "interleave = %s\nbyte order = %d\n"
            "map info = {UTM, 1, 1, 600000.0, 5700370.0, 10.0, 10.0, 31, North}\n"
            "data ignore value = -32768\n" % ("bip" if suffix == ".bip" else "bsq",
                                               suffix == ".raw"))
    else:
        _write(jax_kit, root, name)
    return name


def _source_request(source):
    x1, y1, x2, y2 = source.geometry.bounds
    inset = ((x2 - x1) / 7, (y2 - y1) / 9)
    return dict(mode="vals", projection=source.projection, width=29, height=23,
                bbox=(x1 + inset[0], y1 + inset[1], x2 - inset[0] / 2, y2 - inset[1] / 3))


@pytest.mark.parametrize("name", SOURCE_NAMES)
def test_file_source_against_jax_numpy(tmp_path, name):
    """RasterFileSource over the suffix, and Smooth over it, from
    from_reference: attributes equal, compute_host and get_data on the CPU
    bitwise to the JAX numpy executor, at the file's grid and a
    sub-window; point and time requests too."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    with both_configs({"geomodeling.root": str(tmp_path)}):
        jax_source = jax_raster.RasterFileSource(_write_source(tmp_path, name))
        for attribute in ("dtype", "fillvalue", "projection", "geo_transform", "extent", "period"):
            assert getattr(port_raster.RasterFileSource(jax_source.url), attribute) == \
                getattr(jax_source, attribute), attribute
        request = _source_request(jax_source)
        x1, y1, x2, y2 = jax_source.geometry.bounds
        whole = dict(request, bbox=(x1, y1, x2, y2), width=int(round((x2 - x1) / abs(
            jax_source.geo_transform[1]))), height=int(round((y2 - y1) / abs(
                jax_source.geo_transform[5]))))
        # two cells, in metres (a geographic source's are about 111 km a degree)
        size = 2 * abs(jax_source.geo_transform[1]) * (
            111000 if jax_source.projection == "EPSG:4326" else 1)
        for view in (jax_source, jax_raster.Smooth(jax_source, size)):
            assert_agrees(view, request)
            assert_agrees(view, whole)
        point = dict(mode="vals", projection=request["projection"], width=1, height=1,
                     bbox=((x1 + x2) / 2, (y1 + y2) / 2) * 2)
        assert_agrees(jax_source, point)
        assert_agrees(jax_source, dict(mode="time", start=datetime(1970, 1, 1), stop=None))


# --- the writers under hypothesis ---

SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


def _grids(dtypes):
    return st.tuples(st.sampled_from(dtypes), st.integers(1, 7), st.integers(2, 9),
                     st.integers(0, 2**32 - 1)).map(_grid)


def _grid(args):
    dtype, height, width, seed = args
    rng = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        return (rng.randn(height, width) * 1000).astype(dtype)
    info = np.iinfo(dtype)
    return rng.randint(max(info.min, -2**31), min(info.max, 2**31 - 1), (height, width),
                       dtype=np.int64).astype(dtype)


def _roundtrip(tmp_path, write, read, name):
    """Write with each package's writer: the same bytes; each package
    reads both files to the same payload, which it returns."""
    files = {}
    for side, kit in (("jax", _kit(False)), ("port", _kit(True))):
        root = tmp_path / side
        root.mkdir(exist_ok=True)
        for f in os.listdir(root):
            os.remove(str(root / f))
        write(kit, str(root / name))
        files[side] = {f: (root / f).read_bytes() for f in sorted(os.listdir(root))}
    assert files["port"] == files["jax"]
    expected = read(_kit(False), str(tmp_path / "jax" / name))
    assert_same(read(_kit(True), str(tmp_path / "jax" / name)), expected)
    assert_same(read(_kit(True), str(tmp_path / "port" / name)), expected)
    return expected


@SETTINGS
@given(grid=_grids(["f8", "f4", "i2", "i4", "u1"]), fmt=st.sampled_from(["binary", "ascii"]),
       cell=st.sampled_from([0.5, 1.0, 25.0, 1 / 3600]), nodata=st.booleans())
def test_surfer_writer_roundtrip(tmp_path, grid, fmt, cell, nodata):
    gt = (155000.0, cell, 0.0, 463000.0, 0.0, -cell)
    no_data_value = float(grid.flat[0]) if nodata else None
    data = _roundtrip(tmp_path, lambda k, path: k.sg.write_surfer(
        path, grid[None], gt, no_data_value=no_data_value, fmt=fmt), lambda k, path:
        k.sg.read_surfer(path), "g.grd")
    stored = grid.astype("f8") if fmt == "ascii" else grid.astype("f4").astype("f8")
    keep = data.array[0] != data.no_data_value
    if fmt == "binary":
        np.testing.assert_array_equal(data.array[0][keep], stored[keep])
    else:  # %.10g text
        np.testing.assert_allclose(data.array[0][keep], stored[keep], rtol=1e-9)
    if nodata:
        assert not keep[0, 0]


@SETTINGS
@given(grid=_grids(["f8", "f4", "i1", "u1", "i2", "u2", "i4", "u4", "i8"]),
       cell=st.sampled_from([0.5, 1.0, 25.0]), nodata=st.sampled_from([None, -1.0, 0.0]))
def test_saga_writer_roundtrip(tmp_path, grid, cell, nodata):
    gt = (155000.0, cell, 0.0, 463000.0, 0.0, -cell)
    data = _roundtrip(tmp_path, lambda k, path: k.sg.write_saga(
        path, grid[None], gt, no_data_value=nodata), lambda k, path: k.sg.read_saga(path),
        "g.sgrd")
    np.testing.assert_array_equal(data.array[0], grid.astype("f8") if grid.dtype == "i8"
                                  else grid)


@SETTINGS
@given(grid=_grids(["f8", "f4", "u1", "i2", "u2", "i4", "u4", "i8", "u8"]),
       bands=st.integers(1, 3), target=st.sampled_from(["s.img", "s.hdr", "s.bil", "s.raw"]),
       georeferenced=st.booleans(), big=st.booleans())
def test_envi_writer_roundtrip(tmp_path, grid, bands, target, georeferenced, big):
    values = np.stack([grid] * bands).astype(grid.dtype.newbyteorder(">" if big else "<"))
    kwargs = dict(geo_transform=(600000.0, 10.0, 0.0, 5700000.0, 0.0, -10.0),
                  projection="EPSG:32631", no_data_value=0.0,
                  band_names=["b%d" % i for i in range(bands)]) if georeferenced else {}
    data = _roundtrip(tmp_path, lambda k, path: k.envi.write_envi(path, values, **kwargs),
                      lambda k, path: k.envi.read_envi(path), target)
    np.testing.assert_array_equal(data.array, values)
    assert data.array.dtype == grid.dtype.newbyteorder("=")


@SETTINGS
@given(grid=_grids(["f8", "f4", "u1", "i2", "u2", "i4"]), bands=st.integers(1, 3),
       interleave=st.sampled_from(["bsq", "bil", "bip"]), big=st.booleans(),
       offset=st.sampled_from([0, 7]))
def test_envi_interleave_and_byte_order(tmp_path, grid, bands, interleave, big, offset):
    """ENVI files in each interleave and byte order, at a header offset:
    both packages read them to the same payload, the written bands."""
    values = np.stack([grid + b for b in range(bands)]).astype(grid.dtype)
    on_disk = {"bsq": values, "bil": values.transpose(1, 0, 2),
               "bip": values.transpose(1, 2, 0)}[interleave]
    code = {"f8": 5, "f4": 4, "u1": 1, "i2": 2, "u2": 12, "i4": 3}[grid.dtype.str[1:]]
    for f in os.listdir(tmp_path):
        os.remove(str(tmp_path / f))
    with open(str(tmp_path / "x.dat"), "wb") as f:
        f.write(b"\0" * offset)
        f.write(np.ascontiguousarray(on_disk, grid.dtype.newbyteorder(">" if big else "<"))
                .tobytes())
    (tmp_path / "x.hdr").write_text(
        "ENVI\nsamples = %d\nlines = %d\nbands = %d\nheader offset = %d\ndata type = %d\n"
        "interleave = %s\nbyte order = %d\n" % (grid.shape[1], grid.shape[0], bands, offset, code,
                                                interleave, big))
    expected = jax_envi.read_envi(str(tmp_path / "x.dat"))
    assert_same(envi.read_envi(str(tmp_path / "x.dat")), expected)
    assert_same(envi.read_envi(str(tmp_path / "x.hdr")), jax_envi.read_envi(str(tmp_path / "x.hdr")))
    np.testing.assert_array_equal(expected.array, values)


# --- the read cache: an ENVI pair's stamp, .img and .dat dispatch ---


def test_envi_stamp_sees_a_rewritten_header(tmp_path):
    """Rewriting the .hdr alone (same size, same data file) invalidates
    the entry, whichever half of the pair is read."""
    pipeline.clear_read_cache()
    values = np.arange(12, dtype=np.uint8).reshape(1, 3, 4)
    envi.write_envi(str(tmp_path / "p.img"), values, no_data_value=1.0)
    for path in (str(tmp_path / "p.img"), str(tmp_path / "p.img.hdr")):
        first = pipeline.read_geotiff_cached(path)
        assert pipeline.read_geotiff_cached(path) is first and first.no_data_value == 1.0
        header = tmp_path / "p.img.hdr"
        stamp = os.stat(str(header)).st_mtime_ns
        header.write_text(header.read_text().replace("= 1.0", "= 2.0"))
        os.utime(str(header), ns=(stamp + 10**9, stamp + 10**9))
        second = pipeline.read_geotiff_cached(path)
        assert second is not first and second.no_data_value == 2.0
        header.write_text(header.read_text().replace("= 2.0", "= 1.0"))
        os.utime(str(header), ns=(stamp + 2 * 10**9, stamp + 2 * 10**9))
    pipeline.clear_read_cache()


def test_img_hfa_and_envi_and_dat_dispatch(tmp_path):
    """An HFA .img reads as the JAX package's, and a 64-byte stub with
    HFA's magic raises the same error in both packages; an ENVI pair's
    .img, .dat and .raw read as ENVI; a .dat or .img without a header
    reads as a GeoTIFF, as the JAX package's dispatch does."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    values = (np.arange(35, dtype=np.int16) - 9).reshape(1, 5, 7)
    gt = (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.5)
    jax_hfa.write_hfa(str(tmp_path / "h.img"), values, geo_transform=gt,
                      projection="EPSG:28992", no_data_value=-9.0)
    assert pipeline.whole_file_reader(str(tmp_path / "h.img")) is hfa.read_hfa
    (tmp_path / "stub.img").write_bytes(b"EHFA_HEADER_TAG\x00" + bytes(64))
    raised = []
    for package_raster, package_pipeline, package_config in (
            (port_raster, pipeline, config), (jax_raster, jax_pipeline, jax_config)):
        with package_config.set({"geomodeling.root": str(tmp_path)}):
            for read in (lambda: package_raster.RasterFileSource("stub.img").info,
                         lambda: package_pipeline.read_geotiff_cached(
                             str(tmp_path / "stub.img"))):
                with pytest.raises(ValueError, match="HFA version") as error:
                    read()
                raised.append(str(error.value))
    assert raised[:2] == raised[2:]
    for name in ("e.img", "e.dat", "e.raw"):
        envi.write_envi(str(tmp_path / name), values, geo_transform=gt, projection="EPSG:28992")
    for name in ("t.img", "t.dat"):
        jax_write_geotiff(str(tmp_path / name), values, gt, "EPSG:28992", -9.0)
    for name in ("h.img", "e.img", "e.dat", "e.raw", "t.img", "t.dat"):
        assert_same(pipeline.read_geotiff_cached(str(tmp_path / name)),
                    jax_pipeline.read_geotiff_cached(str(tmp_path / name)))
    assert pipeline.whole_file_reader(str(tmp_path / "e.dat")) is envi.read_envi
    assert pipeline.whole_file_reader(str(tmp_path / "t.dat")) is None
    with both_configs({"geomodeling.root": str(tmp_path)}):
        for name in ("h.img", "e.dat", "t.dat"):
            jax_source = jax_raster.RasterFileSource(name)
            assert_agrees(jax_source, _source_request(jax_source))
    pipeline.clear_read_cache()


# --- chip_smoke's dem-formats view, small ---


@pytest.mark.parametrize("fmt", ("hgt",) + chip_smoke.DEM_FORMATS)
def test_dem_view_against_jax_numpy(tmp_path, fmt):
    """chip_smoke's dem-formats view (Classify(MovingMax(Smooth(source,
    100 m), 3), bins)) over a 241^2 tile written in each format as the
    card phase writes it: from_reference of the same view built with the
    JAX package's classes answers its numpy executor bitwise at the
    tile's grid and in RD New, and equals chip_smoke's own build; the
    integer formats answer what the .hgt answers."""
    pipeline.clear_read_cache()
    jax_pipeline.clear_read_cache()
    n = 241
    heights = chip_smoke.dem_heights(n)
    with both_configs({"geomodeling.root": str(tmp_path)}):
        name = chip_smoke.write_dem_format(fmt, str(tmp_path), heights)
        jax_view = jax_raster.Classify(jax_raster.MovingMax(jax_raster.Smooth(
            jax_raster.RasterFileSource(name), chip_smoke.DEM_SMOOTH_M), 3), chip_smoke.DEM_BINS)
        for request in (chip_smoke.dem_request(n), chip_smoke.dem_rd_request(n, 256, 400.0)):
            view, expected = assert_agrees(jax_view, request)
            assert_same(chip_smoke.build_dem_view(name).get_data(device="cpu", **request),
                        expected)
            assert (expected["values"] > 0).mean() > 0.1
        if fmt != "hgt" and view.args[0].dtype.kind in "iu":
            hgt = chip_smoke.write_dem_format("hgt", str(tmp_path), heights)
            assert_same(chip_smoke.build_dem_view(hgt).get_data(device="cpu", **request),
                        expected)
