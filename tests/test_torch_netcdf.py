"""The port's netCDF reader and writer (io/netcdf.py), their dispatch in the
read caches and ``RasterFileSource``, held on the CPU to the JAX package's.

Every case of ``TestNetcdf``, ``TestNetcdf4`` (where h5py is importable),
``TestNetcdfWindows`` and ``test_netcdf_non_epsg_crs_roundtrip`` of
tests/test_png_netcdf.py and the ``grid.nc`` cases of
tests/test_format_matrix.py run once in each package (``run_both`` of
tests/test_torch_raster_formats.py): the files written are
byte-identical, and the payloads, answers and errors the same (arrays
bitwise with their dtypes).  Hand-built classic files (chip_smoke's
``write_classic_netcdf``) cover CDF-1 and CDF-2, one and three record
variables interleaving, the STREAMING record count, zero records, the
tie between equal-sized variables and a CDF-5 header; the writer writes
the JAX writer's bytes under hypothesis; an ``.hdf`` goes by its magic;
``RasterFileSource`` over a classic file comes across with
``from_reference`` and answers the JAX numpy executor bitwise, whole and
by window; the ``(path, variable)`` read cache keeps two variables apart
and sees a rewrite; chip_smoke's netcdf-radar file and view at a small
size answer as the JAX package's.
"""
import os
import time
from datetime import datetime

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import chip_smoke
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.geo import crs as jax_crs
from dask_geomodeling_tpu.io import netcdf as jax_netcdf
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import evaluate_tiled
from dask_geomodeling_tpu_torch import raster as port_raster
from dask_geomodeling_tpu_torch.geo import crs as port_crs
from dask_geomodeling_tpu_torch.io import netcdf
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_file_sources import assert_agrees, both_configs
from tests.test_torch_raster_formats import (
    MATRIX_GT,
    MATRIX_PROJECTION,
    MATRIX_VALUES,
    _kit,
    assert_same,
    run_both,
    same_crs_history,
)
from tests.test_torch_zarr import error, info_fields

try:
    import h5py
except ImportError:  # the gate: only the netCDF-4 cases need it
    h5py = None

needs_h5py = pytest.mark.skipif(h5py is None, reason="netCDF-4 path is h5py-gated")


def _nkit(port):
    """``_kit`` with the package's netCDF module and read caches."""
    kit = _kit(port)
    kit.nc = netcdf if port else jax_netcdf
    kit.pipeline = pipeline if port else jax_pipeline
    return kit


def run_nc(tmp_path, case):
    """``run_both`` with the netCDF kits."""
    return run_both(tmp_path, lambda k, root: case(_nkit(k.port), root))


def write_h5(path, values, xs, ys, wkt=None, dim_scales=True, fill=None, scale=None,
             offset=None, **dataset_kwargs):
    """tests/test_png_netcdf.py's TestNetcdf4._write."""
    with h5py.File(path, "w") as f:
        ds = f.create_dataset("data", data=values, **dataset_kwargs)
        if fill is not None:
            ds.attrs["_FillValue"] = np.asarray(fill, values.dtype)
        if scale is not None:
            ds.attrs["scale_factor"] = float(scale)
        if offset is not None:
            ds.attrs["add_offset"] = float(offset)
        if dim_scales:
            names = ["band", "y", "x"][3 - values.ndim:]
            coords = [None] * (values.ndim - 2) + [ys, xs]
            for axis, (name, coord) in enumerate(zip(names, coords)):
                if coord is None:
                    coord = np.arange(values.shape[axis], dtype=float)
                cv = f.create_dataset(name, data=np.asarray(coord, float))
                cv.make_scale(name)
                ds.dims[axis].attach_scale(cv)
        if wkt is not None:
            gm = f.create_dataset("crs", data=0)
            gm.attrs["spatial_ref"] = wkt
            ds.attrs["grid_mapping"] = "crs"


# --- tests/test_png_netcdf.py: TestNetcdf ---


def _roundtrip_float(k, root):
    values = np.linspace(0, 1, 12, dtype=np.float32).reshape(1, 3, 4)
    gt = (1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0)
    path = str(root / "data.nc")
    k.nc.write_netcdf(path, values, gt, projection="EPSG:28992", no_data_value=-1.0)
    data = k.nc.read_netcdf(path)
    np.testing.assert_allclose(data.array, values)
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.no_data_value == -1.0
    assert k.crs.get_sr(data.projection).code == 28992
    return data


def _multiband_int(k, root):
    values = np.arange(24, dtype=np.int16).reshape(2, 3, 4)
    path = str(root / "multi.nc")
    k.nc.write_netcdf(path, values, (0.0, 1.0, 0.0, 3.0, 0.0, -1.0))
    data = k.nc.read_netcdf(path)
    assert data.array.shape == (2, 3, 4)
    np.testing.assert_array_equal(data.array, values)
    return data


def _south_up_flips(k, root):
    values = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    path = str(root / "south.nc")
    k.nc.write_netcdf(path, values, (0.0, 1.0, 0.0, 0.0, 0.0, 1.0))
    data = k.nc.read_netcdf(path)
    assert data.geo_transform[5] < 0
    np.testing.assert_array_equal(data.array[0], values[0, ::-1])
    return data


def _scale_offset_unpacking(k, root):
    packed = np.array([[[0, 100], [200, -32768]]], np.int16)
    path = str(root / "packed.nc")
    k.nc.write_netcdf(path, packed, (0.0, 1.0, 0.0, 2.0, 0.0, -1.0), no_data_value=-32768,
                      scale_factor=0.01, add_offset=20.0)
    data = k.nc.read_netcdf(path)
    assert data.array.dtype == np.float32
    np.testing.assert_allclose(data.array[0, 0], [20.0, 21.0], atol=1e-6)
    np.testing.assert_allclose(data.array[0, 1, 0], 22.0, atol=1e-6)
    assert data.no_data_value == float(np.finfo(np.float32).max)
    assert data.array[0, 1, 1] == data.no_data_value
    return data


def _netcdf4_invalid_or_gated(k, root):
    path = root / "h5.nc"
    path.write_bytes(b"\x89HDF\r\n\x1a\n" + b"\x00" * 64)
    with pytest.raises((NotImplementedError, OSError)) as raised:
        k.nc.read_netcdf(str(path))
    return error(raised, root)


def _raster_file_source(k, root):
    values = np.arange(12, dtype=np.float32).reshape(1, 3, 4)
    gt = (1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0)
    k.nc.write_netcdf(str(root / "source.nc"), values, gt, projection="EPSG:28992",
                      no_data_value=-9999.0)
    source = k.R.RasterFileSource("source.nc", time_first=datetime(2000, 1, 1))
    assert source.fillvalue == -9999.0
    result = k.get_data(source, mode="vals", bbox=(1000.0, 2000.0, 1200.0, 2150.0),
                        projection="EPSG:28992", width=4, height=3, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"], values)
    return result


# --- TestNetcdf4 (h5py) ---


def _reads_cf_file(k, root):
    values = np.linspace(0, 1, 12, dtype=np.float32).reshape(3, 4)
    gt = (1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0)
    xs = gt[0] + gt[1] * (np.arange(4) + 0.5)
    ys = gt[3] + gt[5] * (np.arange(3) + 0.5)
    path = str(root / "data.nc4")
    write_h5(path, values, xs, ys, wkt=k.crs.get_sr("EPSG:28992").ExportToWkt(), fill=-1.0)
    data = k.nc.read_netcdf(path)
    np.testing.assert_allclose(data.array, values[None])
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.no_data_value == -1.0
    assert k.crs.get_sr(data.projection).code == 28992
    return data


def _chunked_deflate_shuffle(k, root):
    values = np.arange(64 * 96, dtype=np.int32).reshape(64, 96)
    path = str(root / "comp.h5")
    write_h5(path, values, np.arange(96) + 0.5, 64 - (np.arange(64) + 0.5), chunks=(16, 32),
             compression="gzip", shuffle=True)
    data = k.nc.read_netcdf(path)
    np.testing.assert_array_equal(data.array[0], values)
    np.testing.assert_allclose(data.geo_transform, (0.0, 1.0, 0.0, 64.0, 0.0, -1.0))
    return data


def _h5_south_up_flips(k, root):
    values = np.arange(12, dtype=np.float64).reshape(3, 4)
    path = str(root / "south.nc4")
    write_h5(path, values, np.arange(4) + 0.5, np.arange(3) + 0.5)
    data = k.nc.read_netcdf(path)
    assert data.geo_transform[5] < 0
    np.testing.assert_array_equal(data.array[0], values[::-1])
    return data


def _h5_scale_offset_unpacking(k, root):
    packed = np.array([[0, 100], [200, -32768]], np.int16)
    path = str(root / "packed.nc4")
    write_h5(path, packed, np.arange(2) + 0.5, 2 - (np.arange(2) + 0.5), fill=-32768,
             scale=0.01, offset=20.0)
    data = k.nc.read_netcdf(path)
    assert data.array.dtype == np.float32
    np.testing.assert_allclose(data.array[0, 0], [20.0, 21.0], atol=1e-6)
    assert data.array[0, 1, 1] == float(np.finfo(np.float32).max)
    return data


def _multiband_and_variable_select(k, root):
    values = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    path = str(root / "multi.h5")
    write_h5(path, values, np.arange(4) + 0.5, 3 - (np.arange(3) + 0.5))
    with h5py.File(path, "a") as f:
        f.create_group("nested").create_dataset("small", data=np.zeros((2, 2), np.float32))
    data = k.nc.read_netcdf(path)
    assert data.array.shape == (2, 3, 4)
    np.testing.assert_array_equal(data.array, values)
    small = k.nc.read_netcdf(path, variable="small")
    assert small.array.shape == (1, 2, 2)
    return data, small


def _no_dim_scales_pixel_grid(k, root):
    path = str(root / "bare.h5")
    write_h5(path, np.ones((3, 4), np.float32), None, None, dim_scales=False)
    data = k.nc.read_netcdf(path)
    assert data.geo_transform[1] == 1.0 and data.geo_transform[5] == -1.0
    return data


def _h5_raster_file_source(k, root):
    values = np.arange(12, dtype=np.float32).reshape(3, 4)
    gt = (1000.0, 50.0, 0.0, 2150.0, 0.0, -50.0)
    xs = gt[0] + gt[1] * (np.arange(4) + 0.5)
    ys = gt[3] + gt[5] * (np.arange(3) + 0.5)
    write_h5(str(root / "source.nc4"), values, xs, ys,
             wkt=k.crs.get_sr("EPSG:28992").ExportToWkt(), fill=-9999.0)
    source = k.R.RasterFileSource("source.nc4", time_first=datetime(2000, 1, 1))
    assert source.fillvalue == -9999.0
    result = k.get_data(source, mode="vals", bbox=(1000.0, 2000.0, 1200.0, 2150.0),
                        projection="EPSG:28992", width=4, height=3, start=datetime(2000, 1, 1))
    np.testing.assert_array_equal(result["values"], values[None])
    return result


def _square_grid_name_disambiguation(k, root):
    path = str(root / "square.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=np.zeros((4, 4), np.float32))
        y = f.create_dataset("y", data=400.0 - 100.0 * (np.arange(4) + 0.5))
        y.attrs["CLASS"] = np.bytes_("DIMENSION_SCALE")
        x = f.create_dataset("x", data=1000.0 + 10.0 * (np.arange(4) + 0.5))
        x.attrs["CLASS"] = np.bytes_("DIMENSION_SCALE")
    data = k.nc.read_netcdf(path)
    np.testing.assert_allclose(data.geo_transform, (1000.0, 10.0, 0.0, 400.0, 0.0, -100.0))
    return data


# --- TestNetcdfWindows and test_netcdf_non_epsg_crs_roundtrip ---


def _netcdf4_window_equals_whole(k, root):
    values = ((np.arange(48 * 64) * 3) % 251).astype("i4").reshape(48, 64)
    path = str(root / "w.nc4")
    windows = []
    for south_up in (False, True):
        ys = (np.arange(48) + 0.5) if south_up else (47.5 - np.arange(48))
        write_h5(path, values if not south_up else values[::-1], np.arange(64) + 0.5, ys,
                 chunks=(16, 16), compression="gzip")
        whole = k.nc.read_netcdf(path)
        for r0, r1, c0, c1 in [(0, 48, 0, 64), (5, 30, 10, 50), (47, 48, 63, 64)]:
            window = k.nc.read_netcdf_window(path, r0, r1, c0, c1)
            np.testing.assert_array_equal(window.array, whole.array[:, r0:r1, c0:c1])
            gt = whole.geo_transform
            np.testing.assert_allclose(window.geo_transform,
                                       (gt[0] + c0 * gt[1], gt[1], 0, gt[3] + r0 * gt[5], 0, gt[5]))
            windows.append(window)
    return windows


def _classic_window_equals_whole(k, root):
    values = np.arange(200, dtype="f4").reshape(1, 10, 20)
    path = str(root / "c.nc")
    k.nc.write_netcdf(path, values, (0.0, 2.0, 0.0, 20.0, 0.0, -2.0), no_data_value=-1.0)
    whole = k.nc.read_netcdf(path)
    window = k.nc.read_netcdf_window(path, 2, 8, 3, 17)
    np.testing.assert_array_equal(window.array, whole.array[:, 2:8, 3:17])
    np.testing.assert_allclose(window.geo_transform, (6.0, 2.0, 0.0, 16.0, 0.0, -2.0))
    return whole, window


def _info_is_metadata_only(k, root):
    values = np.full((40, 40), 3, dtype="f8")
    path = str(root / "i.nc4")
    write_h5(path, values, np.arange(40) + 0.5, 39.5 - np.arange(40),
             wkt=k.crs.get_sr("EPSG:28992").ExportToWkt(), fill=-1.0, scale=0.5, offset=2.0)
    whole = k.nc.read_netcdf(path)
    reads = []
    original = h5py.Dataset.__getitem__

    def spy(self, item):
        if self.name == "/data":
            reads.append(item)
        return original(self, item)

    h5py.Dataset.__getitem__ = spy
    try:
        info = k.nc.read_netcdf_info(path)
    finally:
        h5py.Dataset.__getitem__ = original
    assert reads == []
    assert (info.width, info.height, info.bands) == (40, 40, 1)
    np.testing.assert_allclose(info.geo_transform, whole.geo_transform)
    assert info.no_data_value == whole.no_data_value
    assert np.dtype(info.dtype) == whole.array.dtype
    assert k.crs.get_sr(info.projection).code == 28992
    return info_fields(info)


def _file_source_windowed_equals_whole(k, root):
    values = ((np.arange(30 * 40) * 3) % 251).astype("f4").reshape(30, 40)
    write_h5(str(root / "fs.nc4"), values, np.arange(40) + 0.5, 29.5 - np.arange(30),
             chunks=(10, 10))
    request = dict(mode="vals", bbox=(5.0, 5.0, 35.0, 25.0), projection="EPSG:4326", width=30,
                   height=20, start=datetime(2000, 1, 1))
    source = k.R.RasterFileSource("fs.nc4", time_first=datetime(2000, 1, 1))
    whole = k.get_data(source, **request)
    k.pipeline.clear_read_cache()
    with k.config.set({"geomodeling.windowed-read-limit": 100}):
        windowed = k.get_data(source, **request)
    np.testing.assert_array_equal(whole["values"], windowed["values"])
    return windowed


def _non_epsg_crs_roundtrip(k, root):
    proj4 = "+proj=sinu +lon_0=10 +a=6371007.181 +b=6371007.181 +units=m"
    path = str(root / "sinu.nc")
    k.nc.write_netcdf(path, np.zeros((1, 4, 4), "u1"), (0, 1, 0, 4, 0, -1), projection=proj4)
    back = k.nc.read_netcdf(path)
    a = k.crs.get_transform_func("EPSG:4326", proj4)(np.array([12.0]), np.array([45.0]))
    b = k.crs.get_transform_func("EPSG:4326", back.projection)(np.array([12.0]),
                                                                np.array([45.0]))
    np.testing.assert_allclose(a, b, atol=1e-6)
    return back, tuple(np.asarray(v) for v in b)


JAX_CASES = {
    "roundtrip-float": _roundtrip_float,
    "multiband-int": _multiband_int,
    "south-up-flips": _south_up_flips,
    "scale-offset-unpacking": _scale_offset_unpacking,
    "netcdf4-invalid-or-gated": _netcdf4_invalid_or_gated,
    "raster-file-source": _raster_file_source,
    "classic-window-equals-whole": _classic_window_equals_whole,
    "non-epsg-crs-roundtrip": _non_epsg_crs_roundtrip,
}
H5_CASES = {
    "netcdf4-reads-cf-file": _reads_cf_file,
    "netcdf4-chunked-deflate-shuffle": _chunked_deflate_shuffle,
    "netcdf4-south-up-flips": _h5_south_up_flips,
    "netcdf4-scale-offset-unpacking": _h5_scale_offset_unpacking,
    "netcdf4-multiband-and-variable-select": _multiband_and_variable_select,
    "netcdf4-no-dim-scales-pixel-grid": _no_dim_scales_pixel_grid,
    "netcdf4-raster-file-source": _h5_raster_file_source,
    "netcdf4-square-grid-name-disambiguation": _square_grid_name_disambiguation,
    "netcdf4-window-equals-whole": _netcdf4_window_equals_whole,
    "netcdf4-info-is-metadata-only": _info_is_metadata_only,
    "netcdf4-file-source-windowed-equals-whole": _file_source_windowed_equals_whole,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    """One case of tests/test_png_netcdf.py's netCDF tests, in each package."""
    run_nc(tmp_path, JAX_CASES[name])


#: the ESRI sinusoidal WKT of tests/test_crs_universal.py's MODIS case
ESRI_SINUSOIDAL = (
    'PROJCS["Sinusoidal",GEOGCS["GCS_Undefined",'
    'DATUM["D_Undefined",SPHEROID["User_Defined_Spheroid",'
    '6371007.181,0]],PRIMEM["Greenwich",0],'
    'UNIT["Degree",0.0174532925199433]],'
    'PROJECTION["Sinusoidal"],PARAMETER["central_meridian",0],'
    'PARAMETER["false_easting",0],PARAMETER["false_northing",0],'
    'UNIT["Meter",1]]'
)


def test_jax_case_after_a_jax_only_parse(tmp_path):
    """The non-EPSG CRS case passes after the JAX package alone has parsed
    an ESRI WKT on the same sphere: that parse interns the sphere under
    its datum's name in the JAX package's tables only, so the JAX writer
    would name the sinusoidal CRS after it and the port would not, had
    ``run_both`` not given both packages the same CRS history."""
    with same_crs_history():
        jax_crs.get_sr(ESRI_SINUSOIDAL)
        assert any(key.startswith("D_Undefined|custom:") for key in jax_crs.DATUMS)
        assert not any(key.startswith("D_Undefined|") for key in port_crs.DATUMS)
        run_nc(tmp_path, _non_epsg_crs_roundtrip)
        assert any(key.startswith("D_Undefined|custom:") for key in jax_crs.DATUMS)


@needs_h5py
@pytest.mark.parametrize("name", list(H5_CASES))
def test_netcdf4_case(tmp_path, name):
    """One netCDF-4 case of tests/test_png_netcdf.py, in each package."""
    run_nc(tmp_path, H5_CASES[name])


# --- the grid.nc cases of tests/test_format_matrix.py ---


def _matrix_nc(k, root):
    k.nc.write_netcdf(str(root / "grid.nc"), MATRIX_VALUES, MATRIX_GT,
                      projection=MATRIX_PROJECTION, no_data_value=255.0)


def _matrix_native(k, root):
    _matrix_nc(k, root)
    source = k.R.RasterFileSource("grid.nc")
    np.testing.assert_allclose(tuple(source.geo_transform), MATRIX_GT)
    data = k.get_data(source, mode="vals", projection=MATRIX_PROJECTION, width=128, height=96,
                      bbox=(MATRIX_GT[0], MATRIX_GT[3] - 96 * 2.0, MATRIX_GT[0] + 128 * 2.0,
                            MATRIX_GT[3]))
    np.testing.assert_array_equal(np.asarray(data["values"], dtype="u1"), MATRIX_VALUES)
    return data


def _matrix_cross_crs(k, root):
    from dask_geomodeling_tpu.io.geotiff import write_geotiff

    _matrix_nc(k, root)
    write_geotiff(str(root / "reference.tif"), MATRIX_VALUES, MATRIX_GT, MATRIX_PROJECTION, 255.0)
    x1, y1 = MATRIX_GT[0] + 30.0, MATRIX_GT[3] - 96 * 2.0 + 30.0
    x2, y2 = MATRIX_GT[0] + 128 * 2.0 - 30.0, MATRIX_GT[3] - 30.0
    bbox = k.crs.transform_extent((x1, y1, x2, y2), MATRIX_PROJECTION, "EPSG:4326")
    request = dict(mode="vals", bbox=bbox, projection="EPSG:4326", width=64, height=48)
    result = k.get_data(k.R.RasterFileSource("grid.nc"), **request)
    reference = k.get_data(k.R.RasterFileSource("reference.tif"), **request)
    np.testing.assert_array_equal(np.asarray(result["values"], dtype="u1"),
                                  np.asarray(reference["values"], dtype="u1"))
    return result


@pytest.mark.parametrize("matrix", [_matrix_native, _matrix_cross_crs],
                         ids=["format_matrix", "format_matrix_cross_crs_consistency"])
def test_format_matrix_case(tmp_path, matrix):
    run_nc(tmp_path, matrix)


# --- hand-built classic files ---

GRID = ((np.arange(3 * 5) * 7) % 23).reshape(3, 5)
XS = 100.0 + 10.0 * (np.arange(5) + 0.5)
YS_UP = 50.0 + 10.0 * (np.arange(3) + 0.5)  # ascending: south-up storage
RECORDS = 4


def _coords():
    return [("x", [2], [("units", "m")], 6, XS), ("y", [1], [], 6, YS_UP)]


def _record_vars(count):
    """``count`` record variables (the radar file's rain, quality and
    time): slabs of 30, 15 and 8 bytes, so the interleaving pads two."""
    rain = np.stack([GRID + 100 * r for r in range(RECORDS)]).astype("i2")
    quality = np.stack([GRID - r for r in range(RECORDS)]).astype("i1")
    variables = [
        ("rain", [0, 1, 2], [("scale_factor", (5, [0.5])), ("_FillValue", (3, [7])),
                             ("grid_mapping", "crs")], 3, rain),
        ("quality", [0, 1, 2], [("long_name", "quality"), ("grid_mapping", "crs")], 1, quality),
        ("time", [0], [("units", "minutes")], 6, np.arange(RECORDS) * 5.0),
    ]
    return variables[:count]


def _classic(name, version=2, count=3, numrecs=RECORDS, numrecs_field=None, extra=()):
    def case(k, root):
        variables = _coords() + [("crs", [], [("epsg_code", "28992")], 4, np.zeros(1))]
        variables += list(extra) + _record_vars(count)
        chip_smoke.write_classic_netcdf(
            str(root / name), [("time", 0), ("y", 3), ("x", 5)],
            [(n, d, a, t, v[:numrecs] if d and d[0] == 0 else v) for n, d, a, t, v in variables],
            numrecs, gatts=[("Conventions", "CF-1.6")], version=version,
            numrecs_field=numrecs_field)
        data = k.nc.read_netcdf(str(root / name))
        others = [k.nc.read_netcdf(str(root / name), variable=v)
                  for v in ("quality",) if count > 1]
        return data, others
    return case


CLASSIC_CASES = {
    "cdf1-one-record-variable": _classic("one.nc", version=1, count=1),
    "cdf2-one-record-variable": _classic("one2.nc", count=1),
    "cdf1-three-record-variables": _classic("three.nc", version=1),
    "cdf2-three-record-variables": _classic("three2.nc"),
    "two-record-variables": _classic("two.nc", count=2),
    "streaming-one": _classic("s1.nc", count=1, numrecs_field=0xFFFFFFFF),
    "streaming-three": _classic("s3.nc", numrecs_field=0xFFFFFFFF),
    "zero-records": _classic("z.nc", numrecs=0),
    "fixed-variable-beside-records": _classic(
        "f.nc", extra=[("dem", [1, 2], [("units", "m")], 5, GRID.astype("f4"))]),
}


@pytest.mark.parametrize("name", list(CLASSIC_CASES))
def test_hand_built_classic_file(tmp_path, name):
    """CDF-1 and CDF-2 files with one, two and three interleaving record
    variables (unpadded and padded slabs), the STREAMING sentinel, zero
    records and a fixed 2-D variable beside the records read alike; the
    rain unpacks, flips and takes its CRS from the grid mapping."""
    data, _ = run_nc(tmp_path, CLASSIC_CASES[name])
    assert data.projection == "EPSG:28992"
    assert data.geo_transform == (100.0, 10.0, 0.0, 80.0, 0.0, -10.0)
    if "zero" in name:
        assert data.array.shape == (0, 3, 5)
    elif "fixed" not in name:
        expected = np.stack([GRID[::-1] + 100 * r for r in range(RECORDS)]).astype("f4") * 0.5
        expected[np.stack([GRID[::-1] + 100 * r for r in range(RECORDS)]) == 7] = np.finfo(
            "f4").max
        np.testing.assert_array_equal(data.array, expected)


def _tie(first):
    def case(k, root):
        a, b = GRID.astype("f4")[None], (GRID + 50).astype("f4")[None]
        variables = _coords() + [(first, [0, 1, 2], [], 5, a),
                                 ("b" if first == "a" else "a", [0, 1, 2], [], 5, b)]
        chip_smoke.write_classic_netcdf(str(root / "tie.nc"), [("band", 1), ("y", 3), ("x", 5)],
                                        variables, 0, version=1)
        data = k.nc.read_netcdf(str(root / "tie.nc"))
        np.testing.assert_array_equal(data.array[0], GRID[::-1])
        assert data.metadata == [first]
        return data, k.nc.read_netcdf(str(root / "tie.nc"), variable="b" if first == "a" else "a")
    return case


@pytest.mark.parametrize("first", ["a", "b"])
def test_tie_keeps_the_first_variable(tmp_path, first):
    """Of two equal-sized variables, the first in the file is read."""
    run_nc(tmp_path, _tie(first))


def _rejected(name, payload, exception):
    def case(k, root):
        (root / name).write_bytes(payload)
        with pytest.raises(exception) as raised:
            k.nc.read_netcdf(str(root / name))
        return error(raised, root)
    return case


@pytest.mark.parametrize("name, payload, exception", [
    ("cdf5.nc", b"CDF\x05" + b"\x00" * 60, NotImplementedError),
    ("hdf5.cdf", b"\x89HDF" + b"\x00" * 60, (NotImplementedError, OSError)),
    ("text.nc3", b"not a netCDF file", IOError),
], ids=["cdf5", "hdf5-magic", "no-magic"])
def test_rejected_as_the_jax_package_rejects(tmp_path, name, payload, exception):
    """A CDF-5 header raises the JAX message, anything without the CDF
    magic IOError, an HDF5 file the h5py gate or h5py's error."""
    run_nc(tmp_path, _rejected(name, payload, exception))


@pytest.mark.parametrize("no_record", [False, True])
def test_no_data_variable(tmp_path, no_record):
    """A file without a 2-D variable, or asked for a missing one, raises
    IOError as the JAX package's reader does."""
    def case(k, root):
        chip_smoke.write_classic_netcdf(str(root / "c.nc"), [("band", 1), ("y", 3), ("x", 5)],
                                        _coords(), 0)
        with pytest.raises(IOError) as raised:
            k.nc.read_netcdf(str(root / "c.nc"), variable="rain" if no_record else None)
        return error(raised, root)
    run_nc(tmp_path, case)


# --- the writer ---

SETTINGS = settings(max_examples=25, deadline=None,
                    suppress_health_check=[HealthCheck.function_scoped_fixture])


@SETTINGS
@given(dtype=st.sampled_from(["f4", "f8", "i1", "i2", "i4", "u1", "u2", "i8", ">f4"]),
       bands=st.integers(1, 3), height=st.integers(1, 7), width=st.integers(1, 9),
       nodata=st.sampled_from([None, -1.0, 99.0]), packed=st.booleans(),
       projection=st.sampled_from([None, "EPSG:28992", "EPSG:4326"]))
def test_writer_writes_the_jax_writers_bytes(tmp_path, dtype, bands, height, width, nodata,
                                             packed, projection):
    """write_netcdf's bytes are the JAX writer's (every dtype, the
    unsupported ones stored as float32, packing attributes, a CRS); each
    package reads them alike."""
    values = (np.arange(bands * height * width) % 61 - 7).astype(dtype).reshape(
        bands, height, width)
    gt = (1000.0, 2.5, 0.0, 2000.0, 0.0, -2.5)
    kwargs = dict(projection=projection, no_data_value=nodata, variable="v",
                  scale_factor=0.25 if packed else None, add_offset=3.0 if packed else None)
    ours, theirs = str(tmp_path / "port.nc"), str(tmp_path / "jax.nc")
    netcdf.write_netcdf(ours, values, gt, **kwargs)
    jax_netcdf.write_netcdf(theirs, values, gt, **kwargs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    assert_same(netcdf.read_netcdf(theirs), jax_netcdf.read_netcdf(ours))


# --- the dispatch by suffix and magic ---


@pytest.mark.parametrize("suffix", [".nc", ".cdf", ".nc3", ".nc4", ".h5", ".hdf5", ".hdf", ".h4",
                                    ".hdf4"])
def test_every_suffix_reads_through_the_file_source(tmp_path, suffix):
    """A classic file under each netCDF suffix, and under each HDF
    suffix when it holds no HDF4 magic, answers through RasterFileSource
    as the JAX numpy executor does."""
    values = (np.arange(2 * 6 * 8) % 9).astype("i2").reshape(2, 6, 8)
    netcdf.write_netcdf(str(tmp_path / ("a" + suffix)), values,
                        (0.0, 1.0, 0.0, 6.0, 0.0, -1.0), projection="EPSG:28992",
                        no_data_value=8)
    request = dict(mode="vals", bbox=(1.0, 0.0, 7.0, 5.0), projection="EPSG:28992", width=12,
                   height=10, start=datetime(1970, 1, 1), stop=datetime(1970, 1, 1, 0, 5))
    with both_configs({"geomodeling.root": str(tmp_path)}):
        _, expected = assert_agrees(jax_raster.RasterFileSource("a" + suffix), request)
    assert expected["values"].shape == (2, 10, 12)


@pytest.mark.parametrize("suffix", [".hdf", ".h4", ".hdf4"])
def test_hdf4_by_its_magic_names_its_module(tmp_path, suffix):
    """An HDF4 file (by its magic) goes to the HDF4 reader, not to the
    netCDF one, in info and both read caches: one of no data set raises
    the reader's error, the JAX package's (the port read no HDF4 until
    io/hdf4.py was ported, and raised naming it)."""
    path = tmp_path / ("a" + suffix)
    path.write_bytes(b"\x0e\x03\x13\x01" + b"\x00" * 60)
    message = "HDF4 file contains no 2-D/3-D data sets: '%s'" % path
    with both_configs({"geomodeling.root": str(tmp_path)}):
        for raster in (port_raster, jax_raster):
            with pytest.raises(ValueError) as raised:
                raster.RasterFileSource("a" + suffix).info
            assert str(raised.value) == message
    for cache in (pipeline, jax_pipeline):
        with pytest.raises(ValueError) as raised:
            cache.read_geotiff_cached(str(path))
        assert str(raised.value) == message
        with pytest.raises(ValueError) as raised:
            cache.read_geotiff_window_cached(str(path), 0, 1, 0, 1)
        assert str(raised.value) == message


@needs_h5py
def test_hdf5_named_hdf_reads_as_netcdf4(tmp_path):
    """An HDF5 file named ``.hdf`` goes to the netCDF-4 reader, whole, by
    window and for info, as in the JAX package."""
    values = ((np.arange(20 * 24) * 5) % 97).astype("f4").reshape(20, 24)
    write_h5(str(tmp_path / "g.hdf"), values, np.arange(24) + 0.5, 19.5 - np.arange(20),
             chunks=(8, 8))
    request = dict(mode="vals", bbox=(2.0, 3.0, 20.0, 17.0), projection="EPSG:4326", width=18,
                   height=14)
    for limit in (None, 50):
        pipeline.clear_read_cache()
        jax_pipeline.clear_read_cache()
        with both_configs({"geomodeling.root": str(tmp_path),
                           "geomodeling.windowed-read-limit": limit}):
            assert_agrees(jax_raster.RasterFileSource("g.hdf"), request)
            port_source = port_raster.RasterFileSource("g.hdf")
            assert info_fields(port_source.info) == info_fields(
                jax_raster.RasterFileSource("g.hdf").info)
            assert (port_source._file_read_plan(request) is None) == (limit is None)


# --- RasterFileSource: info, whole and windowed against the JAX numpy executor ---


def _radar(tmp_path, records=30, size=40):
    path, _ = chip_smoke.write_radar_netcdf(str(tmp_path), records=records, size=size)
    return path


def test_radar_file_reads_alike(tmp_path):
    """chip_smoke.write_radar_netcdf at a small size: CDF-2, three record
    variables; both packages read each variable alike, the rain unpacked
    and flipped north-up, the quality as int8, the CRS from the grid
    mapping's epsg_code."""
    path = _radar(tmp_path)
    with open(path, "rb") as f:
        assert f.read(4) == b"CDF\x02"
    rain, quality = chip_smoke.radar_frames(30, 40, 21)
    for variable in (None, "precipitation", "quality"):
        ours = netcdf.read_netcdf(path, variable)
        assert_same(ours, jax_netcdf.read_netcdf(path, variable))
        assert ours.projection == "EPSG:28992"
        assert ours.geo_transform == (chip_smoke.RADAR_ORIGIN[0], 1000.0, 0.0,
                                      chip_smoke.RADAR_ORIGIN[1], 0.0, -1000.0)
    expected = rain.astype("f4") * np.float32(chip_smoke.RADAR_SCALE)
    expected[rain == chip_smoke.RADAR_FILL] = np.finfo("f4").max
    np.testing.assert_array_equal(netcdf.read_netcdf(path).array, expected)
    np.testing.assert_array_equal(netcdf.read_netcdf(path, "quality").array, quality)


@pytest.mark.parametrize("variable", [None, "quality"])
def test_file_source_info_and_answers(tmp_path, variable):
    """RasterFileSource over the radar file: its attributes and info equal
    the JAX package's and the whole decode's; the source and a temporal
    view over it answer the JAX numpy executor bitwise, read whole and
    by window under a small windowed-read limit."""
    path = _radar(tmp_path)
    time_kwargs = dict(time_first=chip_smoke.RADAR_DAY, time_delta=300000, variable=variable)
    request = chip_smoke.radar_request(size=40, px=96, cell=250.0, hours=(0, 2))
    decode = netcdf.read_netcdf(path, variable)
    for limit in (None, 200):
        pipeline.clear_read_cache()
        jax_pipeline.clear_read_cache()
        with both_configs({"geomodeling.root": str(tmp_path),
                           "geomodeling.windowed-read-limit": limit}):
            jax_source = jax_raster.RasterFileSource(path, **time_kwargs)
            port_source = port_raster.RasterFileSource(path, **time_kwargs)
            info = info_fields(port_source.info)
            assert info == info_fields(jax_source.info)
            assert (info["bands"], info["height"], info["width"]) == decode.array.shape
            assert (info["dtype"], info["geo_transform"], info["no_data_value"],
                    info["projection"]) == (str(decode.array.dtype), decode.geo_transform,
                                            decode.no_data_value, decode.projection)
            for attribute in ("dtype", "fillvalue", "projection", "geo_transform", "extent",
                              "period", "timedelta", "temporal"):
                assert getattr(port_source, attribute) == getattr(jax_source, attribute)
            assert (port_source._file_read_plan(request) is None) == (limit is None)
            assert_agrees(jax_source, dict(request, stop=request["start"]))
            assert_agrees(jax_raster.TemporalAggregate(jax_source, "1h", statistic="sum"),
                          request)


def test_radar_view_against_jax_numpy(tmp_path):
    """chip_smoke's netcdf-radar view (hourly sums smoothed) over a small
    radar file answers the JAX numpy executor bitwise, whole and by
    window, tile by tile through evaluate_tiled; the quality variable's
    answer differs."""
    path = _radar(tmp_path, records=36)
    request = chip_smoke.radar_request(size=40, px=128, cell=200.0, hours=(0, 3))
    answers = {}
    for limit in (None, 200):
        pipeline.clear_read_cache()
        with both_configs({"geomodeling.root": str(tmp_path),
                           "geomodeling.windowed-read-limit": limit}):
            view = chip_smoke.build_radar_view(path)
            jax_view = jax_raster.Smooth(jax_raster.TemporalAggregate(
                jax_raster.RasterFileSource(path, time_first=chip_smoke.RADAR_DAY,
                                            time_delta=300000), "1h", statistic="sum"),
                chip_smoke.RADAR_SMOOTH_M)
            assert view.to_json() == view.from_json(view.to_json()).to_json()
            for tile in [dict(request, width=64, height=64, bbox=bbox) for bbox in (
                    request["bbox"][:2] + (request["bbox"][0] + 12800, request["bbox"][1] + 12800),
                    (request["bbox"][0] + 12800, request["bbox"][1]) + (request["bbox"][2],
                                                                        request["bbox"][1] + 12800))]:
                assert_agrees(jax_view, tile)
            answers[limit] = evaluate_tiled(view, request, tile_size=64, batch=4, device="cpu")
            quality = evaluate_tiled(chip_smoke.build_radar_view(path, "quality"), request,
                                     tile_size=64, batch=4, device="cpu")
    assert answers[None]["values"].shape == (3, 128, 128)
    np.testing.assert_array_equal(answers[None]["values"], answers[200]["values"])
    assert not np.array_equal(quality["values"], answers[None]["values"])


# --- the (path, variable) read cache ---


def test_two_variables_two_entries_and_a_rewrite(tmp_path):
    """Each variable gets its own whole-read and window entries, hit on the
    next lookup; a rewrite of the file is decoded again in both caches."""
    pipeline.clear_read_cache()
    path = _radar(tmp_path, records=6, size=20)
    rain = pipeline.read_geotiff_cached(path, "precipitation")
    quality = pipeline.read_geotiff_cached(path, "quality")
    assert rain is not quality and rain.array.dtype == "f4" and quality.array.dtype == "i1"
    assert pipeline.read_geotiff_cached(path, "precipitation") is rain
    assert pipeline.read_geotiff_cached(path, "quality") is quality
    assert sum(key[0] == path for key in pipeline._READ_CACHE) == 2
    window = pipeline.read_geotiff_window_cached(path, 2, 9, 3, 12, variable="quality")
    np.testing.assert_array_equal(window.array, quality.array[:, 2:9, 3:12])
    assert pipeline.read_geotiff_window_cached(path, 2, 9, 3, 12, variable="quality") is window
    stamp = os.stat(path).st_mtime_ns
    time.sleep(0.01)
    chip_smoke.write_radar_netcdf(str(tmp_path), records=6, size=20, seed=22)
    os.utime(path, ns=(stamp + 10**9, stamp + 10**9))
    again = pipeline.read_geotiff_cached(path, "quality")
    assert again is not quality and not np.array_equal(again.array, quality.array)
    assert_same(again, jax_netcdf.read_netcdf(path, "quality"))
    moved = pipeline.read_geotiff_window_cached(path, 2, 9, 3, 12, variable="quality")
    np.testing.assert_array_equal(moved.array, again.array[:, 2:9, 3:12])
