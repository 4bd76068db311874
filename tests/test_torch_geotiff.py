"""The port's GeoTIFF and VRT codec against the JAX package's.

- the port's writer gives the JAX writer's bytes for every dtype (and
  bool), strips and tiles, no compression and deflate, forced BigTIFF,
  big-endian, and COG with nearest and average overviews;
- each package reads every file the other writes, with the same array,
  geotransform, projection, nodata and band metadata;
- the foreign files of tests/test_geotiff_foreign.py (LZW, PackBits,
  LZMA, predictor 2, big-endian, georeferenced) and chunky multi-band
  files read the same in both packages; the JAX writer's files are planar;
- ``read_geotiff_window`` equals the matching slice of ``read_geotiff``,
  at full resolution and on overview levels;
- PAM sidecars override nodata and SRS, external overviews are the same
  bytes, and ``build_vrt`` writes the same XML.
"""
import dataclasses
import lzma
import zlib

import numpy as np
import pytest

from dask_geomodeling_tpu.io import geotiff as J
from dask_geomodeling_tpu.io import vrt as JV
from dask_geomodeling_tpu_torch.geo.crs import get_epsg_or_wkt, get_sr
from dask_geomodeling_tpu_torch.io import geotiff as P
from dask_geomodeling_tpu_torch.io import vrt as PV
from tests.test_geotiff_foreign import lzw_encode, packbits_encode, write_minimal_tiff

GT = (135000.0, 0.5, 0.0, 456000.0, 0.0, -0.5)
DTYPES = ["u1", "i1", "u2", "i2", "u4", "i4", "f4", "f8", "bool"]
NODATA = {"u1": 255, "i1": -128, "u2": 65535, "i2": -9999, "u4": 4294967295,
          "i4": -2147483648, "f4": -9999.0, "f8": np.nan, "bool": None}
LAYOUTS = {
    "strips-none": dict(compress="none"),
    "strips-deflate": dict(compress="deflate"),
    "tiles-none": dict(compress="none", tiled=True, tile_size=32),
    "tiles-deflate": dict(compress="deflate", tiled=True, tile_size=32),
    "bigtiff": dict(tiled=True, tile_size=16, bigtiff=True),
    "big-endian": dict(byte_order=">", tiled=True, tile_size=32),
    "cog-nearest": dict(cog=True, tile_size=16, overviews=[2, 4]),
    "cog-average": dict(cog=True, tile_size=16, overviews=[2, 4],
                        overview_resampling="average"),
}


def array_of(dtype, shape=(2, 45, 70), seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        return rng.rand(*shape) > 0.5
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        data = (rng.randn(*shape) * 100).astype(dtype)
    else:
        info = np.iinfo(dtype)
        data = rng.randint(max(info.min, -(2**31)), min(info.max, 2**31 - 1), size=shape,
                           dtype=np.int64).astype(dtype)
    data.flat[::17] = NODATA[dtype.str[1:]]
    return data


def same_info(a, b):
    """Headers of the two packages' GeoTIFFInfo classes equal (NaN too)."""
    return repr(dataclasses.asdict(a)) == repr(dataclasses.asdict(b))


def write_both(tmp_path, array, no_data_value, metadata=None, **kwargs):
    paths = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    for writer, path in zip((J.write_geotiff, P.write_geotiff), paths):
        writer(path, array, GT, "EPSG:28992", no_data_value, metadata=metadata, **kwargs)
    return paths


def assert_same_data(a, b):
    assert a.array.dtype == b.array.dtype
    np.testing.assert_array_equal(a.array, b.array)
    assert tuple(a.geo_transform) == tuple(b.geo_transform)
    assert a.projection == b.projection
    assert a.no_data_value == b.no_data_value or (
        np.isnan(a.no_data_value) and np.isnan(b.no_data_value))
    assert a.metadata == b.metadata


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_writer_bytes_and_both_readers(tmp_path, dtype, layout):
    kwargs = LAYOUTS[layout]
    array = array_of(dtype)
    nodata = NODATA[dtype]
    if kwargs.get("overview_resampling") == "average" and dtype == "f8":
        nodata = -9999.0  # the average skips nodata by equality
    jax_path, port_path = write_both(tmp_path, array, nodata, metadata=["a", {"b": 1}], **kwargs)
    with open(jax_path, "rb") as f, open(port_path, "rb") as g:
        assert f.read() == g.read()
    expected = array.astype(np.uint8) if dtype == "bool" else array
    for path in (jax_path, port_path):
        port, jax = P.read_geotiff(path), J.read_geotiff(path)
        assert_same_data(port, jax)
        np.testing.assert_array_equal(port.array, expected)
        assert port.projection == "EPSG:28992" and port.metadata == ["a", {"b": 1}]
    assert same_info(P.read_geotiff_info(port_path), J.read_geotiff_info(jax_path))
    overviews = P.read_geotiff_overviews(port_path)
    assert overviews == J.read_geotiff_overviews(jax_path)
    for level in range(1, len(overviews) + 1):
        assert_same_data(P.read_geotiff_window(port_path, 3, 20, 1, 30, level=level),
                         J.read_geotiff_window(jax_path, 3, 20, 1, 30, level=level))


FOREIGN = {
    "lzw": (5, lzw_encode, 1, "<"),
    "lzw-predictor": (5, lzw_encode, 2, "<"),
    "packbits": (32773, packbits_encode, 1, "<"),
    "deflate-predictor": (8, zlib.compress, 2, "<"),
    "lzma": (34925, lambda d: lzma.compress(d, format=lzma.FORMAT_XZ), 1, "<"),
    "none-big-endian": (1, lambda d: d, 1, ">"),
    "lzw-predictor-big-endian": (5, lzw_encode, 2, ">"),
}


@pytest.mark.parametrize("dtype", ["u1", "u2", "i4"])
@pytest.mark.parametrize("case", sorted(FOREIGN))
def test_foreign_files(tmp_path, case, dtype):
    compression, encoder, predictor, byte_order = FOREIGN[case]
    array = (np.random.RandomState(1).rand(40, 50) * 250).astype(dtype)
    path = str(tmp_path / "foreign.tif")
    write_minimal_tiff(path, array, compression, encoder, predictor, byte_order, epsg=28992)
    port = P.read_geotiff(path)
    assert_same_data(port, J.read_geotiff(path))
    np.testing.assert_array_equal(port.array[0], array)
    assert port.projection == "EPSG:28992"
    assert same_info(P.read_geotiff_info(path), J.read_geotiff_info(path))
    assert_same_data(P.read_geotiff_window(path, 5, 17, 9, 41),
                     J.read_geotiff_window(path, 5, 17, 9, 41))


@pytest.mark.parametrize("compression", ["raw", "tiff_lzw", "packbits"])
def test_chunky_multiband(tmp_path, compression):
    """A 3-sample chunky (contig) file written by libtiff through Pillow."""
    image = pytest.importorskip("PIL.Image")
    rgb = (np.random.RandomState(2).rand(37, 53, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "rgb.tif")
    image.fromarray(rgb).save(path, compression=compression)
    port = P.read_geotiff(path)
    assert_same_data(port, J.read_geotiff(path))
    np.testing.assert_array_equal(port.array, rgb.transpose(2, 0, 1))
    assert_same_data(P.read_geotiff_window(path, 4, 30, 7, 20),
                     J.read_geotiff_window(path, 4, 30, 7, 20))


WINDOWS = [(0, 45, 0, 70), (10, 30, 5, 66), (0, 1, 69, 70), (44, 45, 0, 1), (-5, 100, -3, 200),
           (20, 20, 10, 10)]


@pytest.mark.parametrize("layout", ["strips-deflate", "tiles-deflate", "cog-nearest"])
@pytest.mark.parametrize("window", WINDOWS)
def test_window_is_the_slice(tmp_path, layout, window):
    array = array_of("f4")
    _, path = write_both(tmp_path, array, -9999.0, **LAYOUTS[layout])
    whole = P.read_geotiff(path)
    row0, row1, col0, col1 = window
    got = P.read_geotiff_window(path, row0, row1, col0, col1)
    assert_same_data(got, J.read_geotiff_window(path, row0, row1, col0, col1))
    r0, c0 = max(0, row0), max(0, col0)
    r1, c1 = max(r0 + 1, min(45, row1)), max(c0 + 1, min(70, col1))
    np.testing.assert_array_equal(got.array, whole.array[:, r0:r1, c0:c1])
    assert got.geo_transform == (GT[0] + c0 * GT[1], GT[1], 0.0, GT[3] + r0 * GT[5], 0.0, GT[5])


def test_overview_window_is_the_slice(tmp_path):
    array = array_of("i2", shape=(1, 90, 70))
    _, path = write_both(tmp_path, array, -9999, **LAYOUTS["cog-nearest"])
    for level, factor in [(1, 2), (2, 4)]:
        whole = P.read_geotiff_window(path, 0, 2**62, 0, 2**62, level=level)
        np.testing.assert_array_equal(whole.array, array[:, ::factor, ::factor])
        window = P.read_geotiff_window(path, 3, 11, 2, 9, level=level)
        np.testing.assert_array_equal(window.array, whole.array[:, 3:11, 2:9])
    with pytest.raises(ValueError, match="overview level 3"):
        P.read_geotiff_window(path, 0, 1, 0, 1, level=3)


def test_pam_sidecar(tmp_path):
    _, path = write_both(tmp_path, np.arange(16, dtype=np.uint8).reshape(1, 4, 4), 255)
    with open(path + ".aux.xml", "w") as f:
        f.write('<PAMDataset><SRS>%s</SRS><PAMRasterBand band="1"><NoDataValue>42'
                "</NoDataValue></PAMRasterBand></PAMDataset>" % get_sr("EPSG:4326").ExportToWkt())
    port = P.read_geotiff_info(path)
    assert same_info(port, J.read_geotiff_info(path))
    assert port.no_data_value == 42.0 and P.read_geotiff(path).no_data_value == 42.0
    assert get_epsg_or_wkt(port.projection) == "EPSG:4326"
    with open(path + ".aux.xml", "w") as f:
        f.write("<PAMDataset><NoDataValue>not a number")
    assert P.read_geotiff_info(path).no_data_value == 255.0


@pytest.mark.parametrize("resampling", ["nearest", "average"])
def test_external_overviews(tmp_path, resampling):
    array = array_of("f4", shape=(1, 64, 48))
    jax_path, port_path = write_both(tmp_path, array, -9999.0)
    J.write_external_overviews(jax_path, [2, 4], resampling)
    P.write_external_overviews(port_path, [2, 4], resampling)
    with open(jax_path + ".ovr", "rb") as f, open(port_path + ".ovr", "rb") as g:
        assert f.read() == g.read()
    assert P.read_geotiff_overviews(port_path) == [(24, 32), (12, 16)]
    assert_same_data(P.read_geotiff_window(port_path, 0, 16, 0, 12, level=2),
                     J.read_geotiff_window(jax_path, 0, 16, 0, 12, level=2))


def test_corrupt_file_raises_value_error(tmp_path):
    _, path = write_both(tmp_path, array_of("u1"), 255, **LAYOUTS["tiles-deflate"])
    with open(path, "rb") as f:
        head = f.read(600)
    with open(path, "wb") as f:
        f.write(head)
    with pytest.raises(ValueError):
        P.read_geotiff(path)
    with open(path, "wb") as f:
        f.write(b"GIF89a not a tiff")
    with pytest.raises(ValueError, match="Not a TIFF"):
        P.read_geotiff_info(path)


def _mosaic(tmp_path, build):
    """Four tiles of a 60x80 u2 grid (one missing) and their VRT."""
    array = array_of("u2", shape=(1, 60, 80))
    paths = []
    for row0, col0 in [(0, 0), (0, 40), (30, 0)]:
        gt = (GT[0] + col0 * GT[1], GT[1], 0.0, GT[3] + row0 * GT[5], 0.0, GT[5])
        path = str(tmp_path / ("t%d_%d.tif" % (row0, col0)))
        P.write_geotiff(path, array[:, row0 : row0 + 30, col0 : col0 + 40], gt, "EPSG:28992",
                        65535, compress="deflate", tiled=True, tile_size=16)
        paths.append(path)
    target = str(tmp_path / ("%s.vrt" % build.__module__.split(".")[0]))
    build(target, paths)
    return target, array


def test_vrt(tmp_path):
    port_path, array = _mosaic(tmp_path, PV.build_vrt)
    jax_path, _ = _mosaic(tmp_path, JV.build_vrt)
    with open(port_path) as f, open(jax_path) as g:
        assert f.read() == g.read()
    assert same_info(PV.read_vrt_info(port_path), JV.read_vrt_info(port_path))
    whole = PV.read_vrt(port_path)
    assert_same_data(whole, JV.read_vrt(port_path))
    expected = array.copy()
    expected[:, 30:, 40:] = 65535  # the missing member reads as nodata
    np.testing.assert_array_equal(whole.array, expected)
    for window in [(0, 60, 0, 80), (25, 35, 35, 45), (59, 60, 79, 80), (31, 50, 41, 79)]:
        got = PV.read_vrt_window(port_path, *window)
        assert_same_data(got, JV.read_vrt_window(port_path, *window))
        np.testing.assert_array_equal(got.array, whole.array[:, window[0]:window[1],
                                                             window[2]:window[3]])


def test_jpeg_and_webp_chunks_are_not_ported(tmp_path):
    """JPEG chunks (compression 7, the IFD's JPEGTables spliced in) read
    as the JAX package reads them with Pillow: the port's native codec
    gives the same bytes, gray and RGB, tiled and stripped.  WebP, which
    the JAX package reads and writes with Pillow, is ported now (the name
    stays): the port's writer writes lossless WebP chunks of its own
    encoder, which both packages read back to the pixels written."""
    image = pytest.importorskip("PIL.Image")
    smooth = np.add.outer(np.arange(32), np.arange(48)).astype(np.uint8)
    rgb = np.stack([smooth, smooth[::-1], 255 - smooth], axis=-1)
    for name, pixels, options in (("gray.tif", smooth, {}), ("rgb.tif", rgb, {}),
                                  ("tiled.tif", rgb, {"tile": (16, 16)})):
        path = str(tmp_path / name)
        image.fromarray(pixels).save(path, compression="jpeg", quality=95, **options)
        assert_same_data(P.read_geotiff(path), J.read_geotiff(path))
        assert_same_data(P.read_geotiff_window(path, 3, 29, 5, 40),
                         J.read_geotiff_window(path, 3, 29, 5, 40))
    path = str(tmp_path / "webp.tif")
    P.write_geotiff(path, smooth[None], GT, "EPSG:28992", None, compress="webp")
    assert_same_data(P.read_geotiff(path), J.read_geotiff(path))
    assert np.array_equal(P.read_geotiff(path).array[0], smooth)


CRS_CASES = {
    "etrs89-utm32n": "EPSG:25832",
    "lambert-93": "EPSG:2154",
    "wkt-only": 'PROJCS["unnamed",GEOGCS["GRS 1980",DATUM["unknown",SPHEROID["GRS80",6378137,'
                '298.257222101]],PRIMEM["Greenwich",0],UNIT["degree",0.0174532925199433]],'
                'PROJECTION["Transverse_Mercator"],PARAMETER["latitude_of_origin",0],'
                'PARAMETER["central_meridian",7.5],PARAMETER["scale_factor",0.9996],'
                'PARAMETER["false_easting",500000],PARAMETER["false_northing",0],'
                'UNIT["metre",1]]',
    "proj4-only": "+proj=laea +lat_0=52 +lon_0=10 +x_0=4321000 +y_0=3210000 +ellps=GRS80 +units=m",
}


@pytest.mark.parametrize("case", sorted(CRS_CASES))
def test_any_crs_round_trips_as_the_jax_writer_writes_it(tmp_path, case):
    """A GeoTIFF in a CRS outside RD New, web Mercator and WGS 84: an EPSG
    code writes its code, a WKT or proj4 string without one writes the
    user-defined (32767) key with its WKT; the bytes are the JAX writer's
    and each package reads the same projection back from either file."""
    projection = CRS_CASES[case]
    array = array_of("f4", shape=(1, 20, 30))
    paths = str(tmp_path / "jax.tif"), str(tmp_path / "port.tif")
    for writer, path in zip((J.write_geotiff, P.write_geotiff), paths):
        writer(path, array, (362000.0, 1.0, 0.0, 5792000.0, 0.0, -1.0), projection, -9999.0,
               compress="deflate", tiled=True, tile_size=16)
    with open(paths[0], "rb") as f, open(paths[1], "rb") as g:
        assert f.read() == g.read()
    for path in paths:
        port, jax = P.read_geotiff(path), J.read_geotiff(path)
        assert_same_data(port, jax)
        if projection.startswith("EPSG:"):
            assert port.projection == projection
        else:
            assert get_sr(port.projection).code is None
            assert get_sr(port.projection).ExportToWkt() == get_sr(projection).ExportToWkt()
