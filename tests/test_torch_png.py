"""The port's PNG codec (io/png.py) against the JAX package's.

- the writer gives the JAX writer's bytes for 1 to 4 bands, uint8 and
  uint16, and Pillow reads them back as written;
- the reader decodes what Pillow writes (palettes with and without
  transparency, 1- and 16-bit grey, grey-alpha, RGB, RGBA) and PNGs whose
  scanlines carry each of the five filters (made here, filter by filter)
  as the JAX reader does, and as Pillow reads them;
- a ``.png`` RasterFileSource with a world file and a .prj is bitwise to
  the JAX package's numpy executor, and the read cache holds it.
"""
import struct
import zlib
from io import BytesIO

import numpy as np
import pytest
from PIL import Image

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.io import png as jax_png
from dask_geomodeling_tpu.raster import RasterFileSource as JaxRasterFileSource
from dask_geomodeling_tpu.raster import Smooth as JaxSmooth
from dask_geomodeling_tpu_torch import compute_host, from_reference
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io import png
from dask_geomodeling_tpu_torch.runtime import pipeline


def image(bands, dtype, height=13, width=17, seed=0):
    rng = np.random.RandomState(seed)
    high = 256 if dtype == np.uint8 else 65536
    return rng.randint(0, high, (bands, height, width)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("bands", [1, 2, 3, 4])
def test_writer_gives_the_jax_writers_bytes(bands, dtype):
    values = image(bands, dtype, seed=bands)
    raw = png.write_png_bytes(values)
    assert raw == jax_png.write_png_bytes(values)
    with Image.open(BytesIO(raw)) as img:
        pixels = np.asarray(img)
    if bands == 1:
        np.testing.assert_array_equal(pixels, values[0])
    elif dtype == np.uint8:
        np.testing.assert_array_equal(pixels, values.transpose(1, 2, 0))
    decoded, nodata = png.decode_png_bytes(raw)
    np.testing.assert_array_equal(decoded, values)
    assert decoded.dtype == values.dtype and nodata is None


def test_writer_takes_a_plane_and_refuses_five_bands():
    plane = image(1, np.uint8)[0]
    assert png.write_png_bytes(plane) == jax_png.write_png_bytes(plane)
    with pytest.raises(ValueError, match="1-4 bands"):
        png.write_png_bytes(image(5, np.uint8))


def pillow_images():
    rng = np.random.RandomState(7)
    rgb = rng.randint(0, 256, (11, 19, 3)).astype(np.uint8)
    smooth = np.add.outer(np.arange(11), np.arange(19)).astype(np.uint8) * 9
    palette = Image.fromarray(smooth % 16).convert("P")
    palette.putpalette(list(range(48)) * 16)
    transparent = palette.copy()
    transparent.info["transparency"] = bytes([255] * 5 + [0] + [128] * 10)
    grey16 = Image.fromarray((rng.randint(0, 65536, (11, 19))).astype(np.uint16))
    grey16_trns = grey16.copy()
    grey16_trns.info["transparency"] = 4321
    return {
        "grey": (Image.fromarray(smooth), {}),
        "grey-noise": (Image.fromarray(rgb[..., 0]), {}),
        "bilevel": (Image.fromarray(smooth > 90), {}),
        "grey16": (grey16, {}),
        "grey16-transparent": (grey16_trns, {"transparency": 4321}),
        "grey-alpha": (Image.fromarray(rgb[..., :2].copy(), "LA"), {}),
        "rgb": (Image.fromarray(rgb), {}),
        "rgb-gradient": (Image.fromarray(np.stack([smooth] * 3, -1)), {}),
        "rgba": (Image.fromarray(np.concatenate([rgb, rgb[..., :1]], -1)), {}),
        "palette": (palette, {}),
        "palette-transparent": (transparent, {"transparency": transparent.info["transparency"]}),
    }


@pytest.mark.parametrize("name", sorted(pillow_images()))
def test_reader_reads_pillow_pngs_as_the_jax_reader(name):
    img, save_args = pillow_images()[name]
    stream = BytesIO()
    img.save(stream, format="PNG", **save_args)
    raw = stream.getvalue()
    array, nodata = png.decode_png_bytes(raw)
    expected, expected_nodata = jax_png.decode_png_bytes(raw)
    np.testing.assert_array_equal(array, expected)
    assert array.dtype == expected.dtype
    assert nodata == expected_nodata
    with Image.open(BytesIO(raw)) as back:
        pixels = np.asarray(back)
    if pixels.ndim == 2:
        np.testing.assert_array_equal(array[0], pixels.astype(array.dtype))
    else:
        np.testing.assert_array_equal(array, pixels.transpose(2, 0, 1))


def _filter_row(row, prev, bpp, kind):
    """One scanline (int32 bytes) under PNG filter ``kind`` (0 None, 1 Sub,
    2 Up, 3 Average, 4 Paeth), given the previous scanline."""
    left = np.concatenate([np.zeros(bpp, np.int32), row[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(row)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = prev
    elif kind == 3:
        pred = (left + prev) // 2
    else:
        p = left + prev - up_left
        pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
    return bytes([kind]) + ((row - pred) % 256).astype(np.uint8).tobytes()


def _png(values, kinds):
    """A PNG of (bands, h, w) uint8/uint16 data whose scanline r carries
    filter ``kinds[r % len(kinds)]``."""
    bands, height, width = values.shape
    depth = 16 if values.dtype == np.uint16 else 8
    interleaved = values.transpose(1, 2, 0).astype(">u2" if depth == 16 else np.uint8)
    rows = np.frombuffer(interleaved.tobytes(), np.uint8).reshape(height, -1).astype(np.int32)
    bpp = bands * depth // 8
    previous = np.vstack([np.zeros_like(rows[:1]), rows[:-1]])
    lines = b"".join(_filter_row(rows[r], previous[r], bpp, kinds[r % len(kinds)])
                     for r in range(height))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", width, height, depth, {1: 0, 2: 4, 3: 2, 4: 6}[bands], 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(lines)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("bands", [1, 3, 4])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (0, 1, 2, 3, 4)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_reader_undoes_every_filter(kinds, bands, dtype):
    values = image(bands, dtype, height=9, width=11, seed=len(kinds) + bands)
    raw = _png(values, kinds)
    array, _ = png.decode_png_bytes(raw)
    np.testing.assert_array_equal(array, values)
    np.testing.assert_array_equal(array, jax_png.decode_png_bytes(raw)[0])
    with Image.open(BytesIO(raw)) as img:
        pixels = np.asarray(img)
    if dtype == np.uint8:
        np.testing.assert_array_equal(array, pixels.reshape(9, 11, bands).transpose(2, 0, 1))


def test_reader_refuses_what_the_jax_reader_refuses():
    for module in (png, jax_png):
        with pytest.raises(IOError, match="Not a PNG"):
            module.decode_png_bytes(b"GIF89a" + bytes(20))
    raw = bytearray(png.write_png_bytes(image(1, np.uint8)))
    raw[28] = 1  # IHDR's interlace method: Adam7
    raw[29:33] = struct.pack(">I", zlib.crc32(bytes(raw[12:29])) & 0xFFFFFFFF)
    for module in (png, jax_png):
        with pytest.raises(NotImplementedError, match="Adam7"):
            module.decode_png_bytes(bytes(raw))


GT = (135000.0, 0.5, 0.0, 456010.0, 0.0, -0.5)


@pytest.fixture
def root(tmp_path):
    pipeline.clear_read_cache()
    with jax_config.set({"geomodeling.root": str(tmp_path), "geomodeling.executor": "numpy"}), \
            config.set({"geomodeling.root": str(tmp_path), "geomodeling.torch-device": "cpu"}):
        yield tmp_path
    pipeline.clear_read_cache()


def test_write_png_sidecars_match(root):
    values = image(1, np.uint16, height=20, width=30)
    png.write_png(str(root / "port.png"), values, GT, "EPSG:28992")
    jax_png.write_png(str(root / "jax.png"), values, GT, "EPSG:28992")
    for ext in (".png", ".pgw", ".prj"):
        assert (root / ("port" + ext)).read_bytes() == (root / ("jax" + ext)).read_bytes()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_png_file_source_is_bitwise_to_the_numpy_executor(root, dtype):
    values = image(1, dtype, height=20, width=30, seed=3)
    jax_png.write_png(str(root / "dem.png"), values, GT, "EPSG:28992")
    jax_view = JaxSmooth(JaxRasterFileSource("dem.png"), 1.5)
    for view in (jax_view.store, jax_view):
        port_view = from_reference(view.serialize())
        assert port_view.projection == view.projection == "EPSG:28992"
        assert tuple(port_view.geo_transform) == tuple(view.geo_transform)
        assert port_view.dtype == view.dtype
        for request in [
            dict(mode="vals", bbox=(135000.0, 456000.0, 135015.0, 456010.0),
                 projection="EPSG:28992", width=30, height=20),
            dict(mode="vals", bbox=(135002.0, 456001.0, 135012.0, 456009.0),
                 projection="EPSG:28992", width=13, height=7),
            dict(mode="vals", bbox=(135003.1, 456004.2, 135003.1, 456004.2),
                 projection="EPSG:28992", width=1, height=1),
            dict(mode="meta", start=None, stop=None),
            dict(mode="time", start=None, stop=None),
        ]:
            expected = view.get_data(**request)
            for actual in (port_view.get_data(**request),
                           compute_host(*port_view.get_compute_graph(**request))):
                assert sorted(actual) == sorted(expected)
                if request["mode"] == "vals":
                    np.testing.assert_array_equal(actual["values"], expected["values"])
                    assert actual["values"].dtype == expected["values"].dtype
                    assert actual["no_data_value"] == expected["no_data_value"]
                else:
                    assert actual == expected


def test_png_read_cache_decodes_once(root, monkeypatch):
    jax_png.write_png(str(root / "a.png"), image(3, np.uint8), GT, "EPSG:28992")
    decodes = []
    original = png.read_png
    monkeypatch.setattr(png, "read_png", lambda path: decodes.append(path) or original(path))
    first = pipeline.read_geotiff_cached(str(root / "a.png"))
    assert pipeline.read_geotiff_cached(str(root / "a.png")) is first
    assert len(decodes) == 1
    assert first.array.shape == (3, 13, 17)
    assert first.projection == "EPSG:28992"
    assert tuple(first.geo_transform) == jax_png.read_png(str(root / "a.png")).geo_transform
