"""The port's JPEG codec (native/jpegcodec.cpp), its BMP and GIF decoders
(io/jpeg.py) and every JPEG call site, held on the CPU to the JAX
package, which reads and writes these with Pillow (libjpeg-turbo 3.1.3
in this environment).

- The decoder is bitwise to Pillow over a grid of sizes (1 x 1 to 512^2),
  sampling (4:4:4, 4:2:2, 4:2:0, grayscale), qualities 1-100, optimized
  Huffman tables, progressive streams, restart markers, Adobe RGB
  (``keep_rgb``) and CMYK, and under hypothesis; a truncated or broken
  stream raises where Pillow raises, and arithmetic coding, lossless and
  12-bit samples raise NotImplementedError naming io/jpeg.py.
- The encoder writes Pillow's bytes for ``Image.fromarray(a).save(buf,
  format="jpeg")`` (and its quality and subsampling options), for L and
  RGB.
- The BMP and GIF decoders give Pillow's arrays, the formats' variants
  included (palettes, bilevel, top-down rows, RLE8 and RLE4, interlaced
  GIFs, transparency, local palettes).
- Every JPEG, BMP and GIF case of the JAX tests (tests/test_geotiff_foreign.py,
  tests/test_png_netcdf.py's TestJpeg, TestBmpGif and PAM nodata) runs once
  per package through ``run_both``; chip_smoke's ortho-jpeg files (the JPEG
  GeoTIFF, the NITF of C3 and M3 segments, the BMP and GIF writers) read
  alike in both packages; views over them come across with
  ``from_reference``.
- A failing g++ raises, naming the compiler and the source, and nothing
  falls back.
- chip_smoke's fixtures (tests/data/torch_jpeg) are Pillow's files and
  their hashes.json Pillow's arrays and bytes.

Tolerance: none.  Every array is compared bitwise and every encode byte
for byte.
"""
import hashlib
import io
import json
import os
import struct
from datetime import datetime

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from PIL import Image

import chip_smoke
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import geotiff as jax_geotiff
from dask_geomodeling_tpu.io import jpeg as jax_jpeg
from dask_geomodeling_tpu.io import nitf as jax_nitf
from dask_geomodeling_tpu.runtime import pipeline as jax_pipeline
from dask_geomodeling_tpu_torch import from_reference, native
from dask_geomodeling_tpu_torch.config import config
from dask_geomodeling_tpu_torch.io import geotiff as port_geotiff
from dask_geomodeling_tpu_torch.io import jpeg as port_jpeg
from dask_geomodeling_tpu_torch.io import nitf as port_nitf
from dask_geomodeling_tpu_torch.ops import _build
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_file_sources import assert_agrees
from tests.test_torch_raster_formats import assert_same, run_both

SIZES = [(1, 1), (1, 17), (7, 9), (17, 33), (257, 129), (512, 512)]
#: (Pillow mode, save options) of the grid's sampling columns
SAMPLING = {"444": ("RGB", {"subsampling": 0}), "422": ("RGB", {"subsampling": 1}),
            "420": ("RGB", {}), "gray": ("L", {})}
QUALITIES = (1, 50, 75, 95, 100)
VARIANTS = {
    "optimize": {"optimize": True},
    "progressive": {"progressive": True},
    "restart": {"restart_marker_blocks": 3},
    "keep-rgb": {"keep_rgb": True},
}


def pixels_of(mode, shape, seed, smooth=False):
    """Seeded uint8 pixels: noise, or a random walk along the rows (the
    texture of a photograph)."""
    rng = np.random.default_rng(seed)
    bands = {"L": (), "RGB": (3,), "CMYK": (4,)}[mode]
    full = tuple(shape) + bands
    if smooth:
        return np.clip(np.cumsum(rng.integers(-8, 9, full), axis=1) + 128, 0, 255).astype(np.uint8)
    return rng.integers(0, 256, full).astype(np.uint8)


def pillow_jpeg(pixels, mode=None, **options):
    buf = io.BytesIO()
    Image.fromarray(pixels, mode).save(buf, format="jpeg", **options)
    return buf.getvalue()


def pillow_array(blob):
    with Image.open(io.BytesIO(blob)) as image:
        return np.asarray(image)


def assert_decodes_as_pillow(blob):
    ours = native.jpeg_decode_native(blob)
    theirs = pillow_array(blob)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert np.array_equal(ours, theirs)


# --- the decoder ---


@pytest.mark.parametrize("shape", SIZES, ids=["%dx%d" % s for s in SIZES])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_decoder_bitwise_over_the_grid(shape, sampling):
    """Every quality, on noise and on texture."""
    mode, options = SAMPLING[sampling]
    for quality in QUALITIES:
        for smooth in (False, True):
            pixels = pixels_of(mode, shape, quality, smooth)
            assert_decodes_as_pillow(pillow_jpeg(pixels, mode, quality=quality, **options))


@pytest.mark.parametrize("shape", SIZES, ids=["%dx%d" % s for s in SIZES])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decoder_bitwise_on_the_variants(shape, variant):
    """Optimized tables, progressive scans (EOB runs, refinement),
    restart markers and Adobe RGB, gray and colour."""
    for mode in ("L", "RGB"):
        for quality in (50, 95):
            pixels = pixels_of(mode, shape, quality, smooth=quality == 95)
            assert_decodes_as_pillow(pillow_jpeg(pixels, mode, quality=quality,
                                                 **VARIANTS[variant]))


@pytest.mark.parametrize("shape", [(1, 1), (7, 9), (33, 17), (64, 64)])
def test_cmyk_decodes_inverted_as_pillow(shape):
    """Pillow reads CMYK as "CMYK;I" (every byte inverted); io/jpeg.py's
    conversion to RGB is Pillow's cmyk2rgb."""
    pixels = pixels_of("CMYK", shape, 5)
    blob = pillow_jpeg(pixels, "CMYK")
    assert_decodes_as_pillow(blob)
    with Image.open(io.BytesIO(blob)) as image:
        rgb = np.asarray(image.convert("RGB"))
    assert np.array_equal(port_jpeg.cmyk_to_rgb(native.jpeg_decode_native(blob)), rgb)


def test_cmyk_to_rgb_is_pillows_on_every_pair():
    """Pillow's rounding (MULDIV255) over every value and black level."""
    c, k = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    cmyk = np.stack([c, 255 - c, c // 2, k], axis=-1).astype(np.uint8)
    want = np.asarray(Image.fromarray(cmyk, "CMYK").convert("RGB"))
    assert np.array_equal(port_jpeg.cmyk_to_rgb(cmyk), want)


@settings(max_examples=40, deadline=None, suppress_health_check=list(HealthCheck))
@given(height=st.integers(1, 80), width=st.integers(1, 80), seed=st.integers(0, 2**16),
       mode=st.sampled_from(["L", "RGB"]), quality=st.integers(1, 100),
       subsampling=st.sampled_from([0, 1, 2]), progressive=st.booleans(),
       restart=st.sampled_from([0, 1, 2, 7]), smooth=st.booleans())
def test_decoder_under_hypothesis(height, width, seed, mode, quality, subsampling, progressive,
                                  restart, smooth):
    pixels = pixels_of(mode, (height, width), seed, smooth)
    blob = pillow_jpeg(pixels, mode, quality=quality, subsampling=subsampling,
                       progressive=progressive, restart_marker_blocks=restart)
    assert_decodes_as_pillow(blob)


def _raises(call):
    try:
        call()
    except Exception as error:  # the verdict is the exception
        return error
    return None


def test_truncated_streams_raise_in_both():
    """A stream cut anywhere: Pillow raises, and so does the port (never a
    partial array)."""
    for options in ({}, {"progressive": True}, {"restart_marker_blocks": 2}):
        blob = pillow_jpeg(pixels_of("RGB", (40, 56), 3, smooth=True), **options)
        for cut in list(range(0, 40)) + list(range(40, len(blob) - 2, 23)):
            assert _raises(lambda: pillow_array(blob[:cut])) is not None
            error = _raises(lambda: native.jpeg_decode_native(blob[:cut]))
            assert isinstance(error, OSError), cut


def test_corrupted_streams_raise_where_pillow_raises():
    """Single bytes of the markers overwritten: wherever Pillow raises, the
    port raises OSError too; a broken header raises in both.  (In the
    entropy-coded data libjpeg warns and goes on where it can; a scan that
    ends before its data does can leave Pillow's reader asking for more
    and calling the file truncated though libjpeg decoded it whole, which
    the port does not copy: it decodes such a stream to the array Pillow
    gives with LOAD_TRUNCATED_IMAGES.)"""
    blob = pillow_jpeg(pixels_of("RGB", (48, 64), 9, smooth=True))
    header = blob.index(b"\xff\xda") + 14
    rng = np.random.default_rng(11)
    raised = 0
    for _ in range(150):
        broken = bytearray(blob)
        broken[int(rng.integers(0, header))] = int(rng.integers(0, 256))
        broken = bytes(broken)
        if _raises(lambda: pillow_array(broken)) is not None:
            raised += 1
            assert isinstance(_raises(lambda: native.jpeg_decode_native(broken)), OSError)
    assert raised >= 5
    sof = blob.index(b"\xff\xc0")
    dht = blob.index(b"\xff\xc4")
    for broken in (b"\x00" + blob[1:],                               # no SOI
                   blob[:2] + b"\x00" + blob[3:],                    # junk after SOI
                   blob[: sof + 9] + b"\x02" + blob[sof + 10:],     # two components
                   blob[: dht + 5] + b"\xff" * 16 + blob[dht + 21:],  # more codes than fit
                   blob[:sof] + b"\xff\xab" + blob[sof + 2:]):       # an unknown marker
        assert _raises(lambda: pillow_array(broken)) is not None
        assert isinstance(_raises(lambda: native.jpeg_decode_native(broken)), OSError)


@pytest.mark.parametrize("marker, name", [(0xC9, "arithmetic"), (0xC3, "lossless"),
                                          (0xC0, "12-bit")])
def test_unported_codings_name_the_jax_module(marker, name):
    """Arithmetic coding, lossless and 12-bit samples: NotImplementedError
    naming dask_geomodeling_tpu/io/jpeg.py (Pillow refuses 12-bit, and
    reads the others)."""
    blob = bytearray(pillow_jpeg(pixels_of("L", (16, 16), 1)))
    sof = blob.index(b"\xff\xc0")
    blob[sof + 1] = marker
    if name == "12-bit":
        blob[sof + 4] = 12
    with pytest.raises(NotImplementedError, match="dask_geomodeling_tpu/io/jpeg.py"):
        native.jpeg_decode_native(bytes(blob))


def test_block_smoothing_is_refused():
    """A progressive stream whose scans stop before the AC coefficients
    are refined: libjpeg smooths its blocks, which the port does not do,
    so it refuses the stream rather than decode it otherwise."""
    blob = pillow_jpeg(pixels_of("L", (32, 32), 2, smooth=True), progressive=True)
    # keep the first scan (the DC) and end the stream there
    second = blob.index(b"\xff\xda", blob.index(b"\xff\xda") + 2)
    cut = blob[: blob.rindex(b"\xff\xc4", 0, second)] + b"\xff\xd9"
    with pytest.raises(NotImplementedError, match="block smoothing"):
        native.jpeg_decode_native(cut)


# --- the encoder ---


@pytest.mark.parametrize("shape", SIZES + [(37, 53), (75, 100)],
                         ids=["%dx%d" % s for s in SIZES + [(37, 53), (75, 100)]])
@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_encoder_writes_pillows_default_bytes(shape, mode):
    for seed, smooth in ((0, False), (1, True)):
        pixels = pixels_of(mode, shape, seed, smooth)
        assert native.jpeg_encode_native(pixels) == pillow_jpeg(pixels)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_encoder_options(quality, subsampling):
    """The C encoder at the qualities and samplings the Python entry does
    not take (Pillow's ``subsampling`` as the luma's sampling factors)."""
    factors = {0: (1, 1), 1: (2, 1), 2: (2, 2)}[subsampling]
    for mode, shape in (("RGB", (37, 53)), ("L", (17, 33)), ("RGB", (257, 129))):
        pixels = pixels_of(mode, shape, quality, smooth=True)
        assert native._jpeg_encode(pixels, quality, *factors) == pillow_jpeg(
            pixels, quality=quality, subsampling=subsampling)


def test_encoder_header_as_pillow_writes_it():
    """SOI, APP0 JFIF 1.01 (unit 0, density 1 x 1), DQT, DQT, SOF0 (Y 2 x 2,
    Cb and Cr 1 x 1), DHT DC0, AC0, DC1, AC1, SOS; split as libtiff stores
    a tile, the tables (DQT, DHT) apart and no APP0 in the tile."""
    blob = native.jpeg_encode_native(pixels_of("RGB", (37, 53), 4))
    assert blob[:20] == b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    markers, pos = [], 2
    while blob[pos + 1] != 0xDA:
        markers.append(blob[pos + 1])
        pos += 2 + struct.unpack_from(">H", blob, pos + 2)[0]
    assert markers == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4]
    sof = blob.index(b"\xff\xc0")
    assert blob[sof + 10 : sof + 19] == bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])
    tables, tile = chip_smoke.split_jpeg_tables(blob)
    dht = blob.index(b"\xff\xc4")
    assert tables == blob[:2] + blob[20:sof] + blob[dht : blob.index(b"\xff\xda")] + b"\xff\xd9"
    assert tile == blob[:2] + blob[sof:dht] + blob[blob.index(b"\xff\xda"):]


def test_encoder_refuses_what_pillow_cannot_write_as_jpeg():
    for pixels in (np.zeros((4, 4, 4), np.uint8), np.zeros((4, 4), np.uint16),
                   np.zeros((0, 4), np.uint8)):
        with pytest.raises(ValueError):
            native.jpeg_encode_native(pixels)


# --- BMP and GIF ---


def pillow_bands(blob):
    """The JAX package's read_pillow_raster conversion of a blob."""
    with Image.open(io.BytesIO(blob)) as image:
        if image.mode not in ("L", "RGB"):
            color = image.mode == "P" or len(image.getbands()) > 1
            image = image.convert("RGB" if color else "L")
        pixels = np.asarray(image)
    return pixels[None] if pixels.ndim == 2 else pixels.transpose(2, 0, 1)


def assert_reads_as_pillow(blob):
    theirs = _raises(lambda: pillow_bands(blob))
    if isinstance(theirs, Exception):
        assert _raises(lambda: port_jpeg.to_pillow_bands(port_jpeg.decode_image(blob))) \
            is not None
        return
    ours = port_jpeg.to_pillow_bands(port_jpeg.decode_image(blob))
    theirs = pillow_bands(blob)
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def _pillow_image(mode, shape, seed):
    rng = np.random.default_rng(seed)
    if mode == "1":
        return Image.fromarray(rng.integers(0, 2, shape).astype(bool))
    if mode == "P":
        rgb = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        return Image.fromarray(rgb).quantize(colors=int(rng.integers(2, 200)))
    return Image.fromarray(pixels_of(mode if mode != "RGBA" else "CMYK", shape, seed),
                           mode)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (16, 16), (17, 33), (40, 31)])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB", "RGBA"])
def test_pillows_bmp_files(shape, mode):
    buf = io.BytesIO()
    _pillow_image(mode, shape, 3).save(buf, format="BMP")
    assert_reads_as_pillow(buf.getvalue())


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (16, 16), (17, 33), (40, 31)])
@pytest.mark.parametrize("mode", ["1", "L", "P", "RGB"])
@pytest.mark.parametrize("options", [{}, {"interlace": False}, {"transparency": 0}],
                         ids=["default", "not-interlaced", "transparency"])
def test_pillows_gif_files(shape, mode, options):
    buf = io.BytesIO()
    _pillow_image(mode, shape, 4).save(buf, format="GIF", **options)
    assert_reads_as_pillow(buf.getvalue())


def bmp(width, height, bits, rows, palette=(), compression=0, topdown=False):
    """A BMP of BITMAPINFOHEADER with the given pixel bytes."""
    table = b"".join(bytes([b, g, r, 0]) for r, g, b in palette)
    offset = 14 + 40 + len(table)
    header = struct.pack("<IiiHHIIiiII", 40, width, -height if topdown else height, 1, bits,
                         compression, len(rows), 2835, 2835, len(palette), 0)
    return (b"BM" + struct.pack("<IHHI", offset + len(rows), 0, 0, offset) + header + table
            + rows)


def _nibble_rows(indices):
    stride = ((indices.shape[1] * 4 + 31) >> 3) & ~3
    out = b""
    for row in indices:
        padded = np.append(row, 0) if len(row) % 2 else row
        out += bytes((padded[0::2] << 4) | padded[1::2]).ljust(stride, b"\0")
    return out


@pytest.mark.parametrize("shape", [(3, 5), (8, 8), (9, 13)])
def test_hand_made_bmp_variants(shape):
    """What Pillow does not write: 4-bit palettes, top-down rows, a gray
    4-bit palette (Pillow's raw mode does not fit it: both raise), RLE8
    with absolute runs and a delta, RLE4."""
    height, width = shape
    rng = np.random.default_rng(width)
    palette = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(16)]
    indices = rng.integers(0, 16, shape).astype(np.uint8)
    assert_reads_as_pillow(bmp(width, height, 4, _nibble_rows(indices[::-1]), palette))
    assert_reads_as_pillow(bmp(width, height, 4, _nibble_rows(indices), palette, topdown=True))
    assert_reads_as_pillow(bmp(width, height, 4, _nibble_rows(indices[::-1]),
                               [(i, i, i) for i in range(16)]))
    palette8 = [tuple(int(v) for v in rng.integers(0, 256, 3)) for _ in range(256)]
    indices8 = rng.integers(0, 256, shape).astype(np.uint8)
    rle8 = b""
    for row in indices8[::-1]:
        rle8 += bytes([1, row[0]])
        rest = row[1:]
        if len(rest) >= 3:
            rle8 += bytes([0, len(rest)]) + bytes(rest) + (b"\0" if len(rest) % 2 else b"")
        else:
            rle8 += b"".join(bytes([1, v]) for v in rest)
        rle8 += b"\0\0"
    assert_reads_as_pillow(bmp(width, height, 8, rle8 + b"\0\1", palette8, compression=1))
    assert_reads_as_pillow(bmp(width, height, 8, bytes([2, 7, 0, 2, 3, 0]) + b"\0\1", palette8,
                               compression=1))
    rle4 = b""
    for row in indices[::-1]:
        for i in range(0, width, 2):
            n = min(2, width - i)
            rle4 += bytes([n, (row[i] << 4) | (row[i + 1] if n > 1 else 0)])
        rle4 += b"\0\0"
    assert_reads_as_pillow(bmp(width, height, 4, rle4 + b"\0\1", palette, compression=2))


@pytest.mark.parametrize("local", ["gray-ramp", "colours"])
def test_gif_local_palettes(local):
    """A frame's local palette over a global one: a gray ramp reads as L
    (Pillow's ``palette = False``), colours as P over the local table."""
    indices, palette = chip_smoke.cube_palette(chip_smoke.ortho_pixels(40, 24))
    blob = chip_smoke.gif_bytes(indices, palette)
    at = 13 + 768 + 1 + 8  # the image descriptor's flags
    table = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, axis=1)
    if local == "colours":
        table = table[::-1].copy()
    blob = blob[:at] + b"\x87" + table.tobytes() + blob[at + 1:]
    assert_reads_as_pillow(blob)
    assert port_jpeg.decode_image(blob)["mode"] == ("L" if local == "gray-ramp" else "P")


def test_gif_lzw_is_linear():
    """A 1024^2 GIF (about a million codes) decodes in a few seconds: the
    decoder writes each code's string once, through its prefix chain."""
    import time

    indices, palette = chip_smoke.cube_palette(chip_smoke.ortho_pixels(1024, 1024))
    buf = io.BytesIO()
    image = Image.fromarray(indices, "P")
    image.putpalette(palette.reshape(-1).tolist())
    image.save(buf, format="GIF")
    t0 = time.perf_counter()
    ours = port_jpeg.decode_image(buf.getvalue())
    assert time.perf_counter() - t0 < 30
    assert np.array_equal(port_jpeg.to_pillow_bands(ours), pillow_bands(buf.getvalue()))


def test_chip_smokes_bmp_and_gif_writers_read_as_pillow():
    pixels = chip_smoke.ortho_pixels(96, 80)
    indices, palette = chip_smoke.cube_palette(pixels)
    for blob in (chip_smoke.bmp_bytes(pixels), chip_smoke.bmp_bytes(indices, palette),
                 chip_smoke.gif_bytes(indices, palette)):
        assert_reads_as_pillow(blob)
    assert np.array_equal(pillow_bands(chip_smoke.bmp_bytes(pixels)), pixels.transpose(2, 0, 1))


# --- the JAX tests' JPEG, BMP and GIF cases, once per package ---


def _jpeg(k):
    return port_jpeg if k.port else jax_jpeg


def _geotiff(k):
    return port_geotiff if k.port else jax_geotiff


def _foreign_jpeg_grayscale(k, root):
    """tests/test_geotiff_foreign.py:test_read_pillow_jpeg_grayscale."""
    y, x = np.mgrid[0:128, 0:160]
    array = (96 + 48 * np.sin(x / 40.0) * np.cos(y / 32.0)).astype(np.uint8)
    path = str(root / "pil_jpeg.tif")
    Image.fromarray(array, mode="L").save(path, compression="jpeg", quality=95)
    data = _geotiff(k).read_geotiff(path)
    assert data.array.shape == (1, 128, 160)
    err = np.abs(data.array[0].astype(int) - array.astype(int))
    assert err.mean() < 1.5 and err.max() <= 12
    return data


def _foreign_jpeg_rgb(k, root):
    """tests/test_geotiff_foreign.py:test_read_pillow_jpeg_rgb."""
    y, x = np.mgrid[0:96, 0:112]
    rgb = np.stack([(120 + 60 * np.sin(x / 30.0)).astype(np.uint8),
                    (120 + 60 * np.cos(y / 25.0)).astype(np.uint8),
                    np.full_like(x, 64, dtype=np.uint8)], axis=-1)
    path = str(root / "pil_jpeg_rgb.tif")
    Image.fromarray(rgb).save(path, compression="jpeg", quality=95)
    data = _geotiff(k).read_geotiff(path)
    assert data.array.shape == (3, 96, 112)
    err = np.abs(data.array.astype(int) - rgb.transpose(2, 0, 1).astype(int))
    assert err.mean() < 3.0
    windows = [_geotiff(k).read_geotiff_window(path, 10, 70, 3, 101)]
    return data, windows


def _jpeg_with_world_file(k, root):
    """tests/test_png_netcdf.py:TestJpeg.test_jpeg_with_world_file."""
    rng = np.random.RandomState(0)
    pixels = rng.randint(0, 255, (16, 16), dtype=np.uint8)
    path = str(root / "photo.jpg")
    Image.fromarray(pixels, mode="L").save(path, quality=95)
    gt = (1000.0, 50.0, 0.0, 2800.0, 0.0, -50.0)
    (root / "photo.jgw").write_text("\n".join("%.10f" % v for v in (50.0, 0.0, 0.0, -50.0,
                                                                    1025.0, 2775.0)))
    (root / "photo.prj").write_text("EPSG:28992")
    data = _jpeg(k).read_jpeg(path)
    assert data.array.shape == (1, 16, 16)
    np.testing.assert_allclose(data.geo_transform, gt)
    assert data.projection == "EPSG:28992"
    assert np.abs(data.array[0].astype(int) - pixels.astype(int)).mean() < 20
    return data


def _jpeg_rgb_source(k, root):
    """tests/test_png_netcdf.py:TestJpeg.test_jpeg_rgb_source."""
    rng = np.random.RandomState(1)
    pixels = rng.randint(0, 255, (8, 8, 3), dtype=np.uint8)
    Image.fromarray(pixels, mode="RGB").save(str(root / "rgb.jpg"), quality=95)
    (root / "rgb.jgw").write_text("\n".join(str(v) for v in (1.0, 0.0, 0.0, -1.0, 0.5, 7.5)))
    source = k.R.RasterFileSource("rgb.jpg", time_first=datetime(2000, 1, 1))
    result = k.get_data(source, mode="vals", bbox=(0.0, 0.0, 8.0, 8.0),
                        projection=source.projection, width=8, height=8,
                        start=datetime(2000, 1, 1))
    assert result["values"].shape == (1, 8, 8)  # band 1 of 3
    return result


def _bmp_gif_roundtrip(ext, world):
    def case(k, root):
        """tests/test_png_netcdf.py:TestBmpGif.test_roundtrip_with_world_file."""
        values = np.arange(12, dtype=np.uint8).reshape(3, 4) * 20
        Image.fromarray(values, mode="L").save(str(root / ("img." + ext)))
        (root / ("img." + world)).write_text("50.0\n0.0\n0.0\n-50.0\n1025.0\n2125.0\n")
        (root / "img.prj").write_text("EPSG:28992")
        source = k.R.RasterFileSource("img." + ext, time_first=datetime(2000, 1, 1))
        assert source.projection == "EPSG:28992"
        result = k.get_data(source, mode="vals", bbox=(1000.0, 2000.0, 1200.0, 2150.0),
                            projection="EPSG:28992", width=4, height=3,
                            start=datetime(2000, 1, 1))
        np.testing.assert_array_equal(result["values"][0], values)
        return result
    return case


def _gif_palette_converts_to_rgb(k, root):
    """tests/test_png_netcdf.py:TestBmpGif.test_gif_palette_converts_to_rgb."""
    rgb = np.zeros((4, 4, 3), dtype=np.uint8)
    rgb[..., 0] = 200
    path = str(root / "pal.gif")
    Image.fromarray(rgb).convert("P").save(path)
    data = _jpeg(k).read_jpeg(path)
    assert data.array.shape == (3, 4, 4)
    assert (np.abs(data.array[0].astype(int) - 200) < 16).all()
    assert (data.array[1] == 0).all() and (data.array[2] == 0).all()
    return data


def _jpeg_pam_nodata(k, root):
    """tests/test_png_netcdf.py:test_jpeg_pam_nodata."""
    path = str(root / "pam.bmp")
    Image.fromarray(np.zeros((4, 4), np.uint8)).save(path)
    first = _jpeg(k).read_pillow_raster(path)
    assert first.no_data_value is None
    with open(path + ".aux.xml", "w") as f:
        f.write('<PAMDataset><PAMRasterBand band="1">'
                "<NoDataValue>7</NoDataValue></PAMRasterBand></PAMDataset>")
    second = _jpeg(k).read_pillow_raster(path)
    assert second.no_data_value == 7.0
    return first, second


JAX_CASES = {
    "geotiff-jpeg-grayscale": _foreign_jpeg_grayscale,
    "geotiff-jpeg-rgb": _foreign_jpeg_rgb,
    "jpeg-with-world-file": _jpeg_with_world_file,
    "jpeg-rgb-source": _jpeg_rgb_source,
    "bmp-roundtrip": _bmp_gif_roundtrip("bmp", "bpw"),
    "gif-roundtrip": _bmp_gif_roundtrip("gif", "gfw"),
    "gif-palette": _gif_palette_converts_to_rgb,
    "pam-nodata": _jpeg_pam_nodata,
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_jax_case(tmp_path, name):
    assert run_both(tmp_path, JAX_CASES[name]) is not None


# --- chip_smoke's ortho-jpeg files in both packages ---


def test_jpeg_geotiff_reads_alike(tmp_path):
    """write_jpeg_geotiff's file (abbreviated YCbCr tiles, JPEGTables):
    the JAX package (Pillow) and the port read the same, whole and by
    window, and the port's header is its own writer's."""
    pixels = chip_smoke.ortho_pixels(1100, 700)
    path = str(tmp_path / "ortho.tif")
    chip_smoke.write_jpeg_geotiff(path, pixels[:700, :1100], chip_smoke.ortho_geo_transform(),
                                  tile=256)
    ours, theirs = port_geotiff.read_geotiff(path), jax_geotiff.read_geotiff(path)
    assert_same(ours, theirs)
    assert ours.array.shape == (3, 700, 1100)
    assert np.abs(ours.array.astype(int) - pixels.transpose(2, 0, 1)).mean() < 16
    for window in [(0, 256, 0, 256), (100, 613, 250, 1031), (699, 700, 1099, 1100)]:
        assert_same(port_geotiff.read_geotiff_window(path, *window),
                    jax_geotiff.read_geotiff_window(path, *window))


def test_ortho_nitf_reads_alike(tmp_path):
    """write_ortho_nitf's C3 and M3 segments (two blocks absent): the port's
    payload and info are the JAX package's, and the values the writer
    gives."""
    pixels = chip_smoke.ortho_pixels(512, 512)
    path, values = chip_smoke.write_ortho_nitf(str(tmp_path), pixels, block=128)
    ours = port_nitf.read_nitf(path)
    assert_same(ours, jax_nitf.read_nitf(path))
    assert np.array_equal(ours.array, values)
    assert (ours.array[3:, :128, 384:] == 0).all()
    assert port_nitf.read_nitf_info(path).bands == jax_nitf.read_nitf_info(path).bands == 6


def test_small_files_and_views_come_across(tmp_path):
    """ortho_small_files' JPEG (.jgw, .prj, PAM nodata), BMPs, GIF and NITF:
    each package's whole read the same, and build_ortho_view's chain built
    with the JAX package's classes comes across with from_reference and
    answers its numpy executor, the JPEG GeoTIFF's too."""
    pixels = chip_smoke.ortho_pixels(256, 256)
    files = chip_smoke.ortho_small_files(str(tmp_path), pixels, gif_px=128, nitf_px=256)
    chip_smoke.write_jpeg_geotiff(str(tmp_path / "ortho.tif"), pixels,
                                  chip_smoke.ortho_geo_transform(), tile=128)
    files["tif"] = (str(tmp_path / "ortho.tif"), chip_smoke.ortho_request(256))
    for label, (path, request) in files.items():
        pipeline.clear_read_cache()
        jax_pipeline.clear_read_cache()
        if label != "tif":
            assert_same(pipeline.read_geotiff_cached(path), jax_pipeline.read_geotiff_cached(path))
        R = jax_raster
        source = R.RasterFileSource(path, time_first=chip_smoke.ORTHO_TIME,
                                    time_delta=chip_smoke.ORTHO_BAND_STEP)
        excess = R.Subtract(R.Subtract(R.Multiply(source, 2.0),
                                       R.Shift(source, chip_smoke.ORTHO_BAND_STEP)),
                            R.Shift(source, -chip_smoke.ORTHO_BAND_STEP))
        jax_view = R.Classify(R.Smooth(excess, chip_smoke.ORTHO_SMOOTH_M), chip_smoke.ORTHO_BINS)
        view, expected = assert_agrees(jax_view, request)
        port_view, _ = chip_smoke.build_ortho_view(path)
        assert type(view) is type(from_reference(jax_view.serialize()))
        assert_same(port_view.get_data(device="cpu", **request)["values"], expected["values"])


# --- the build: no fallback ---


@pytest.fixture
def private_build(tmp_path, monkeypatch):
    """A private _build/ and library cache: nothing built here is reused."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_LIBRARIES", {})
    monkeypatch.setattr(_build, "_NAME_LOCKS", {})
    return tmp_path


@pytest.mark.parametrize("failure", ["fails", "missing"])
def test_a_failing_compiler_raises_and_nothing_falls_back(private_build, monkeypatch, tmp_path,
                                                          failure):
    import shutil

    if failure == "fails":
        monkeypatch.setattr(_build, "gxx_path", lambda: shutil.which("false"))
        message = "g\\+\\+ failed on .*jpegcodec.cpp"
    else:
        monkeypatch.setattr(_build, "gxx_path", lambda: str(tmp_path / "no-such-g++"))
        message = "g\\+\\+ could not run on .*jpegcodec.cpp"
    blob = pillow_jpeg(pixels_of("RGB", (8, 8), 0))
    with pytest.raises(RuntimeError, match=message):
        native.load_jpegcodec()
    with pytest.raises(RuntimeError, match=message):
        native.jpeg_decode_native(blob)
    with pytest.raises(RuntimeError, match=message):
        native.jpeg_encode_native(pixels_of("RGB", (8, 8), 0))
    path = str(tmp_path / "photo.jpg")
    with open(path, "wb") as f:
        f.write(blob)
    with pytest.raises(RuntimeError, match=message):
        port_jpeg.read_jpeg(path)
    tif = str(tmp_path / "jpeg.tif")
    Image.fromarray(pixels_of("L", (16, 16), 0)).save(tif, compression="jpeg")
    with pytest.raises(RuntimeError, match=message):
        port_geotiff.read_geotiff(tif)


def test_the_codec_builds_outside_its_sources():
    native.load_jpegcodec()
    here = os.path.dirname(native.__file__)
    assert not [name for name in os.listdir(here) if name.endswith((".so", ".bin"))]
    assert any(name.startswith("libjpegcodec-") for name in os.listdir(_build.BUILD_DIR))


def test_native_counts():
    native.reset_counts()
    blob = native.jpeg_encode_native(pixels_of("RGB", (20, 30), 0))
    native.jpeg_decode_native(blob)
    assert native.counts["jpeg_encodes"] == 1 and native.counts["jpeg_encoded_bytes"] == len(blob)
    assert native.counts["jpeg_decodes"] == 1 and native.counts["jpeg_bytes"] == 20 * 30 * 3


# --- chip_smoke's fixtures ---


def test_chip_smoke_fixtures_are_pillows():
    """Each file of tests/data/torch_jpeg is what Pillow writes for its
    JPEG_FIXTURES entry, hashes.json holds Pillow's decoded arrays and
    Pillow's bytes for JPEG_ENCODES, and check_jpeg_fixtures holds the port
    to them."""
    folder, recorded = chip_smoke.jpeg_fixture_hashes()
    for name, (mode, shape, options) in chip_smoke.JPEG_FIXTURES.items():
        blob = pillow_jpeg(chip_smoke.jpeg_fixture_array(mode, shape), mode, **options)
        with open(os.path.join(folder, name), "rb") as f:
            assert f.read() == blob, name
        array = pillow_array(blob)
        assert recorded["decoded"][name] == {"shape": list(array.shape),
                                             "sha256": chip_smoke.array_sha256(array)}
        assert len(blob) < 8192
    for name, (mode, shape) in chip_smoke.JPEG_ENCODES.items():
        blob = pillow_jpeg(chip_smoke.jpeg_fixture_array(mode, shape))
        assert recorded["encoded"][name]["sha256"] == hashlib.sha256(blob).hexdigest()
    assert sorted(os.listdir(folder)) == sorted(list(chip_smoke.JPEG_FIXTURES) + ["hashes.json"])
    assert chip_smoke.check_jpeg_fixtures("cpu") == len(recorded["decoded"]) + len(
        recorded["encoded"])
    with open(os.path.join(folder, "hashes.json")) as f:
        assert json.load(f) == recorded


# --- chip_smoke's ortho-jpeg phase on the CPU ---


def test_the_phase_on_the_cpu(tmp_path, monkeypatch):
    """check_ortho_jpeg on CPU tensors over a 1024^2 orthophoto, a 512^2
    sub-area, 2 GetMaps a zoom, 256^2 tiles in batches of 8, the
    windowed-read limit lowered: every check of the full run, the files
    removed."""
    from dask_geomodeling_tpu_torch.ops import cuda_stencils
    from dask_geomodeling_tpu_torch.raster import spatial

    def launching(*args, **kwargs):
        cuda_stencils.launches += 1
        return cuda_stencils.gaussian_blur_reference(*args, **kwargs)

    monkeypatch.setattr(spatial, "gaussian_blur", launching)
    monkeypatch.setattr(chip_smoke, "TILE", 256)
    monkeypatch.setattr(chip_smoke, "BATCH", 8)
    with config.set({"geomodeling.torch-device": "cpu",
                     "geomodeling.windowed-read-limit": 100_000}):
        launches, numbers, kernels = chip_smoke.check_ortho_jpeg(
            "cpu", "cpu", str(tmp_path), px=1024, sub_px=512, sampled_tiles=2, wms_per_zoom=2,
            gif_px=256, nitf_px=512)
    assert launches["gaussian_blur"] >= 10 and launches["moving_max"] == 0
    assert kernels == [] and numbers["native_decodes"] >= 4
    assert numbers["gaussian_dtype"] == "float64" and numbers["wms"]["tiles"] >= 4
    assert sorted(numbers["small_files"]) == ["bmp-24bit", "bmp-8bit", "gif", "jpg", "nitf",
                                             "nitf-half", "nitf-m3"]
    assert numbers["nitf_half_ties"]["classes"] == 0
    assert numbers["wms"]["host_equal"] == numbers["wms"]["tiles"]
    assert not list(tmp_path.iterdir())
