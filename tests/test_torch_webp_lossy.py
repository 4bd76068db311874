"""The port's lossy WebP decoder (VP8 key frames and the ALPH chunk, in
native/webpcodec.cpp) and every lossy WebP call site, held on the CPU to
the JAX package, which reads WebP with Pillow (12.1.0 over libwebp 1.6.0
here).

- Pillow's lossy files: ortho-like, smooth, noisy and few-colour content,
  sizes from 1 x 1 to 512 x 512, qualities 0-100, methods 0, 4 and 6, and
  RGBA at alpha qualities 0, 50 and 100 (varied and all-opaque alpha):
  each decodes to Pillow's array, bitwise.
- libwebp's encoder through ctypes (the library Pillow bundles; its
  WebPConfig and WebPPicture written out here as 1.6.0 lays them out),
  for what Pillow's save never writes: 2, 4 and 8 token partitions, the
  simple loop filter and none, sharpness 0-7, 1-4 segments, raw and
  filtered ALPH planes.  The written frame header is parsed to show the
  settings landed; each file decodes to Pillow's array, and its Y, U and V
  planes to libwebp's WebPDecodeYUV.
- The JAX functions (io/geotiff.py's _decode_image_chunk, io/gpkg_raster.py's
  _decode_tile) and the port's on the same blobs; GDAL-layout lossy WebP
  GeoTIFFs (RGB, and RGBA with ALPH) through RasterFileSource, whole and by
  window, compute_host against the JAX numpy executor; GeoPackage and
  MBTiles pyramids of lossy tiles.
- chip_smoke's lossy chunks (tests/data/torch_webp/ortho-lossy) are
  Pillow's, and hashes.json holds Pillow's arrays of them.

Tolerance: none.  Every array is compared bitwise.
"""
import ctypes
import glob
import io
import json
import os
import sqlite3

import numpy as np
import PIL
import pytest
from PIL import Image

import chip_smoke
from dask_geomodeling_tpu import raster as jax_raster
from dask_geomodeling_tpu.io import geotiff as jax_geotiff
from dask_geomodeling_tpu.io import gpkg_raster as jax_gpkg
from dask_geomodeling_tpu.io import mbtiles as jax_mbtiles
from dask_geomodeling_tpu_torch import native
from dask_geomodeling_tpu_torch.io import geotiff as port_geotiff
from dask_geomodeling_tpu_torch.io import gpkg_raster as port_gpkg
from dask_geomodeling_tpu_torch.io import mbtiles as port_mbtiles
from dask_geomodeling_tpu_torch.runtime import pipeline
from tests.test_torch_file_sources import assert_agrees, both_configs
from tests.test_torch_raster_formats import assert_same
from tests.test_torch_tile_pyramids import _grid_aligned_gt
from tests.test_torch_webp import _chunks

SHAPES = [(1, 1), (1, 9), (9, 1), (2, 2), (5, 2), (2, 6), (16, 16), (17, 33), (300, 301), (512, 512)]
QUALITIES = (0, 5, 50, 75, 80, 100)
METHODS = (0, 4, 6)
KINDS = ("ortho", "smooth", "noise", "few")


def pixels_of(kind, shape, bands, seed):
    """Seeded (h, w, bands) uint8 content: chip_smoke's orthophoto (its
    alpha band a ramp), a random walk along the rows, noise, or few
    distinct values."""
    height, width = shape
    rng = np.random.default_rng(seed)
    if kind == "ortho":
        rgb = chip_smoke.ortho_pixels(max(width, 16), max(height, 16), seed=seed % 97)
        rgb = rgb[:height, :width]
        if bands == 3:
            return np.ascontiguousarray(rgb)
        ramp = (np.arange(width)[None, :] * 7 + np.arange(height)[:, None] * 3) % 256
        return np.ascontiguousarray(np.dstack([rgb, ramp.astype(np.uint8)]))
    full = (height, width, bands)
    if kind == "smooth":
        return np.clip(np.cumsum(rng.integers(-6, 7, full), axis=1) + 128, 0, 255).astype(np.uint8)
    if kind == "few":
        return (rng.integers(0, 3, full) * 100).astype(np.uint8)
    return rng.integers(0, 256, full).astype(np.uint8)


def pillow_lossy(pixels, **options):
    buf = io.BytesIO()
    mode = {3: "RGB", 4: "RGBA"}[pixels.shape[2]]
    Image.fromarray(pixels, mode).save(buf, format="WEBP", **options)
    return buf.getvalue()


def pillow_read(blob):
    with Image.open(io.BytesIO(blob)) as image:
        return np.asarray(image), image.mode


def assert_decodes_as_pillow(blob):
    theirs, mode = pillow_read(blob)
    ours = native.webp_decode_native(blob)
    assert ours.dtype == theirs.dtype and ours.shape == theirs.shape
    assert {3: "RGB", 4: "RGBA"}[ours.shape[2]] == mode
    assert np.array_equal(ours, theirs)
    return ours


# --- libwebp 1.6.0 through ctypes: the encoder Pillow's save drives, with
# every setting open, and WebPDecodeYUV ---


class WebPConfig(ctypes.Structure):
    """encode.h's WebPConfig (libwebp 1.6.0): 29 ints and floats."""
    _fields_ = [(name, ctypes.c_float if name in ("quality", "target_PSNR") else ctypes.c_int)
                for name in ("lossless", "quality", "method", "image_hint", "target_size",
                             "target_PSNR", "segments", "sns_strength", "filter_strength",
                             "filter_sharpness", "filter_type", "autofilter",
                             "alpha_compression", "alpha_filtering", "alpha_quality", "pass_",
                             "show_compressed", "preprocessing", "partitions",
                             "partition_limit", "emulate_jpeg_size", "thread_level",
                             "low_memory", "near_lossless", "exact", "use_delta_palette",
                             "use_sharp_yuv", "qmin", "qmax")]


class WebPPicture(ctypes.Structure):
    """encode.h's WebPPicture (libwebp 1.6.0), 256 bytes on a 64-bit host."""
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int),
                ("y", ctypes.c_void_p), ("u", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("y_stride", ctypes.c_int), ("uv_stride", ctypes.c_int),
                ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2),
                ("argb", ctypes.c_void_p), ("argb_stride", ctypes.c_int),
                ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


class WebPMemoryWriter(ctypes.Structure):
    _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


ENCODER_ABI = 0x020F  # WEBP_ENCODER_ABI_VERSION: only its major byte is checked


def _load_libwebp():
    """Pillow's bundled libwebp (libsharpyuv loaded first, globally), or
    None with the reason."""
    folder = os.path.normpath(os.path.join(os.path.dirname(PIL.__file__), os.pardir,
                                           "pillow.libs"))
    sharp = glob.glob(os.path.join(folder, "libsharpyuv-*.so*"))
    webp = glob.glob(os.path.join(folder, "libwebp-*.so*"))
    if not (sharp and webp):
        return None, "no libwebp-*.so or libsharpyuv-*.so in %s" % folder
    try:
        ctypes.CDLL(sharp[0], mode=ctypes.RTLD_GLOBAL)
        lib = ctypes.CDLL(webp[0])
    except OSError as error:
        return None, "%s does not load: %s" % (webp[0], error)
    if lib.WebPGetEncoderVersion() != 0x010600:
        return None, "%s is not libwebp 1.6.0" % webp[0]
    lib.WebPConfigInitInternal.argtypes = [ctypes.POINTER(WebPConfig), ctypes.c_int,
                                           ctypes.c_float, ctypes.c_int]
    lib.WebPPictureInitInternal.argtypes = [ctypes.POINTER(WebPPicture), ctypes.c_int]
    lib.WebPPictureImportRGBA.argtypes = [ctypes.POINTER(WebPPicture), ctypes.c_void_p,
                                          ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = lib.WebPPictureImportRGBA.argtypes
    lib.WebPEncode.argtypes = [ctypes.POINTER(WebPConfig), ctypes.POINTER(WebPPicture)]
    lib.WebPMemoryWriterInit.argtypes = [ctypes.POINTER(WebPMemoryWriter)]
    lib.WebPMemoryWriterClear.argtypes = [ctypes.POINTER(WebPMemoryWriter)]
    lib.WebPPictureFree.argtypes = [ctypes.POINTER(WebPPicture)]
    lib.WebPFree.argtypes = [ctypes.c_void_p]
    u8_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))
    int_p = ctypes.POINTER(ctypes.c_int)
    lib.WebPDecodeYUV.argtypes = [ctypes.c_void_p, ctypes.c_size_t, int_p, int_p, u8_pp, u8_pp,
                                  int_p, int_p]
    lib.WebPDecodeYUV.restype = ctypes.POINTER(ctypes.c_uint8)
    return lib, None


LIBWEBP, LIBWEBP_MISSING = _load_libwebp()
needs_libwebp = pytest.mark.skipif(LIBWEBP is None, reason="libwebp 1.6.0 through ctypes: %s"
                                   % LIBWEBP_MISSING)


def libwebp_config(quality=75.0, **fields):
    """WebPConfigInit at ``quality`` (its defaults: method 4, 4 segments,
    filter strength 60, the normal filter, sharpness 0, one partition, ALPH
    compressed and fast-filtered), then ``fields``."""
    config = WebPConfig()
    assert LIBWEBP.WebPConfigInitInternal(ctypes.byref(config), 0, quality, ENCODER_ABI)
    assert (config.method, config.segments, config.filter_type, config.alpha_quality,
            config.qmax) == (4, 4, 1, 100, 100)
    for name, value in fields.items():
        setattr(config, name, value)
    assert LIBWEBP.WebPValidateConfig(ctypes.byref(config))
    return config


def libwebp_encode(pixels, config):
    """The RIFF/WEBP file libwebp writes for (h, w, 3 or 4) ``pixels``."""
    picture = WebPPicture()
    assert LIBWEBP.WebPPictureInitInternal(ctypes.byref(picture), ENCODER_ABI)
    height, width, bands = pixels.shape
    picture.use_argb = 1
    picture.width, picture.height = width, height
    pixels = np.ascontiguousarray(pixels)
    load = LIBWEBP.WebPPictureImportRGBA if bands == 4 else LIBWEBP.WebPPictureImportRGB
    assert load(ctypes.byref(picture), pixels.ctypes.data, width * bands)
    writer = WebPMemoryWriter()
    LIBWEBP.WebPMemoryWriterInit(ctypes.byref(writer))
    picture.writer = ctypes.cast(LIBWEBP.WebPMemoryWrite, ctypes.c_void_p)
    picture.custom_ptr = ctypes.cast(ctypes.pointer(writer), ctypes.c_void_p)
    try:
        assert LIBWEBP.WebPEncode(ctypes.byref(config), ctypes.byref(picture)), picture.error_code
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        LIBWEBP.WebPPictureFree(ctypes.byref(picture))
        LIBWEBP.WebPMemoryWriterClear(ctypes.byref(writer))


def libwebp_yuv(blob):
    """WebPDecodeYUV: the Y, U and V planes before the upsampling."""
    width, height, stride, uv_stride = (ctypes.c_int() for _ in range(4))
    u, v = ctypes.POINTER(ctypes.c_uint8)(), ctypes.POINTER(ctypes.c_uint8)()
    y = LIBWEBP.WebPDecodeYUV(blob, len(blob), ctypes.byref(width), ctypes.byref(height),
                              ctypes.byref(u), ctypes.byref(v), ctypes.byref(stride),
                              ctypes.byref(uv_stride))
    assert y
    try:
        h, w = height.value, width.value
        uv_h, uv_w = (h + 1) // 2, (w + 1) // 2

        def plane(pointer, rows, cols, step):
            flat = np.ctypeslib.as_array(pointer, shape=(step * (rows - 1) + cols,))
            return np.lib.stride_tricks.as_strided(flat, (rows, cols), (step, 1)).copy()

        return (plane(y, h, w, stride.value), plane(u, uv_h, uv_w, uv_stride.value),
                plane(v, uv_h, uv_w, uv_stride.value))
    finally:
        LIBWEBP.WebPFree(y)


class BoolReader:
    """RFC 6386's boolean decoder (section 7), for the frame header."""

    def __init__(self, data):
        self.data, self.pos = bytes(data) + b"\0\0", 2
        self.value, self.range, self.count = (self.data[0] << 8) | self.data[1], 255, 0

    def bit(self, prob=128):
        split = 1 + (((self.range - 1) * prob) >> 8)
        if self.value >= split << 8:
            self.range -= split
            self.value -= split << 8
            bit = 1
        else:
            self.range = split
            bit = 0
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.count += 1
            if self.count == 8:
                self.count = 0
                self.value |= self.data[self.pos] if self.pos < len(self.data) else 0
                self.pos += 1
        return bit

    def bits(self, n):
        value = 0
        for _ in range(n):
            value = (value << 1) | self.bit()
        return value

    def signed(self, n):
        value = self.bits(n)
        return -value if self.bit() else value


def frame_header(blob):
    """The VP8 frame header of a lossy file, read up to the token
    partitions' count (RFC 6386 9.2-9.5), and its ALPH chunk's header byte
    (method and filter), or None."""
    chunks = dict(_chunks(blob))
    frame = chunks[b"VP8 "]
    tag = frame[0] | frame[1] << 8 | frame[2] << 16
    br = BoolReader(frame[10:10 + (tag >> 5)])
    br.bits(2)  # colour space, clamping
    header = {"segmentation": br.bit(), "update_map": 0}
    if header["segmentation"]:
        header["update_map"] = br.bit()
        if br.bit():
            br.bit()
            for _ in range(4):
                if br.bit():
                    br.signed(7)
            for _ in range(4):
                if br.bit():
                    br.signed(6)
        if header["update_map"]:
            for _ in range(3):
                if br.bit():
                    br.bits(8)
    header.update(simple=br.bit(), level=br.bits(6), sharpness=br.bits(3))
    if br.bit() and br.bit():  # loop-filter deltas, and their update
        for _ in range(8):
            if br.bit():
                br.signed(6)
    header["partitions"] = 1 << br.bits(2)
    alpha = chunks.get(b"ALPH")
    header["alpha"] = None if alpha is None else (alpha[0] & 3, (alpha[0] >> 2) & 3)
    return header


def alpha_plane(kind, shape, seed):
    """A (h, w) alpha plane whose ALPH libwebp's "best" filtering codes
    with one filter: rows (horizontal), columns (vertical), planes, the sum
    of a column and a row walk (gradient), or noise (none)."""
    height, width = shape
    rng = np.random.default_rng(seed)
    wobble = rng.integers(0, 3, shape)
    if kind == "rows":
        plane = np.repeat(np.cumsum(rng.integers(-4, 5, (height, 1)), 0) + 128, width, 1) + wobble
    elif kind == "columns":
        plane = np.repeat(np.cumsum(rng.integers(-4, 5, (1, width)), 1) + 128, height, 0) + wobble
    elif kind == "planes":
        plane = (np.cumsum(rng.integers(-3, 4, height))[:, None] + 100
                 + np.cumsum(rng.integers(-3, 4, width))[None, :] + 100 + wobble // 2)
    else:
        plane = rng.integers(0, 256, shape)
    return np.clip(plane, 0, 255).astype(np.uint8)


# --- Pillow's lossy files ---


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("kind", KINDS)
def test_pillow_lossy_rgb(kind, method):
    for shape in SHAPES:
        pixels = pixels_of(kind, shape, 3, shape[0] * 7 + shape[1])
        for quality in QUALITIES:
            assert_decodes_as_pillow(pillow_lossy(pixels, quality=quality, method=method))


@pytest.mark.parametrize("opaque", [False, True])
@pytest.mark.parametrize("alpha_quality", [0, 50, 100])
def test_pillow_lossy_rgba(alpha_quality, opaque):
    """RGBA: an ALPH chunk at each alpha quality where some alpha is below
    255; all-opaque alpha writes none (the file reads as RGB)."""
    for shape in SHAPES:
        for method in METHODS:
            pixels = pixels_of("ortho", shape, 4, shape[1] + method)
            if opaque:
                pixels[..., 3] = 255
            blob = pillow_lossy(pixels, quality=80, method=method, alpha_quality=alpha_quality)
            assert (b"ALPH" in blob) == (not opaque)
            assert assert_decodes_as_pillow(blob).shape[2] == (3 if opaque else 4)


def test_planes_of_pillows_files_are_libwebps():
    """Reconstruction and loop filter apart from the upsampling: the Y, U
    and V planes are WebPDecodeYUV's."""
    if LIBWEBP is None:
        pytest.skip("libwebp 1.6.0 through ctypes: %s" % LIBWEBP_MISSING)
    for shape in [(1, 1), (17, 33), (300, 301)]:
        for quality in (0, 75, 100):
            blob = pillow_lossy(pixels_of("ortho", shape, 3, 5), quality=quality)
            for ours, theirs in zip(native.webp_decode_planes(blob), libwebp_yuv(blob)):
                assert np.array_equal(ours, theirs)


# --- libwebp's settings, through ctypes ---


def assert_libwebp_file(pixels, config, **header):
    """Encode with libwebp, check that the frame header holds ``header``,
    and that the port decodes Pillow's array and libwebp's planes."""
    blob = libwebp_encode(pixels, config)
    written = frame_header(blob)
    for key, value in header.items():
        assert written[key] == value, (key, written)
    assert_decodes_as_pillow(blob)
    for ours, theirs in zip(native.webp_decode_planes(blob), libwebp_yuv(blob)):
        assert np.array_equal(ours, theirs)
    return written


@needs_libwebp
@pytest.mark.parametrize("low_memory", [0, 1])
@pytest.mark.parametrize("partitions", range(4))
def test_token_partitions(partitions, low_memory):
    """1, 2, 4 or 8 token partitions (libwebp keeps one where it buffers
    its tokens: methods 3-6 without low_memory), frames of 1 to 40
    macroblock rows."""
    method = 4 if low_memory else 2
    for shape in [(16, 16), (100, 37), (640, 90)]:
        pixels = pixels_of("ortho", shape, 3, partitions)
        config = libwebp_config(70.0, partitions=partitions, method=method, low_memory=low_memory)
        assert_libwebp_file(pixels, config, partitions=1 << partitions)


@needs_libwebp
@pytest.mark.parametrize("strength", [0, 100])
@pytest.mark.parametrize("filter_type", [0, 1])
def test_loop_filters(filter_type, strength):
    """The simple (filter_type 0) and the normal loop filter, and none
    (strength 0: level 0), at several qualities and segment counts."""
    for quality in (10, 50, 90):
        for segments in (1, 4):
            pixels = pixels_of("smooth", (70, 90), 3, quality + segments)
            config = libwebp_config(float(quality), filter_type=filter_type,
                                    filter_strength=strength, segments=segments, autofilter=0)
            written = assert_libwebp_file(pixels, config, simple=int(filter_type == 0))
            assert (written["level"] > 0) == (strength > 0)


@needs_libwebp
@pytest.mark.parametrize("sharpness", range(8))
def test_sharpness(sharpness):
    for filter_type in (0, 1):
        pixels = pixels_of("ortho", (48, 80), 3, sharpness)
        config = libwebp_config(40.0, filter_type=filter_type, filter_strength=100,
                                filter_sharpness=sharpness)
        assert_libwebp_file(pixels, config, sharpness=sharpness)


@needs_libwebp
@pytest.mark.parametrize("segments", [1, 2, 3, 4])
def test_segments(segments):
    """1-4 segments (libwebp merges the ones it leaves unused, so a plain
    image may come out with none)."""
    written = []
    for kind in KINDS:
        pixels = pixels_of(kind, (96, 128), 3, segments)
        config = libwebp_config(60.0, segments=segments, sns_strength=100)
        written.append(assert_libwebp_file(pixels, config)["segmentation"])
    assert any(written) == (segments > 1)


# (compression, filtering, the alpha's content) -> the ALPH header's (method,
# filter): libwebp filters no raw plane, and keeps noise raw, the smaller
ALPHA_CASES = {
    (0, 0, "noise"): (0, 0), (0, 2, "planes"): (0, 0), (1, 0, "planes"): (1, 0),
    (1, 1, "rows"): (1, 0), (1, 2, "rows"): (1, 1), (1, 2, "columns"): (1, 2),
    (1, 2, "planes"): (1, 3), (1, 1, "noise"): (0, 0),
}


@needs_libwebp
@pytest.mark.parametrize("case", list(ALPHA_CASES), ids=lambda case: "-".join(map(str, case)))
def test_alph_chunks(case):
    """ALPH raw and coded as VP8L (its green channel), unfiltered and
    filtered horizontally, vertically and by gradient, at alpha qualities
    100 and 50 (quantized levels)."""
    compression, filtering, kind = case
    for alpha_quality in (100, 50):
        pixels = pixels_of("ortho", (48, 64), 4, 3)
        pixels[..., 3] = alpha_plane(kind, (48, 64), 7)
        config = libwebp_config(50.0, alpha_compression=compression, alpha_filtering=filtering,
                                alpha_quality=alpha_quality)
        written = assert_libwebp_file(pixels, config)
        if alpha_quality == 100:
            assert written["alpha"] == ALPHA_CASES[case]


def _refilter(plane, method):
    """dsp/filters.c's forward filters: horizontal, vertical and gradient
    residuals of ``plane``, the first row and column by the format's
    rules."""
    plane = plane.astype(np.int64)
    out = np.empty_like(plane)
    for y in range(plane.shape[0]):
        for x in range(plane.shape[1]):
            if y == 0:
                pred = plane[0, x - 1] if x else 0
            elif x == 0:
                pred = plane[y - 1, 0]
            elif method == 1:
                pred = plane[y, x - 1]
            elif method == 2:
                pred = plane[y - 1, x]
            else:
                pred = min(max(plane[y, x - 1] + plane[y - 1, x] - plane[y - 1, x - 1], 0), 255)
            out[y, x] = (plane[y, x] - pred) % 256
    return out.astype(np.uint8)


@needs_libwebp
@pytest.mark.parametrize("method", [1, 2, 3])
def test_raw_alph_filtered_by_hand(method):
    """A raw ALPH plane filtered here (libwebp writes raw planes
    unfiltered): Pillow and the port unfilter it alike."""
    from tests.test_torch_webp import _riff

    pixels = pixels_of("ortho", (21, 34), 4, method)
    pixels[..., 3] = alpha_plane("planes", (21, 34), method)
    blob = libwebp_encode(pixels, libwebp_config(50.0, alpha_compression=0))
    chunks = _chunks(blob)
    tags = [tag for tag, _ in chunks]
    k = tags.index(b"ALPH")
    plane = np.frombuffer(chunks[k][1][1:], np.uint8).reshape(21, 34)
    chunks[k] = (b"ALPH", bytes([method << 2]) + _refilter(plane, method).tobytes())
    refiltered = _riff(chunks)
    assert np.array_equal(pillow_read(refiltered)[0], pillow_read(blob)[0])
    assert_decodes_as_pillow(refiltered)


# --- the JAX functions and the port's, on the same blobs ---


def _blobs():
    for shape in [(1, 1), (9, 17), (64, 64)]:
        for bands in (3, 4):
            pixels = pixels_of("ortho", shape, bands, shape[0])
            yield pillow_lossy(pixels, quality=75)
            if bands == 4:
                pixels[..., 3] = 255
                yield pillow_lossy(pixels, quality=30, method=0)


@pytest.mark.parametrize("samples", [None, 1, 3, 4])
def test_chunk_decoders_agree(samples):
    """io/geotiff.py's _decode_image_chunk (Pillow) and the port's
    _decode_webp_chunk give the same bytes for every sample count a
    GeoTIFF asks."""
    for blob in _blobs():
        theirs = jax_geotiff._decode_image_chunk(blob, None, samples)
        assert port_geotiff._decode_webp_chunk(blob, samples) == bytes(theirs)


def test_tile_decoders_agree():
    """io/gpkg_raster.py's _decode_tile (Pillow's conversion: RGBA to RGB)
    and the port's, on RGB and RGBA lossy tiles."""
    for blob in _blobs():
        theirs = jax_gpkg._decode_tile(blob)
        ours = port_gpkg._decode_tile(blob)
        assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)


def gdal_lossy_geotiff(path, pixels, tile=512, quality=75):
    """``pixels`` (h, w, 3 or 4) as GDAL writes COMPRESS=WEBP at its lossy
    default: tile^2 contiguous tiles, each one Pillow lossy WebP (quality
    75, method 4), the edge tiles padded by repetition."""
    height, width, bands = pixels.shape
    chunks = []
    for row in range(0, height, tile):
        for col in range(0, width, tile):
            piece = pixels[row:row + tile, col:col + tile]
            piece = np.pad(piece, ((0, tile - piece.shape[0]), (0, tile - piece.shape[1]), (0, 0)),
                           mode="edge")
            chunks.append(pillow_lossy(np.ascontiguousarray(piece), quality=quality, method=4))
    chip_smoke.write_webp_chunks_layout(path, chunks, (height, width), bands,
                                        chip_smoke.ortho_geo_transform(), tile=tile)
    return chunks


@pytest.mark.parametrize("bands", [3, 4])
def test_gdal_lossy_geotiffs_read_alike(tmp_path, bands):
    """A GDAL-layout lossy WebP GeoTIFF, RGB or RGBA (ALPH): the same
    payload from both packages, whole and by window; through
    RasterFileSource, compute_host bitwise to the JAX numpy executor, the
    whole file and a sub-area with the windowed-read limit lowered."""
    height, width = 700, 1100
    pixels = pixels_of("ortho", (height, width), 4, 11)
    if bands == 3:
        pixels = np.ascontiguousarray(pixels[..., :3])
    else:
        pixels[..., 3] = np.where(alpha_plane("noise", (height, width), 1) < 40, 0, 255)
    path = str(tmp_path / "lossy.tif")
    chunks = gdal_lossy_geotiff(path, pixels)
    assert all(_chunks(c)[-1][0] == b"VP8 " for c in chunks)
    assert all((b"ALPH" in c) == (bands == 4) for c in chunks)
    ours, theirs = port_geotiff.read_geotiff(path), jax_geotiff.read_geotiff(path)
    assert_same(ours, theirs)
    assert ours.array.shape == (bands, height, width)
    for window in [(0, 512, 0, 512), (100, 613, 250, 1031), (699, 700, 1099, 1100)]:
        assert_same(port_geotiff.read_geotiff_window(path, *window),
                    jax_geotiff.read_geotiff_window(path, *window))
    source = jax_raster.RasterFileSource(path, time_first=chip_smoke.ORTHO_TIME,
                                         time_delta=chip_smoke.ORTHO_BAND_STEP)
    x0, y0 = chip_smoke.ORTHO_ORIGIN
    cell = chip_smoke.ORTHO_CELL
    last = chip_smoke.ORTHO_TIME + (bands - 1) * chip_smoke.ORTHO_BAND_STEP
    whole = dict(mode="vals", projection="EPSG:28992", width=width, height=height,
                 bbox=(x0, y0 - height * cell, x0 + width * cell, y0),
                 start=chip_smoke.ORTHO_TIME, stop=last)
    sub = dict(whole, width=300, height=200,
               bbox=(x0 + 400 * cell, y0 - 600 * cell, x0 + 700 * cell, y0 - 400 * cell))
    for limit in (None, 100_000):
        with both_configs({"geomodeling.windowed-read-limit": limit}):
            pipeline.clear_read_cache()
            assert_agrees(source, whole)
            assert_agrees(source, sub)


@pytest.mark.parametrize("container", ["gpkg", "mbtiles"])
def test_lossy_pyramids_read_alike(tmp_path, container):
    """A GeoPackage and an MBTiles file whose tiles are Pillow's lossy
    WebP, one of them RGBA: both packages read the same payload."""
    if container == "gpkg":
        path = str(tmp_path / "lossy.gpkg")
        values = pixels_of("ortho", (512, 512), 3, 2).transpose(2, 0, 1)
        jax_gpkg.write_gpkg_raster(path, np.ascontiguousarray(values),
                                   (0.0, 1.0, 0.0, 512.0, 0.0, -1.0), projection="EPSG:28992")
        con = sqlite3.connect(path)
        table = con.execute("SELECT table_name FROM gpkg_contents").fetchone()[0]
    else:
        path = str(tmp_path / "lossy.mbtiles")
        values = pixels_of("ortho", (512, 512), 3, 4).transpose(2, 0, 1)
        jax_mbtiles.write_mbtiles(path, np.ascontiguousarray(values),
                                  _grid_aligned_gt(col=7, row_xyz=7))
        table = "tiles"
        con = sqlite3.connect(path)
        con.execute("UPDATE metadata SET value='webp' WHERE name='format'")
    rows = con.execute("SELECT rowid FROM %s ORDER BY rowid" % table).fetchall()
    assert len(rows) >= 2
    for k, (rowid,) in enumerate(rows):
        pixels = pixels_of("ortho", (256, 256), 4 if k == 1 else 3, k)
        blob = pillow_lossy(pixels, quality=40 + 10 * k, method=k % 7)
        con.execute("UPDATE %s SET tile_data = ? WHERE rowid = ?" % table, (blob, rowid))
    con.commit()
    con.close()
    pipeline.clear_read_cache()
    if container == "gpkg":
        assert_same(port_gpkg.read_gpkg_raster(path), jax_gpkg.read_gpkg_raster(path))
    else:
        assert_same(port_mbtiles.read_mbtiles(path), jax_mbtiles.read_mbtiles(path))


# --- chip_smoke's lossy chunks ---


def test_ortho_lossy_chunks_are_pillows():
    """tests/data/torch_webp/ortho-lossy: each chunk is what Pillow writes
    for chip_smoke.ortho_lossy_pixels at quality 75 and method 4 (GDAL's
    defaults), about 40 KB each; hashes.json holds Pillow's arrays of them
    and of the two small lossy fixtures, re-derived here; the port's
    native decode gives the same hashes."""
    folder, recorded = chip_smoke.webp_fixture_hashes()
    names = sorted(chip_smoke.webp_lossy_fixture_names())
    assert sorted(recorded["lossy"]) == names
    for name in names:
        with open(os.path.join(folder, name), "rb") as f:
            blob = f.read()
        if name.startswith(chip_smoke.ORTHO_LOSSY_DIR + "/"):
            pixels = chip_smoke.ortho_lossy_pixels(os.path.basename(name))
            assert blob == pillow_lossy(pixels, quality=chip_smoke.ORTHO_LOSSY_QUALITY, method=4)
            assert 20_000 < len(blob) < 80_000
        array = pillow_read(blob)[0]
        assert recorded["lossy"][name] == {"shape": list(array.shape),
                                           "sha256": chip_smoke.array_sha256(array)}
        assert chip_smoke.array_sha256(native.webp_decode_native(blob)) == \
            recorded["lossy"][name]["sha256"]
    assert sorted(os.listdir(os.path.join(folder, chip_smoke.ORTHO_LOSSY_DIR))) == sorted(
        chip_smoke.ORTHO_LOSSY_CHUNKS)
    alpha = native.webp_decode_native(open(os.path.join(
        folder, chip_smoke.ORTHO_LOSSY_DIR, chip_smoke.ORTHO_LOSSY_ALPHA), "rb").read())
    assert alpha.shape[2] == 4 and 0.01 < (alpha[..., 3] == 0).mean() < 0.5


def write_ortho_lossy(folder):
    """Rewrite tests/data/torch_webp/ortho-lossy from Pillow and their
    entries of hashes.json (with the two small lossy fixtures')."""
    from tests.test_torch_webp import fixture_bytes

    os.makedirs(os.path.join(folder, chip_smoke.ORTHO_LOSSY_DIR), exist_ok=True)
    with open(os.path.join(folder, "hashes.json")) as f:
        recorded = json.load(f)
    recorded["lossy"] = {}
    for name in chip_smoke.webp_lossy_fixture_names():
        if name.startswith(chip_smoke.ORTHO_LOSSY_DIR + "/"):
            blob = pillow_lossy(chip_smoke.ortho_lossy_pixels(os.path.basename(name)),
                                quality=chip_smoke.ORTHO_LOSSY_QUALITY, method=4)
            with open(os.path.join(folder, name), "wb") as f:
                f.write(blob)
        else:
            blob = fixture_bytes(name)
        array = pillow_read(blob)[0]
        recorded["lossy"][name] = {"shape": list(array.shape),
                                   "sha256": chip_smoke.array_sha256(array)}
    with open(os.path.join(folder, "hashes.json"), "w") as f:
        json.dump(recorded, f, indent=1, sort_keys=True)
        f.write("\n")
