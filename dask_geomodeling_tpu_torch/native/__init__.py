"""Native (C++) host components: the TIFF decoders, the JPEG and WebP codecs
and the scanline rasterizer.

Counterpart of dask_geomodeling_tpu/native/__init__.py, at its names but
for the packed fetch (``fetchdecode.cpp``), which the port does not use;
the JPEG codec (``jpegcodec.cpp``: ``jpeg_decode_native`` and
``jpeg_encode_native``) is the port's own, where the JAX package calls
Pillow (its io/jpeg.py, the JPEG chunks of io/geotiff.py, the tiles of
io/gpkg_raster.py, NITF's C3 and M3 segments and the WMS JPEG GetMap), and
so is the WebP codec (``webpcodec.cpp``: ``webp_decode_native`` for lossy
and lossless files, ``webp_encode_native`` lossless), where the JAX package
calls Pillow for WebP GeoTIFF chunks (compression 50001), WebP tiles and
the WMS WebP GetMap.  ``tiffcodec.cpp``,
``jpegcodec.cpp``, ``webpcodec.cpp`` and ``rasterize.cpp`` build at first
use with g++
(``ops/_build.py``: ``-O3 -shared -fPIC -std=c++17``, a hash-named library
in ``_build/``) and load with ctypes, which releases the GIL around each
call, so the codec's thread pool decodes a window's chunks in parallel.

Unlike the JAX package, whose loaders log a warning and return None when
g++ fails (its callers then drop to Python), a failure to build or load
raises here, naming the compiler and the source: no caller falls back to
the pure-Python decoders (io/geotiff.py) or the numpy polygon scanline
(geo/rasterize.py), which stay as the plain versions the tests hold these
to; the JPEG and WebP codecs have no Python version at all (the tests hold
them to Pillow).  ``counts`` tallies the native calls (chip_smoke.py reads it).
"""
import ctypes
import os
import threading

import numpy as np

from dask_geomodeling_tpu_torch.ops import _build

__all__ = [
    "load_tiffcodec",
    "tiff_decode_native",
    "load_jpegcodec",
    "jpeg_decode_native",
    "jpeg_encode_native",
    "load_webpcodec",
    "webp_decode_native",
    "webp_encode_native",
    "load_rasterizer",
    "rasterize_native",
    "counts",
    "reset_counts",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "rasterize.cpp")
_TIFF_SOURCE = os.path.join(_HERE, "tiffcodec.cpp")
_JPEG_SOURCE = os.path.join(_HERE, "jpegcodec.cpp")
_WEBP_SOURCE = os.path.join(_HERE, "webpcodec.cpp")

_lock = threading.Lock()
_lib = None
_tiff_lib = None
_jpeg_lib = None
_webp_lib = None

#: native calls since the last reset_counts(): TIFF chunk decodes and
#: their decoded bytes, JPEG decodes and their decoded bytes, JPEG encodes
#: and their bytes, the same four of WebP, and rasterize_native's burns (one
#: a call)
counts = {"tiff_decodes": 0, "tiff_bytes": 0, "jpeg_decodes": 0, "jpeg_bytes": 0,
          "jpeg_encodes": 0, "jpeg_encoded_bytes": 0, "webp_decodes": 0, "webp_bytes": 0,
          "webp_encodes": 0, "webp_encoded_bytes": 0, "burns": 0}


def reset_counts():
    with _lock:
        for key in counts:
            counts[key] = 0


def load_rasterizer():
    """Load (building if necessary) the native rasterizer; raises when it
    cannot be built or loaded."""
    global _lib
    lib = _build.load_host_library(_SOURCE)
    with _lock:
        if _lib is lib:
            return _lib
        c_double_p = ctypes.POINTER(ctypes.c_double)
        c_int64_p = ctypes.POINTER(ctypes.c_int64)
        for name, value_type in (
            ("rasterize_int32", ctypes.POINTER(ctypes.c_int32)),
            ("rasterize_float64", c_double_p),
            ("rasterize_uint8", ctypes.POINTER(ctypes.c_uint8)),
        ):
            func = getattr(lib, name)
            func.restype = None
            func.argtypes = [
                c_double_p,
                c_int64_p,
                c_int64_p,
                ctypes.c_int64,
                value_type,
                value_type,
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.c_double,
                ctypes.c_double,
            ]
        _lib = lib
        return _lib


def load_tiffcodec():
    """Load (building if necessary) the native TIFF decoders; raises when
    they cannot be built or loaded."""
    global _tiff_lib
    lib = _build.load_host_library(_TIFF_SOURCE)
    with _lock:
        if _tiff_lib is lib:
            return _tiff_lib
        u8_p = ctypes.POINTER(ctypes.c_uint8)
        for name in ("lzw_decode", "packbits_decode"):
            func = getattr(lib, name)
            func.restype = ctypes.c_int64
            func.argtypes = [u8_p, ctypes.c_int64, u8_p, ctypes.c_int64]
        _tiff_lib = lib
        return _tiff_lib


def tiff_decode_native(kind, data, expected_size):
    """Decode an LZW/PackBits TIFF chunk natively.

    Returns the decoded bytes, or raises on corrupt input (and when the
    library cannot be built or loaded).
    """
    lib = load_tiffcodec()
    func = lib.lzw_decode if kind == "lzw" else lib.packbits_decode
    src = np.frombuffer(data, dtype=np.uint8)
    # chunks may decode to slightly more than the nominal tile/strip
    # payload (trailing pad rows); give some slack then retry-grow
    capacity = int(expected_size) + 4096
    for _ in range(3):
        out = np.empty(capacity, dtype=np.uint8)
        n = func(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            src.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            capacity,
        )
        if n == -1:
            raise ValueError("Corrupt %s stream" % kind)
        if n == -2:
            capacity *= 4
            continue
        with _lock:
            counts["tiff_decodes"] += 1
            counts["tiff_bytes"] += int(n)
        return out[: int(n)].tobytes()
    raise ValueError("%s output exceeded expected size" % kind)


def load_jpegcodec():
    """Load (building if necessary) the native JPEG codec; raises when it
    cannot be built or loaded."""
    global _jpeg_lib
    lib = _build.load_host_library(_JPEG_SOURCE)
    with _lock:
        if _jpeg_lib is lib:
            return _jpeg_lib
        u8_p = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_decode.restype = ctypes.c_int
        lib.jpeg_decode.argtypes = [u8_p, ctypes.c_int64, u8_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                    ctypes.c_int64]
        lib.jpeg_encode.restype = ctypes.c_int64
        lib.jpeg_encode.argtypes = [u8_p] + [ctypes.c_int32] * 6 + [u8_p, ctypes.c_int64]
        _jpeg_lib = lib
        return _jpeg_lib


#: jpegcodec.cpp's return codes
_JPEG_CORRUPT, _JPEG_UNSUPPORTED, _JPEG_NEED_SPACE = -1, -2, -3


def jpeg_decode_native(data):
    """Decode a JPEG stream as Pillow's ``np.asarray(Image.open(...))``
    gives it: (h, w) uint8 for one component, (h, w, 3) RGB for three,
    (h, w, 4) CMYK for four (inverted, Pillow's "CMYK;I" raw mode).

    Raises OSError where Pillow raises (a truncated or broken stream),
    NotImplementedError for what the codec does not decode (arithmetic
    coding, lossless, 12-bit samples, block smoothing), naming the JAX
    module that reads them, and RuntimeError when the library cannot be
    built or loaded.
    """
    lib = load_jpegcodec()
    src = np.frombuffer(data, dtype=np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    info = (ctypes.c_int32 * 3)()
    message = ctypes.create_string_buffer(256)
    # the first call reads the header (width, height, channels), the
    # second decodes into the array it sizes
    rc = lib.jpeg_decode(src.ctypes.data_as(u8_p), src.size, None, 0, info, message,
                         len(message))
    if rc == _JPEG_NEED_SPACE:
        out = np.empty(int(info[0]) * int(info[1]) * int(info[2]), np.uint8)
        rc = lib.jpeg_decode(src.ctypes.data_as(u8_p), src.size, out.ctypes.data_as(u8_p),
                             out.size, info, message, len(message))
    text = message.value.decode("ascii", "replace")
    if rc == _JPEG_UNSUPPORTED:
        raise NotImplementedError(text)
    if rc != 0:
        raise OSError("broken JPEG data: %s" % text)
    width, height, channels = (int(v) for v in info)
    with _lock:
        counts["jpeg_decodes"] += 1
        counts["jpeg_bytes"] += out.size
    return out.reshape(height, width) if channels == 1 else out.reshape(height, width, channels)


#: what Pillow's default save writes: quality 75, and for RGB the luma
#: sampled 2 x 2 (4:2:0); a grayscale image writes 1 x 1
_QUALITY, _RGB_SAMPLING = 75, (2, 2)


def jpeg_encode_native(pixels):
    """The JPEG bytes of a (h, w) grayscale or (h, w, 3) RGB uint8 array,
    the bytes Pillow writes for ``Image.fromarray(pixels).save(buf,
    format="jpeg")``: baseline, JFIF, quality 75, the standard Huffman
    tables, RGB as 4:2:0 YCbCr."""
    pixels = np.ascontiguousarray(pixels)
    sampling = (1, 1) if pixels.ndim == 2 else _RGB_SAMPLING
    return _jpeg_encode(pixels, _QUALITY, *sampling)


def _jpeg_encode(pixels, quality, h_samp, v_samp):
    """jpegcodec.cpp's encoder at ``quality`` with the luma sampled
    ``h_samp`` x ``v_samp`` (the tests hold other qualities and samplings
    to Pillow's)."""
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[2] != 3):
        raise ValueError("cannot write %s %s as JPEG" % (pixels.dtype, pixels.shape))
    height, width = pixels.shape[:2]
    if not (1 <= width <= 65535 and 1 <= height <= 65535):
        raise ValueError("JPEG dimensions %d x %d out of range" % (width, height))
    channels = 1 if pixels.ndim == 2 else 3
    lib = load_jpegcodec()
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    capacity = 2 * pixels.size + 4096
    while True:
        out = np.empty(capacity, np.uint8)
        n = lib.jpeg_encode(pixels.ctypes.data_as(u8_p), width, height, channels, quality,
                            h_samp, v_samp, out.ctypes.data_as(u8_p), capacity)
        if n == -1:
            capacity *= 2
            continue
        if n < 0:
            raise ValueError("the JPEG encoder refused %d x %d x %d" % (width, height, channels))
        break
    with _lock:
        counts["jpeg_encodes"] += 1
        counts["jpeg_encoded_bytes"] += int(n)
    return out[:n].tobytes()


def load_webpcodec():
    """Load (building if necessary) the native WebP codec; raises when it
    cannot be built or loaded."""
    global _webp_lib
    lib = _build.load_host_library(_WEBP_SOURCE)
    with _lock:
        if _webp_lib is lib:
            return _webp_lib
        u8_p = ctypes.POINTER(ctypes.c_uint8)
        lib.webp_decode.restype = ctypes.c_int
        lib.webp_decode.argtypes = [u8_p, ctypes.c_int64, u8_p, ctypes.c_int64,
                                    ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                    ctypes.c_int64]
        lib.webp_decode_planes.restype = ctypes.c_int
        lib.webp_decode_planes.argtypes = [u8_p, ctypes.c_int64, u8_p, u8_p, u8_p,
                                           ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p,
                                           ctypes.c_int64]
        lib.webp_encode.restype = ctypes.c_int64
        lib.webp_encode.argtypes = [u8_p] + [ctypes.c_int32] * 3 + [u8_p, ctypes.c_int64]
        _webp_lib = lib
        return _webp_lib


#: webpcodec.cpp's return codes
_WEBP_CORRUPT, _WEBP_UNSUPPORTED, _WEBP_NEED_SPACE = -1, -2, -3

#: the JAX modules that decode what the codec refuses (an animation), with
#: Pillow
_WEBP_READERS = ("dask_geomodeling_tpu/io/geotiff.py (compression 50001) and "
                 "dask_geomodeling_tpu/io/gpkg_raster.py (tiles) decode it with Pillow")


def webp_decode_native(data, bands=None):
    """Decode a still WebP file, lossless (VP8L) or lossy (a VP8 key frame,
    with or without an ALPH chunk), as Pillow's
    ``np.asarray(Image.open(...))`` gives it (libwebp 1.6.0: for a lossy
    frame its loop filter, fancy upsampling and YUV to RGB): (h, w, 3) RGB,
    or (h, w, 4) RGBA where the container's alpha flag (a simple file's
    VP8L alpha hint, or the VP8X flag) is set; with ``bands`` below that,
    only the first ``bands`` channels, (h, w, bands), written by the codec
    itself.

    Raises OSError where Pillow raises (a truncated or broken file, or one
    it cannot identify), NotImplementedError for what the codec does not
    decode (an animation), naming the JAX modules that read it, and
    RuntimeError when the library cannot be built or loaded.
    """
    lib = load_webpcodec()
    src = np.frombuffer(data, dtype=np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    info = (ctypes.c_int32 * 4)(0, 0, 0, int(bands or 0))
    message = ctypes.create_string_buffer(256)
    # the first call reads the container and the header (width, height,
    # channels), the second decodes into the array it sizes
    rc = lib.webp_decode(src.ctypes.data_as(u8_p), src.size, None, 0, info, message,
                         len(message))
    if rc == _WEBP_NEED_SPACE:
        channels = min(int(info[2]), int(bands or info[2]))
        out = np.empty(int(info[0]) * int(info[1]) * channels, np.uint8)
        rc = lib.webp_decode(src.ctypes.data_as(u8_p), src.size, out.ctypes.data_as(u8_p),
                             out.size, info, message, len(message))
    text = message.value.decode("ascii", "replace")
    if rc == _WEBP_UNSUPPORTED:
        raise NotImplementedError("%s: the port decodes still WebP images only; %s"
                                  % (text, _WEBP_READERS))
    if rc != 0:
        raise OSError(text)
    width, height = int(info[0]), int(info[1])
    with _lock:
        counts["webp_decodes"] += 1
        counts["webp_bytes"] += out.size
    return out.reshape(height, width, channels)


def webp_decode_planes(data):
    """The Y (h, w), U and V ((h + 1) // 2, (w + 1) // 2) planes of a lossy
    WebP file, reconstructed and loop-filtered, before the upsampling and
    the conversion to RGB: libwebp's WebPDecodeYUV, for the tests to tell
    a fault of the one from a fault of the other.  Raises as
    webp_decode_native does (NotImplementedError for a lossless file)."""
    lib = load_webpcodec()
    src = np.frombuffer(data, dtype=np.uint8)
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    info = (ctypes.c_int32 * 2)()
    message = ctypes.create_string_buffer(256)
    rc = lib.webp_decode_planes(src.ctypes.data_as(u8_p), src.size, None, None, None, info,
                                message, len(message))
    if rc == _WEBP_NEED_SPACE:
        width, height = int(info[0]), int(info[1])
        y = np.empty((height, width), np.uint8)
        u = np.empty(((height + 1) // 2, (width + 1) // 2), np.uint8)
        v = np.empty_like(u)
        rc = lib.webp_decode_planes(src.ctypes.data_as(u8_p), src.size, y.ctypes.data_as(u8_p),
                                    u.ctypes.data_as(u8_p), v.ctypes.data_as(u8_p), info,
                                    message, len(message))
    text = message.value.decode("ascii", "replace")
    if rc == _WEBP_UNSUPPORTED:
        raise NotImplementedError(text)
    if rc != 0:
        raise OSError(text)
    return y, u, v


def webp_encode_native(pixels):
    """Lossless WebP bytes of a (h, w) gray, (h, w, 3) RGB or (h, w, 4)
    RGBA uint8 array: one VP8L chunk in a RIFF container (a gray image as
    ARGB with R = G = B, so Pillow reads it as RGB; the alpha hint only
    where some alpha is not 255).  Lossless, but not the bytes Pillow's
    libwebp writes."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.dtype != np.uint8 or pixels.ndim not in (2, 3) or (
            pixels.ndim == 3 and pixels.shape[2] not in (3, 4)):
        raise ValueError("cannot write %s %s as WebP" % (pixels.dtype, pixels.shape))
    height, width = pixels.shape[:2]
    if not (1 <= width <= 16384 and 1 <= height <= 16384):
        raise ValueError("WebP dimensions %d x %d out of range" % (width, height))
    channels = 1 if pixels.ndim == 2 else pixels.shape[2]
    lib = load_webpcodec()
    u8_p = ctypes.POINTER(ctypes.c_uint8)
    capacity = 2 * pixels.size + 4096
    while True:
        out = np.empty(capacity, np.uint8)
        n = lib.webp_encode(pixels.ctypes.data_as(u8_p), width, height, channels,
                            out.ctypes.data_as(u8_p), capacity)
        if n == -1:
            capacity *= 2
            continue
        if n < 0:
            raise ValueError("the WebP encoder refused %d x %d x %d" % (width, height, channels))
        break
    with _lock:
        counts["webp_encodes"] += 1
        counts["webp_encoded_bytes"] += int(n)
    return out[:n].tobytes()


_FUNC_BY_DTYPE = {
    "int32": "rasterize_int32",
    "float64": "rasterize_float64",
    "uint8": "rasterize_uint8",
}


def rasterize_native(polygon_coords, ring_sizes, ring_counts, values, out, gt):
    """Burn features into ``out`` (2D) using the native scanline rasterizer.

    Args mirror the flat layout documented in rasterize.cpp.  Returns False
    when ``out``'s dtype has no native function (the caller burns with the
    numpy scanline, as the JAX package's does); raises when the library
    cannot be built or loaded.
    """
    func_name = _FUNC_BY_DTYPE.get(str(out.dtype))
    if func_name is None:
        return False
    lib = load_rasterizer()

    coords = np.ascontiguousarray(polygon_coords, dtype=np.float64)
    sizes = np.ascontiguousarray(ring_sizes, dtype=np.int64)
    ring_counts = np.ascontiguousarray(ring_counts, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=out.dtype)
    # the library reads these lengths off one another: hold them here
    if not (out.ndim == 2 and out.flags["C_CONTIGUOUS"] and out.flags["WRITEABLE"]):
        raise ValueError("out must be a writeable C-contiguous 2D array")
    if (len(values) != len(ring_counts) or int(ring_counts.sum()) != len(sizes)
            or 2 * int(sizes.sum()) != coords.size):
        raise ValueError("the flat polygon layout does not add up")

    p, a, _, q, _, d = gt
    func = getattr(lib, func_name)
    func(
        coords.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ring_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(ring_counts),
        values.ctypes.data_as(func.argtypes[4]),
        out.ctypes.data_as(func.argtypes[5]),
        out.shape[0],
        out.shape[1],
        float(p),
        float(a),
        float(q),
        float(d),
    )
    with _lock:
        counts["burns"] += 1
    return True
