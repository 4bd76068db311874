"""CCSDS 121.0-B (extended-Rice / "szip" / AEC) entropy coding bindings.

Counterpart of dask_geomodeling_tpu/io/ccsds.py, copied: the same
functions, the same system libraries loaded the same way, and the same
named errors when a library is absent.

Two consumers need this coder:

- HDF4 szip-compressed elements (io/hdf4.py, compression coder 5) —
  the classic MODIS-era layout; decoded through the system ``libsz``
  (``SZ_BufftoBuffDecompress``), exactly the library HDF4 itself links.
- GRIB2 data representation template 5.42 ("CCSDS recompression") —
  decoded through the system ``libaec`` (``aec_buffer_decode``); the
  template's flags octet IS libaec's flag word by WMO definition
  (io/grib.py).

Each library is loaded with ctypes when the module is imported; one that
cannot be loaded is ``None`` (``_libsz``, ``_libaec``), the import still
succeeds, and a call that needs it raises a ``ValueError`` naming it.
The encoders ``szip_compress`` and ``aec_encode`` are the authoritative
ones of the same libraries, for writing test files.
"""
import ctypes
import ctypes.util

__all__ = [
    "szip_available",
    "szip_decompress",
    "aec_available",
    "aec_decode",
]


class _SzComT(ctypes.Structure):
    _fields_ = [
        ("options_mask", ctypes.c_int),
        ("bits_per_pixel", ctypes.c_int),
        ("pixels_per_block", ctypes.c_int),
        ("pixels_per_scanline", ctypes.c_int),
    ]


_SZ_OK = 0


def _load(candidates):
    for name in candidates:
        try:
            return ctypes.CDLL(name)
        except OSError:
            continue
    return None


_libsz = _load(
    [ctypes.util.find_library("sz") or "libsz.so.2", "libsz.so.2", "libsz.so"]
)
if _libsz is not None:
    try:
        _libsz.SZ_BufftoBuffDecompress.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(_SzComT),
        ]
        _libsz.SZ_BufftoBuffDecompress.restype = ctypes.c_int
        _libsz.SZ_BufftoBuffCompress.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_size_t),
            ctypes.c_void_p,
            ctypes.c_size_t,
            ctypes.POINTER(_SzComT),
        ]
        _libsz.SZ_BufftoBuffCompress.restype = ctypes.c_int
    except AttributeError:
        _libsz = None


def szip_available():
    return _libsz is not None


def szip_decompress(data, uncompressed_size, options_mask, bits_per_pixel,
                    pixels_per_block, pixels_per_scanline):
    """Decode one szip stream (HDF4 coder-5 payload) to bytes."""
    if _libsz is None:
        raise ValueError(
            "szip-compressed data needs the system libsz (libaec's szip "
            "compatibility library), which is not loadable here"
        )
    params = _SzComT(
        int(options_mask), int(bits_per_pixel),
        int(pixels_per_block), int(pixels_per_scanline),
    )
    out = ctypes.create_string_buffer(int(uncompressed_size))
    out_len = ctypes.c_size_t(int(uncompressed_size))
    status = _libsz.SZ_BufftoBuffDecompress(
        out, ctypes.byref(out_len), data, len(data), ctypes.byref(params)
    )
    if status != _SZ_OK:
        raise ValueError("szip decompression failed (SZ error %d)" % status)
    return out.raw[: out_len.value]


def szip_compress(data, options_mask, bits_per_pixel, pixels_per_block,
                  pixels_per_scanline):
    """Encode bytes with the authoritative szip encoder (tests only)."""
    if _libsz is None:
        raise ValueError("libsz is not loadable here")
    params = _SzComT(
        int(options_mask), int(bits_per_pixel),
        int(pixels_per_block), int(pixels_per_scanline),
    )
    out = ctypes.create_string_buffer(len(data) * 2 + 4096)
    out_len = ctypes.c_size_t(len(out))
    status = _libsz.SZ_BufftoBuffCompress(
        out, ctypes.byref(out_len), data, len(data), ctypes.byref(params)
    )
    if status != _SZ_OK:
        raise ValueError("szip compression failed (SZ error %d)" % status)
    return out.raw[: out_len.value]


class _AecStream(ctypes.Structure):
    _fields_ = [
        ("next_in", ctypes.c_void_p),
        ("avail_in", ctypes.c_size_t),
        ("total_in", ctypes.c_size_t),
        ("next_out", ctypes.c_void_p),
        ("avail_out", ctypes.c_size_t),
        ("total_out", ctypes.c_size_t),
        ("bits_per_sample", ctypes.c_uint),
        ("block_size", ctypes.c_uint),
        ("rsi", ctypes.c_uint),
        ("flags", ctypes.c_uint),
        ("state", ctypes.c_void_p),
    ]


_AEC_OK = 0

_libaec = _load(
    [
        ctypes.util.find_library("aec") or "libaec.so.0",
        "libaec.so.0",
        "libaec.so",
    ]
)
if _libaec is not None:
    try:
        for fn in ("aec_buffer_decode", "aec_buffer_encode"):
            getattr(_libaec, fn).argtypes = [ctypes.POINTER(_AecStream)]
            getattr(_libaec, fn).restype = ctypes.c_int
    except AttributeError:
        _libaec = None


def aec_available():
    return _libaec is not None


def _aec_run(fn, data, out_size, bits_per_sample, block_size, rsi, flags):
    if _libaec is None:
        raise ValueError(
            "CCSDS/AEC-packed data needs the system libaec, which is not "
            "loadable here"
        )
    src = ctypes.create_string_buffer(bytes(data), len(data))
    out = ctypes.create_string_buffer(int(out_size))
    stream = _AecStream(
        ctypes.cast(src, ctypes.c_void_p),
        len(data),
        0,
        ctypes.cast(out, ctypes.c_void_p),
        int(out_size),
        0,
        int(bits_per_sample),
        int(block_size),
        int(rsi),
        int(flags),
        None,
    )
    status = fn(ctypes.byref(stream))
    if status != _AEC_OK:
        raise ValueError("CCSDS/AEC coding failed (AEC error %d)" % status)
    return out.raw[: stream.total_out]


def aec_decode(data, out_size, bits_per_sample, block_size, rsi, flags):
    """Decode a CCSDS/AEC stream (GRIB2 template 5.42 payload)."""
    return _aec_run(
        _libaec.aec_buffer_decode if _libaec else None,
        data, out_size, bits_per_sample, block_size, rsi, flags,
    )


def aec_encode(data, bits_per_sample, block_size, rsi, flags):
    """Encode with the authoritative AEC encoder (tests only)."""
    out_size = len(data) * 2 + 4096
    return _aec_run(
        _libaec.aec_buffer_encode if _libaec else None,
        data, out_size, bits_per_sample, block_size, rsi, flags,
    )
