"""Native (C++) host components: the TIFF decoders and the scanline
rasterizer.

Counterpart of dask_geomodeling_tpu/native/__init__.py, at its names but
for the packed fetch (``fetchdecode.cpp``), which the port does not use.
``tiffcodec.cpp`` and ``rasterize.cpp`` build at first use with g++
(``ops/_build.py``: ``-O3 -shared -fPIC -std=c++17``, a hash-named library
in ``_build/``) and load with ctypes, which releases the GIL around each
call, so the codec's thread pool decodes a window's chunks in parallel.

Unlike the JAX package, whose loaders log a warning and return None when
g++ fails (its callers then drop to Python), a failure to build or load
raises here, naming the compiler and the source: no caller falls back to
the pure-Python decoders (io/geotiff.py) or the numpy polygon scanline
(geo/rasterize.py), which stay as the plain versions the tests hold these
to.  ``counts`` tallies the native calls (chip_smoke.py reads it).
"""
import ctypes
import os
import threading

import numpy as np

from dask_geomodeling_tpu_torch.ops import _build

__all__ = [
    "load_tiffcodec",
    "tiff_decode_native",
    "load_rasterizer",
    "rasterize_native",
    "counts",
    "reset_counts",
]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_HERE, "rasterize.cpp")
_TIFF_SOURCE = os.path.join(_HERE, "tiffcodec.cpp")

_lock = threading.Lock()
_lib = None
_tiff_lib = None

#: native calls since the last reset_counts(): chunk decodes and their
#: decoded bytes, and rasterize_native's burns (one a call)
counts = {"tiff_decodes": 0, "tiff_bytes": 0, "burns": 0}


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
