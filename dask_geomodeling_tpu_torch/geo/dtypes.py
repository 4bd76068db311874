"""Dtype and footprint rules (counterparts of
dask_geomodeling_tpu/geo/dtypes.py)."""
import numpy as np

__all__ = ["get_dtype_max", "get_dtype_min", "get_uint_dtype", "get_footprint"]


def get_dtype_max(dtype):
    """Return the maximum of a dtype as a python scalar."""
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.finfo(d).max.item()
    return np.iinfo(d).max


def get_dtype_min(dtype):
    """Return the minimum of a dtype as a python scalar."""
    d = np.dtype(dtype)
    if d.kind == "f":
        return np.finfo(d).min.item()
    return np.iinfo(d).min


def get_uint_dtype(n):
    """Smallest unsigned int dtype that holds ``n`` values plus nodata."""
    if n < 0:
        raise ValueError("Value does not fit in uint dtype ({})".format(n))
    for dtype in ("u1", "u2", "u4", "u8"):
        if n - 1 <= np.iinfo(dtype).max:
            return np.dtype(dtype)
    raise ValueError("Value does not fit in uint dtype ({})".format(n))


def get_footprint(size):
    """Boolean circular footprint with diameter ``size`` (coerced uneven)."""
    s = size // 2 * 2 + 1
    o = (s - 1) // 2
    r = s / 2
    x, y = np.indices((s, s)) - o
    return (x**2 + y**2) < (r**2)
