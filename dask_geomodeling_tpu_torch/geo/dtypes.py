"""Dtype, nodata and footprint rules (counterparts of
dask_geomodeling_tpu/geo/dtypes.py): data cells are ``values !=
no_data_value``, floats compared with ``np.isclose``."""
import re
from math import floor, log10

import numpy as np

__all__ = [
    "get_index",
    "get_dtype_max",
    "get_dtype_min",
    "get_int_dtype",
    "get_uint_dtype",
    "get_footprint",
    "get_rounded_repr",
    "parse_percentile_statistic",
    "dtype_for_statistic",
]

PERCENTILE_REGEX = re.compile(r"^p([\d.]+)$")


def get_index(values, no_data_value):
    """Return a boolean index selecting the *data* cells in ``values``."""
    equal = np.isclose if values.dtype.kind == "f" else np.equal
    return np.logical_not(equal(values, no_data_value))


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


def get_int_dtype(n):
    """Smallest signed int dtype that holds ``n`` values plus a nodata slot."""
    for dtype in ("i1", "i2", "i4", "i8"):
        if (n - 1 <= np.iinfo(dtype).max) and (n >= np.iinfo(dtype).min):
            return np.dtype(dtype)
    raise ValueError("Value does not fit in int dtype ({})".format(n))


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


def get_rounded_repr(obj, significant=4, fmt="{} (rounded)"):
    """Repr of a number tuple rounded to ``significant`` digits."""
    def to_significant(n):
        if not n:
            return n
        magnitude = int(floor(log10(abs(n))))
        return round(n, significant - 1 - magnitude)

    rounded = obj.__class__(to_significant(n) for n in obj)
    if tuple(rounded) == tuple(obj):
        return repr(obj)
    return fmt.format(repr(rounded))


def parse_percentile_statistic(statistic):
    """Parse ``'p<float>'``; returns ``(statistic, percentile_or_None)``."""
    match = PERCENTILE_REGEX.findall(statistic)
    if match:
        percentile = float(match[0])
        if not 0 <= percentile <= 100:
            raise ValueError("Percentiles must be in the range [0, 100]")
        return "percentile", percentile
    return statistic, None


def dtype_for_statistic(dtype, statistic):
    """Result dtype of a statistic: min/max keep dtype, sum promotes like
    Add, count is int32, everything else promotes like Divide."""
    if statistic in ("min", "max"):
        return dtype
    if statistic == "sum":
        if np.issubdtype(dtype, np.integer) or dtype == bool:
            return np.result_type(dtype, np.int32)
        if np.issubdtype(dtype, np.floating):
            return np.result_type(dtype, np.float32)
        return dtype
    if statistic == "count":
        return np.dtype(np.int32)
    return np.result_type(np.float32, dtype)
