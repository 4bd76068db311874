"""Device choice and the numpy <-> torch dtype bridge.

Every entry point of the port takes an explicit ``device``; ``None`` reads
``geomodeling.torch-device`` (default ``"cuda"``).  Asking for CUDA where
``torch.cuda.is_available()`` is False raises: nothing silently runs on
the CPU in place of the card.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.config import config

__all__ = [
    "resolve_device",
    "torch_dtype",
    "numpy_dtype",
    "common_dtype",
    "as_operand",
    "COMPARISONS",
    "compare",
    "equal_scalar",
    "isclose_scalar",
    "data_mask",
]

_TORCH_DTYPES = {
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.uint16): torch.uint16,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint32): torch.uint32,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.uint64): torch.uint64,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}
_NUMPY_DTYPES = {value: key for key, value in _TORCH_DTYPES.items()}


def resolve_device(device=None):
    """The torch.device to run on; raises when CUDA is asked for but absent."""
    if device is None:
        device = config.get("geomodeling.torch-device", "cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain torch versions" % str(device)
        )
    return device


def torch_dtype(dtype):
    """The torch dtype of a numpy dtype (or dtype-like)."""
    return _TORCH_DTYPES[np.dtype(dtype)]


def numpy_dtype(dtype):
    """The numpy dtype of a torch dtype."""
    return _NUMPY_DTYPES[dtype]


def common_dtype(*operands):
    """numpy's result dtype of ``operands``: tensors count by their dtype,
    Python scalars weakly, as numpy 2 promotes them."""
    return np.result_type(
        *[numpy_dtype(a.dtype) if isinstance(a, torch.Tensor) else a for a in operands]
    )


def as_operand(arg, dtype, device):
    """``arg`` (a tensor, an array or a scalar) as a tensor of numpy
    ``dtype`` on ``device``; scalars become 0-d tensors, converted as
    numpy converts them."""
    if isinstance(arg, torch.Tensor):
        return arg.to(torch_dtype(dtype))
    with np.errstate(over="ignore"):  # numpy rounds to inf as well
        return torch.tensor(np.asarray(arg).astype(dtype), device=device)


#: numpy comparison ufunc name -> (torch op, result for every cell when
#: the right operand is an integer above, and below, the common integer
#: dtype's range)
COMPARISONS = {
    "equal": (torch.eq, False, False),
    "not_equal": (torch.ne, True, True),
    "greater": (torch.gt, False, True),
    "greater_equal": (torch.ge, False, True),
    "less": (torch.lt, True, False),
    "less_equal": (torch.le, True, False),
}
_MIRRORED = {"greater": "less", "greater_equal": "less_equal",
             "less": "greater", "less_equal": "greater_equal"}


def compare(name, a, b):
    """numpy's ``np.<name>(a, b)`` for a tensor and a tensor or scalar:
    both operands are cast to numpy's common dtype first (torch promotes
    Python scalars and mixed integer widths otherwise), an integer outside
    that dtype's range compares as numpy 2 compares it, and ``None``
    equals nothing."""
    if not isinstance(a, torch.Tensor):
        return compare(_MIRRORED.get(name, name), b, a)
    op, above, below = COMPARISONS[name]
    if b is None:
        if name not in ("equal", "not_equal"):
            raise TypeError("cannot order values against None")
        return torch.full(a.shape, name == "not_equal", dtype=torch.bool, device=a.device)
    common = common_dtype(a, b)
    if common.kind in "iu" and isinstance(b, (int, np.integer)) and not isinstance(b, bool):
        info = np.iinfo(common)
        if not info.min <= int(b) <= info.max:
            value = above if int(b) > info.max else below
            return torch.full(a.shape, value, dtype=torch.bool, device=a.device)
    return op(a.to(torch_dtype(common)), as_operand(b, common, a.device))


def equal_scalar(values, scalar):
    """``values == scalar`` under numpy's promotion rules, where torch's
    differ (e.g. an int64 tensor against a Python float compares in
    float64 in numpy and float32 in torch).  ``None``, and an integer the
    common integer dtype cannot hold, match nothing."""
    return compare("equal", values, scalar)


def isclose_scalar(values, scalar):
    """``np.isclose(values, scalar)`` (default tolerances) bit for bit:
    the scalar's part of numpy's formula, ``atol + rtol * |y|``, is
    computed on the host with numpy's own arithmetic, and the rest in the
    dtypes numpy 2 promotes each step to."""
    y = scalar
    if not isinstance(y, (int, float, complex)):
        y = np.asanyarray(y)
    if getattr(y, "dtype", None) is not None:
        y = np.asanyarray(y, dtype=np.result_type(y, 1.0))
    elif isinstance(y, int):
        y = float(y)
    tolerance = 1e-08 + 1e-05 * abs(y)
    step = np.result_type(numpy_dtype(values.dtype), y)  # x - y and x == y
    test = np.result_type(step, tolerance)  # |x - y| <= tolerance
    x = values.to(torch_dtype(step))
    y_t = as_operand(y, step, values.device)
    within = (x - y_t).abs().to(torch_dtype(test)) <= as_operand(tolerance, test, values.device)
    if not np.isfinite(y):
        within = torch.zeros_like(within)
    return within | (x == y_t)


def data_mask(values, no_data_value):
    """The twin of ``geo.get_index``: the data cells of ``values``
    (floats compare with ``np.isclose``; a ``None`` nodata is never
    matched)."""
    if values.dtype.is_floating_point and no_data_value is not None:
        return ~isclose_scalar(values, no_data_value)
    return ~equal_scalar(values, no_data_value)
