"""Device choice and the numpy <-> torch dtype bridge.

Every entry point of the port takes an explicit ``device``; ``None`` reads
``geomodeling.torch-device`` (default ``"cuda"``).  Asking for CUDA where
``torch.cuda.is_available()`` is False raises: nothing silently runs on
the CPU in place of the card.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.config import config

__all__ = ["resolve_device", "torch_dtype", "numpy_dtype", "equal_scalar"]

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


def equal_scalar(values, scalar):
    """``values == scalar`` under numpy's promotion rules, where torch's
    differ (e.g. an int64 tensor against a Python float compares in
    float64 in numpy and float32 in torch).  ``None``, and an integer the
    common integer dtype cannot hold, match nothing."""
    common = None if scalar is None else np.result_type(numpy_dtype(values.dtype), scalar)
    if common is None or (
        common.kind in "iu"
        and isinstance(scalar, (int, np.integer))
        and not np.iinfo(common).min <= int(scalar) <= np.iinfo(common).max
    ):
        return torch.zeros(values.shape, dtype=torch.bool, device=values.device)
    other = torch.tensor(
        np.asarray(scalar).astype(common), device=values.device
    )
    return values.to(torch_dtype(common)) == other
