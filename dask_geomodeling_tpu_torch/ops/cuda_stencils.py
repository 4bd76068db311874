"""The hand-written CUDA stencils and their wrappers.

- ``gaussian_blur`` (csrc/gaussian_blur.cu) replaces the Pallas TPU
  kernel ``gaussian_blur_pallas``
  (dask_geomodeling_tpu/ops/pallas_stencils.py:55);
- ``moving_max`` (csrc/moving_max.cu) replaces ``moving_max_pallas``
  (dask_geomodeling_tpu/ops/pallas_stencils.py:136).

Each kernel is bitwise equal to its plain version in ops/stencils.py; the
sources say what bounds them on the card and what their designs do about
it.  A wrapper takes the plain version only for a tensor on the CPU.  For
a CUDA tensor it launches the kernel or raises: there is no fallback.
``launches`` counts Gaussian launches (every ``<<<>>>``) and
``fused_launches`` those of the fused shape; ``moving_max_launches``
counts moving-max launches.  ``reset_launches()`` sets all three to 0.
"""
import ctypes
import functools

import numpy as np
import torch

from dask_geomodeling_tpu_torch.ops import _build
from dask_geomodeling_tpu_torch.ops.stencils import (
    gaussian_blur_reference,
    gaussian_weights,
    moving_max_reference,
)

__all__ = [
    "gaussian_blur",
    "moving_max",
    "launches",
    "fused_launches",
    "moving_max_launches",
    "reset_launches",
]

#: Gaussian kernel launches since the last reset_launches(): one per fused
#: call, two per call of the large-radius shape
launches = 0
#: of those, launches of the fused shape (radius <= the fused limit)
fused_launches = 0
#: moving-max kernel launches since the last reset_launches()
moving_max_launches = 0

_ENTRY = {torch.float32: "gaussian_blur_f32", torch.float64: "gaussian_blur_f64"}


def reset_launches():
    global launches, fused_launches, moving_max_launches
    launches = 0
    fused_launches = 0
    moving_max_launches = 0


def _check_planes(name, values):
    """Raise unless ``values`` is a contiguous (N, h, w) tensor whose
    plane fits the kernels' int indices."""
    if values.ndim != 3:
        raise ValueError(
            "%s: expected (N, h, w), got shape %s" % (name, tuple(values.shape))
        )
    if not values.is_contiguous():
        raise ValueError("%s: input must be contiguous" % name)
    if values.shape[1] >= 2**31 or values.shape[2] >= 2**31:
        raise ValueError("%s: plane too large" % name)


def _library():
    lib = _build.load_library("gaussian_blur")
    if not getattr(lib, "_declared", False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p,  # in
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # scratch (NULL for the fused launch)
                ctypes.c_void_p,  # host weights, float64 [wy, wx] (fused launch)
                ctypes.c_void_p,  # the same on the device (two-pass launch)
                ctypes.c_int64,  # planes
                ctypes.c_int,  # height
                ctypes.c_int,  # width
                ctypes.c_int,  # radius y
                ctypes.c_int,  # radius x
                ctypes.c_double,  # fill
                ctypes.c_void_p,  # cudaStream_t
            ]
            fn.restype = ctypes.c_int
        lib.gaussian_blur_fused_max_radius.argtypes = []
        lib.gaussian_blur_fused_max_radius.restype = ctypes.c_int
        lib.gaussian_blur_error_string.argtypes = [ctypes.c_int]
        lib.gaussian_blur_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


@functools.lru_cache(maxsize=64)
def _half_weights(sigma_y, sigma_x):
    """(host array, radius y, radius x) of the kernel's weights for one
    pair of sigmas: w[0..r] of each axis (scipy's kernel is symmetric),
    [wy, wx], as float64 in host memory the kernel launch reads."""
    weights_y, radius_y = gaussian_weights(sigma_y)
    weights_x, radius_x = gaussian_weights(sigma_x)
    half = np.ascontiguousarray(
        np.concatenate([weights_y[radius_y:], weights_x[radius_x:]]), dtype=np.float64
    )
    return half, radius_y, radius_x


@functools.lru_cache(maxsize=64)
def _device_weights(sigma_y, sigma_x, device):
    """The same weights on ``device``, which the two-pass launch reads;
    copied there once per pair of sigmas."""
    return torch.from_numpy(_half_weights(sigma_y, sigma_x)[0]).to(device)


def gaussian_blur(values, sigma_y, sigma_x, fill):
    """Separable Gaussian over (N, h, w) data, constant ``fill`` boundary;
    returns float32 (float64 for float64 input), like the reference.

    CUDA tensors must be contiguous float32 or float64; cast before the
    call (the Smooth twin does).  One call is one kernel launch (two for a
    radius above the fused launch's limit) on the current stream, without
    a synchronise.
    """
    global launches, fused_launches
    if values.device.type == "cpu":
        return gaussian_blur_reference(values, sigma_y, sigma_x, fill)
    if values.device.type != "cuda":
        raise ValueError("gaussian_blur: unsupported device %s" % values.device)
    if values.dtype not in _ENTRY:
        raise TypeError(
            "gaussian_blur: CUDA input must be float32 or float64, got %s"
            % values.dtype
        )
    _check_planes("gaussian_blur", values)
    n, height, width = values.shape
    out = torch.empty_like(values)
    if values.numel() == 0:
        return out

    sigma_y, sigma_x = float(sigma_y), float(sigma_x)
    host_weights, radius_y, radius_x = _half_weights(sigma_y, sigma_x)
    lib = _library()
    scratch = device_weights = None
    if max(radius_y, radius_x) > lib.gaussian_blur_fused_max_radius():
        scratch = torch.empty_like(values)
        device_weights = _device_weights(sigma_y, sigma_x, values.device)
    with torch.cuda.device(values.device):
        err = getattr(lib, _ENTRY[values.dtype])(
            values.data_ptr(),
            out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            host_weights.ctypes.data,
            None if device_weights is None else device_weights.data_ptr(),
            n,
            height,
            width,
            radius_y,
            radius_x,
            float(fill),
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "gaussian_blur kernel launch failed: %s (CUDA error %d)"
            % (lib.gaussian_blur_error_string(err).decode(), err)
        )
    if scratch is None:
        launches += 1
        fused_launches += 1
    else:
        launches += 2
    return out


#: the kernel's type codes (csrc/moving_max.cu)
_MOVING_MAX_TYPES = {
    torch.float32: 0,
    torch.float64: 1,
    torch.int8: 2,
    torch.int16: 3,
    torch.int32: 4,
    torch.int64: 5,
    torch.uint8: 6,
    torch.uint16: 7,
    torch.uint32: 8,
    torch.uint64: 9,
}


def _moving_max_library():
    lib = _build.load_library("moving_max")
    if not getattr(lib, "_declared", False):
        lib.moving_max.argtypes = [
            ctypes.c_void_p,  # in
            ctypes.c_void_p,  # out
            ctypes.c_int64,  # planes
            ctypes.c_int,  # height
            ctypes.c_int,  # width
            ctypes.c_int,  # size (odd)
            ctypes.c_int,  # type code
            ctypes.c_void_p,  # cudaStream_t
        ]
        lib.moving_max.restype = ctypes.c_int
        lib.moving_max_error_string.argtypes = [ctypes.c_int]
        lib.moving_max_error_string.restype = ctypes.c_char_p
        lib._declared = True
    return lib


def moving_max(values, size):
    """Circular-footprint maximum of diameter ``size`` over (N, h, w) data,
    in the input's dtype and shape, like ``moving_max_reference``.

    CUDA tensors must be contiguous; every integer and float dtype runs
    natively, float16 through an exact float32 copy and bool as uint8.
    One call is one kernel launch on the current stream, without a
    synchronise.
    """
    global moving_max_launches
    if values.device.type == "cpu":
        return moving_max_reference(values, size)
    if values.device.type != "cuda":
        raise ValueError("moving_max: unsupported device %s" % values.device)
    if values.dtype == torch.float16:
        return moving_max(values.float(), size).half()
    if values.dtype == torch.bool:
        return moving_max(values.view(torch.uint8), size).view(torch.bool)
    if values.dtype not in _MOVING_MAX_TYPES:
        raise TypeError("moving_max: unsupported dtype %s" % values.dtype)
    _check_planes("moving_max", values)
    n, height, width = values.shape
    out = torch.empty_like(values)
    if values.numel() == 0:
        return out
    lib = _moving_max_library()
    with torch.cuda.device(values.device):
        err = lib.moving_max(
            values.data_ptr(),
            out.data_ptr(),
            n,
            height,
            width,
            int(size) // 2 * 2 + 1,  # get_footprint's odd diameter
            _MOVING_MAX_TYPES[values.dtype],
            torch.cuda.current_stream(values.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "moving_max kernel launch failed: %s (CUDA error %d)"
            % (lib.moving_max_error_string(err).decode(), err)
        )
    moving_max_launches += 1
    return out
