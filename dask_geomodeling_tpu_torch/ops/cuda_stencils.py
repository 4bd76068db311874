"""The hand-written CUDA Gaussian (csrc/gaussian_blur.cu) and its wrapper.

Replaces the Pallas TPU kernel ``gaussian_blur_pallas``
(dask_geomodeling_tpu/ops/pallas_stencils.py:55).  The kernel is bitwise
equal to ``ops/stencils.py:gaussian_blur_reference``; see the source for
its design and what bounds it on the card.

``gaussian_blur`` takes the plain version only for a tensor on the CPU.
For a CUDA tensor it launches the kernel or raises: there is no fallback.
``launches`` counts kernel launches (every ``<<<>>>``), and
``fused_launches`` those of the fused shape, so a run can show which path
and which launch shape it took.
"""
import ctypes

import numpy as np
import torch

from dask_geomodeling_tpu_torch.ops import _build
from dask_geomodeling_tpu_torch.ops.stencils import (
    gaussian_blur_reference,
    gaussian_weights,
)

__all__ = ["gaussian_blur", "launches", "fused_launches", "reset_launches"]

#: kernel launches since the last reset_launches(): one per fused call,
#: two per call of the large-radius shape
launches = 0
#: of those, launches of the fused shape (radius <= the fused limit)
fused_launches = 0

_ENTRY = {torch.float32: "gaussian_blur_f32", torch.float64: "gaussian_blur_f64"}


def reset_launches():
    global launches, fused_launches
    launches = 0
    fused_launches = 0


def _library():
    lib = _build.load_library("gaussian_blur")
    if not getattr(lib, "_declared", False):
        for name in _ENTRY.values():
            fn = getattr(lib, name)
            fn.argtypes = [
                ctypes.c_void_p,  # in
                ctypes.c_void_p,  # out
                ctypes.c_void_p,  # scratch (NULL for the fused launch)
                ctypes.c_void_p,  # weights, float64 [wy, wx]
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
    if values.ndim != 3:
        raise ValueError(
            "gaussian_blur: expected (N, h, w), got shape %s" % (tuple(values.shape),)
        )
    if not values.is_contiguous():
        raise ValueError("gaussian_blur: input must be contiguous")
    n, height, width = values.shape
    if height >= 2**31 or width >= 2**31:
        raise ValueError("gaussian_blur: plane too large")
    out = torch.empty_like(values)
    if values.numel() == 0:
        return out

    weights_y, radius_y = gaussian_weights(sigma_y)
    weights_x, radius_x = gaussian_weights(sigma_x)
    weights = torch.from_numpy(
        np.concatenate([weights_y, weights_x]).astype(np.float64)
    ).to(values.device)
    lib = _library()
    scratch = None
    if max(radius_y, radius_x) > lib.gaussian_blur_fused_max_radius():
        scratch = torch.empty_like(values)
    with torch.cuda.device(values.device):
        err = getattr(lib, _ENTRY[values.dtype])(
            values.data_ptr(),
            out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            weights.data_ptr(),
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
