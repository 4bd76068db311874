"""Plain torch stencils: the references the CUDA kernels are held to.

``gaussian_blur_reference`` is the counterpart of
dask_geomodeling_tpu/ops/stencils.py:gaussian_blur_jax, but it follows
the host's arithmetic instead of the TPU's: scipy.ndimage.gaussian_filter
(what the numpy Smooth process runs) accumulates each 1-D pass in double
and writes it into the frame's own dtype before the next pass.  Doing the
same here makes the port's Smooth bitwise equal to the host, where the
JAX twin, which accumulates in float32, is only allclose.

``binary_dilation`` is the counterpart of binary_dilation_jax with
``connectivity=1, rank3=True``: scipy's default structure on a
(bands, h, w) array, the rank-3 cross, which dilates across the band axis
as well.

``moving_max_reference`` is the counterpart of
dask_geomodeling_tpu/ops/pallas_stencils.py:moving_max_pallas: the
circular footprint's maximum with out-of-plane taps at the dtype's lowest
value, computed in the input's own dtype.
"""
import numpy as np
import torch
import torch.nn.functional as F

from dask_geomodeling_tpu_torch.geo.dtypes import get_footprint

__all__ = [
    "binary_dilation",
    "gaussian_blur_reference",
    "gaussian_weights",
    "blur_dtype",
    "footprint_runs",
    "moving_max_reference",
]


def binary_dilation(mask):
    """``scipy.ndimage.binary_dilation`` of each (bands, h, w) item of a
    (B, bands, h, w) boolean tensor with the rank-3 cross: a cell is set
    when it or one of its six neighbours along the last three axes is set;
    cells past the edges count as unset."""
    out = mask.clone()
    for axis in (-3, -2, -1):
        n = mask.shape[axis]
        if n < 2:
            continue
        out.narrow(axis, 1, n - 1).logical_or_(mask.narrow(axis, 0, n - 1))
        out.narrow(axis, 0, n - 1).logical_or_(mask.narrow(axis, 1, n - 1))
    return out


def gaussian_weights(sigma, truncate=4.0):
    """(weights, radius) of scipy.ndimage.gaussian_filter1d's kernel, to
    the last bit: ``exp(-0.5 / sigma**2 * x**2)`` normalised.  The JAX
    package's ``gaussian_kernel_1d`` writes ``exp(-0.5 * (x / sigma)**2)``,
    which differs in the last bit for some sigmas; the radius
    ``int(truncate * sigma + 0.5)`` is the same.  Radius 0 is the identity."""
    radius = int(truncate * float(sigma) + 0.5)
    if radius < 1 or sigma <= 0:
        return np.array([1.0]), 0
    x = np.arange(-radius, radius + 1)
    weights = np.exp(-0.5 / (float(sigma) * float(sigma)) * x**2)
    return weights / weights.sum(), radius


def blur_dtype(dtype):
    """The dtype a blur of ``dtype`` data computes and returns: float64
    stays float64, everything else works in float32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def gaussian_blur_reference(values, sigma_y, sigma_x, fill):
    """Separable Gaussian over (N, h, w) data with a constant ``fill``
    boundary and scipy's kernels (``gaussian_weights``).

    Each pass starts with ``x[c] * w[0]`` and adds ``(x[c-j] + x[c+j]) *
    w[j]`` for j = r..1 (scipy's symmetric order), in float64 with separate
    multiplies and adds, then rounds to the working dtype; y first, then x.
    A pass whose radius is 0 is skipped.
    """
    out_dtype = blur_dtype(values.dtype)
    out = values.to(out_dtype)
    for axis, sigma in ((1, sigma_y), (2, sigma_x)):
        weights, radius = gaussian_weights(sigma)
        if radius == 0:
            continue
        pad = (0, 0, radius, radius) if axis == 1 else (radius, radius)
        # pad in float64 with the double fill, as scipy pads with cval
        padded = F.pad(out.to(torch.float64), pad, value=float(fill))
        length = out.shape[axis]

        def tap(offset):
            return padded.narrow(axis, radius + offset, length)

        acc = tap(0) * float(weights[radius])
        for j in range(radius, 0, -1):
            acc = acc + (tap(-j) + tap(j)) * float(weights[radius + j])
        out = acc.to(out_dtype)
    return out


def footprint_runs(size):
    """The circular footprint of ``size`` as row runs: (dy, dx_lo, dx_hi)
    per footprint row that holds a tap."""
    footprint = get_footprint(size)
    radius = size // 2
    runs = []
    for row in range(footprint.shape[0]):
        cols = np.nonzero(footprint[row])[0]
        if len(cols):
            runs.append((row - radius, int(cols[0] - radius), int(cols[-1] - radius)))
    return runs


#: unsigned dtypes torch has no maximum for, and the signed dtype of the
#: same width they map onto, order kept, by flipping the sign bit
_SIGNED_OF = {
    torch.uint16: torch.int16,
    torch.uint32: torch.int32,
    torch.uint64: torch.int64,
}


def moving_max_reference(values, size):
    """Circular-footprint maximum over (N, h, w) data, in the input's own
    dtype and shape.

    Taps outside the plane are the dtype's lowest value (-inf for floats),
    so every window holds at least its centre; a NaN in a window gives NaN
    (``torch.maximum``, as ``jnp.maximum`` in the Pallas kernel).  The
    maximum of values of one dtype is one of them, so nothing rounds.
    """
    radius = int(size) // 2
    dtype = values.dtype
    signed = _SIGNED_OF.get(dtype)
    if signed is not None:
        # x ^ sign bit is an order-keeping bijection onto the signed type
        sign = torch.iinfo(signed).min
        values = values.view(signed) ^ sign
    work = values.dtype
    if work.is_floating_point:
        lowest = float("-inf")
    elif work == torch.bool:
        lowest = False
    else:
        lowest = torch.iinfo(work).min
    height, width = values.shape[-2:]
    padded = F.pad(values, (radius, radius, radius, radius), value=lowest)
    out = None
    for dy, dx_lo, dx_hi in footprint_runs(size):
        for dx in range(dx_lo, dx_hi + 1):
            piece = padded[:, radius + dy : radius + dy + height, radius + dx : radius + dx + width]
            out = piece.clone() if out is None else torch.maximum(out, piece)
    if signed is not None:
        out = (out ^ sign).view(dtype)
    return out
