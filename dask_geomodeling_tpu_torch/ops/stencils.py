"""Plain torch stencils: the reference the CUDA kernels are held to.

``gaussian_blur_reference`` is the counterpart of
dask_geomodeling_tpu/ops/stencils.py:gaussian_blur_jax, but it follows
the host's arithmetic instead of the TPU's: scipy.ndimage.gaussian_filter
(what the numpy Smooth process runs) accumulates each 1-D pass in double
and writes it into the frame's own dtype before the next pass.  Doing the
same here makes the port's Smooth bitwise equal to the host, where the
JAX twin, which accumulates in float32, is only allclose.
"""
import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_blur_reference", "gaussian_weights", "blur_dtype"]


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

