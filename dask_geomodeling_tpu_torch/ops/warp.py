"""The warp, nearest or bilinear: the host version and the device version.

Counterpart of dask_geomodeling_tpu/ops/warp.py.  The host half
(``warp_numpy`` with ``warp_indices``/``gather_numpy`` and the bilinear
``_bilinear_sample``) is copied from it: for every target pixel centre
the source pixel containing its transform, per pixel, or the blend of the
four source pixels around it.  The device half (``warp_torch``) is its
warp_jax written for B tiles at once: the source ``values`` (bands, H, W)
is shared by the batch, while ``bbox`` (B, 4) and ``coarse_grid``
(B, 2, ch, cw) vary per tile.

- cross-CRS: the approximate transformer of warp_jax: the host transforms
  a coarse grid of target pixel centres (stride ``APPROX_STRIDE``) into
  fractional source indices
  (``coarse_index_grid``), and the device interpolates it bilinearly.
  Unlike warp_jax, which gets the grid in float32 and interpolates in
  float32 (the TPU emulates float64), the port keeps both in float64: at
  an 8192 px source float32 resolves about 1/2000 of a pixel, which moved
  3.9e-4 of the warped cells of the headline view to a neighbouring
  source pixel, against none with float64 (six 516^2 tiles on the CPU);
- same-CRS: the index map is affine, computed in float64 per axis as
  warp_jax does.

Then the floor, the ``finite``/``inside`` mask, the gather, the fill and
the source-nodata replacement, in warp_jax's order and dtypes.  Bilinear
resampling (``_bilinear_sample_torch``) blends in float64 as the host
does, so a same-CRS bilinear warp is bitwise the host's; a neighbour that
is nodata makes the cell nodata.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.device import equal_scalar, isclose_scalar, torch_dtype
from dask_geomodeling_tpu_torch.geo.crs import get_projection, transform_points
from dask_geomodeling_tpu_torch.geo.geotransform import GeoTransform

__all__ = [
    "warp_numpy",
    "warp_indices",
    "gather_numpy",
    "warp_torch",
    "coarse_index_grid",
    "coarse_grid_shape",
    "APPROX_STRIDE",
    "INTERPOLATIONS",
]


#: the resamplings ``geomodeling.warp-interpolation`` may name
INTERPOLATIONS = ("nearest", "bilinear")


def _check_interpolation(interpolation):
    if interpolation not in INTERPOLATIONS:
        raise ValueError(
            "warp interpolation %r is not one of %s" % (interpolation, INTERPOLATIONS)
        )


#: the coarse grid's stride in target pixels: the JAX package's default
#: ``geomodeling.warp-approx-stride``
APPROX_STRIDE = 8


def coarse_grid_shape(width, height, stride):
    """Coarse-node grid shape of the approximate transformer."""
    return (-(-height // stride) + 1, -(-width // stride) + 1)


def _fractional_indices(src_gt, src_srs, src_shape, bbox, projection, width, height):
    """Fractional source (row, col) grids at target pixel centres, shifted
    by half a pixel to the pixel-centre frame, and the nearest-containment
    inside mask; each (height, width).  Out-of-domain CRS transforms give
    NaN, which are outside."""
    p, a, b, q, c, d = GeoTransform.from_bbox(bbox, height, width)
    xs = p + a * (np.arange(width) + 0.5)
    ys = q + d * (np.arange(height) + 0.5)
    tx, ty = np.meshgrid(xs, ys)
    if get_projection(src_srs).upper() != get_projection(projection).upper():
        tx, ty = transform_points(tx, ty, projection, src_srs)
    sp, sa, sb, sq, sc, sd = src_gt
    frac_cols = (tx - sp) / sa
    frac_rows = (ty - sq) / sd
    src_h, src_w = src_shape[-2], src_shape[-1]
    rows = np.floor(frac_rows)
    cols = np.floor(frac_cols)
    inside = (rows >= 0) & (rows < src_h) & (cols >= 0) & (cols < src_w)
    return frac_rows - 0.5, frac_cols - 0.5, inside


def warp_indices(src_gt, src_srs, src_shape, bbox, projection, width, height):
    """Source (row, col) int64 index grids for a target raster, and the
    mask of target cells whose source index lies inside the source; each
    (height, width)."""
    fr, fc, inside = _fractional_indices(
        src_gt, src_srs, src_shape, bbox, projection, width, height
    )
    # (x - 0.5) + 0.5 is the JAX package's rounding, kept for its bits;
    # NaN floors to INT64_MIN here, which `inside` already excludes
    with np.errstate(invalid="ignore"):
        rows = np.floor(fr + 0.5).astype(np.int64)
        cols = np.floor(fc + 0.5).astype(np.int64)
    return rows, cols, inside


def gather_numpy(values, rows, cols, inside, fillvalue, dtype):
    """Gather source values at (rows, cols); outside cells get fillvalue."""
    bands = values.shape[0]
    out = np.full((bands, rows.shape[0], rows.shape[1]), fillvalue, dtype=dtype)
    safe_rows = np.where(inside, rows, 0)
    safe_cols = np.where(inside, cols, 0)
    gathered = values[:, safe_rows, safe_cols]
    out[:, inside] = gathered[:, inside]
    return out


def _bilinear_sample(values, fr, fc, inside, no_data_value, fillvalue, dtype):
    """Bilinear sample of (bands, h, w) at fractional indices (fr, fc).

    Edge neighbours clamp; a cell is nodata when it falls outside the
    source or when ANY participating neighbour is nodata (never
    interpolate across the nodata boundary).  The blend is float64;
    integer results round half to even.
    """
    src_h, src_w = values.shape[-2], values.shape[-1]
    fr = np.where(np.isfinite(fr), fr, 0.0)
    fc = np.where(np.isfinite(fc), fc, 0.0)
    r0 = np.clip(np.floor(fr), 0, src_h - 1).astype(np.int32)
    c0 = np.clip(np.floor(fc), 0, src_w - 1).astype(np.int32)
    r1 = np.clip(r0 + 1, 0, src_h - 1)
    c1 = np.clip(c0 + 1, 0, src_w - 1)
    wr = np.clip(fr - r0, 0.0, 1.0)
    wc = np.clip(fc - c0, 0.0, 1.0)

    v00 = values[:, r0, c0].astype(np.float64)
    v01 = values[:, r0, c1].astype(np.float64)
    v10 = values[:, r1, c0].astype(np.float64)
    v11 = values[:, r1, c1].astype(np.float64)

    top = v00 + (v01 - v00) * wc
    bottom = v10 + (v11 - v10) * wc
    blended = top + (bottom - top) * wr

    valid = inside[None]
    if no_data_value is not None:
        def is_nodata(v):
            if values.dtype.kind == "f":
                return np.isclose(v, no_data_value)
            return v == no_data_value

        touched = is_nodata(v00) | is_nodata(v01) | is_nodata(v10) | is_nodata(v11)
        valid = valid & ~touched
    dtype = np.dtype(dtype)
    if dtype.kind in "iub":
        blended = np.rint(blended)
    return np.where(valid, blended.astype(dtype), dtype.type(fillvalue))


def warp_numpy(
    values,
    src_gt,
    src_srs,
    no_data_value,
    bbox,
    projection,
    width,
    height,
    dtype=None,
    fillvalue=None,
    interpolation="nearest",
):
    """Full host warp of a (bands, h, w) array into the requested grid."""
    _check_interpolation(interpolation)
    dtype = np.dtype(dtype) if dtype is not None else values.dtype
    fillvalue = no_data_value if fillvalue is None else fillvalue
    if interpolation == "bilinear":
        fr, fc, inside = _fractional_indices(
            src_gt, src_srs, values.shape, bbox, projection, width, height
        )
        return _bilinear_sample(values, fr, fc, inside, no_data_value, fillvalue, dtype)
    rows, cols, inside = warp_indices(
        src_gt, src_srs, values.shape, bbox, projection, width, height
    )
    result = gather_numpy(values, rows, cols, inside, fillvalue, dtype)
    # replace source nodata with the target fillvalue
    if no_data_value is not None and no_data_value != fillvalue:
        src_nodata = (
            np.isclose(result, no_data_value)
            if dtype.kind == "f"
            else result == no_data_value
        )
        result[src_nodata] = fillvalue
    return result


def coarse_index_grid(src_gt, src_srs, bbox, projection, width, height, stride):
    """Fractional source indices (cols, rows) of a coarse grid of target
    pixel centres, (2, ch, cw) float64, computed on the host.  The JAX
    package's ``host_coarse_grid`` with the float32 cast left out.
    Out-of-domain transforms carry NaN, which the warp masks."""
    p, a, b, q, c, d = GeoTransform.from_bbox(bbox, height, width)
    ch, cw = coarse_grid_shape(width, height, stride)
    tx, ty = np.meshgrid(
        p + a * (np.arange(cw) * stride + 0.5), q + d * (np.arange(ch) * stride + 0.5)
    )
    with np.errstate(all="ignore"):
        sx, sy = transform_points(tx, ty, projection, src_srs)
        sp, sa, sb, sq, sc, sd = src_gt
        return np.stack([(sx - sp) / sa, (sy - sq) / sd])


def _interp_coarse(grid, width, height, stride):
    """Bilinear interpolation of (B, 2, ch, cw) coarse fractional indices
    at every target pixel, in float64: (frac_cols, frac_rows), (B, h, w)."""
    device = grid.device
    ch, cw = grid.shape[-2:]
    fx = torch.arange(width, dtype=torch.float64, device=device) / stride
    fy = torch.arange(height, dtype=torch.float64, device=device) / stride
    ix = torch.clamp(torch.floor(fx).long(), 0, cw - 2)
    iy = torch.clamp(torch.floor(fy).long(), 0, ch - 2)
    wx = (fx - ix)[None, None, :]
    wy = (fy - iy)[None, :, None]

    def interp(coarse):
        rows0, rows1 = coarse[:, iy], coarse[:, iy + 1]
        c00, c01 = rows0[:, :, ix], rows0[:, :, ix + 1]
        c10, c11 = rows1[:, :, ix], rows1[:, :, ix + 1]
        top = c00 + (c01 - c00) * wx
        bottom = c10 + (c11 - c10) * wx
        return top + (bottom - top) * wy

    grid = grid.to(torch.float64)
    return interp(grid[:, 0]), interp(grid[:, 1])


def _floor_index(frac, size, index_dtype):
    """floor(frac) as an index, and whether it lies in [0, size).

    Non-finite positions (out-of-domain CRS transforms) are masked BEFORE
    the cast: NaN casts differently on the host and on the card.  The
    clamp keeps far-away floats inside the integer range, and leaves them
    outside [0, size)."""
    finite = torch.isfinite(frac)
    floored = torch.floor(torch.where(finite, frac, torch.zeros_like(frac)))
    index = torch.clamp(floored, -1, size).to(index_dtype)
    return index, finite & (index >= 0) & (index < size)


def _gather(values, rows, cols):
    """values[:, rows, cols] for (B, h, w) index tensors: (B, bands, h, w)."""
    bands, src_h, src_w = values.shape
    flat_index = rows * src_w + cols
    gathered = torch.index_select(
        values.reshape(bands, src_h * src_w), 1, flat_index.reshape(-1)
    )
    return gathered.reshape((bands,) + tuple(flat_index.shape)).movedim(0, 1)


def _bilinear_sample_torch(values, fr, fc, inside, no_data_value, fillvalue, dtype):
    """``_bilinear_sample`` for B tiles: ``fr`` and ``fc`` broadcast to
    (B, h, w), ``inside`` is (B, h, w); returns (B, bands, h, w).  Index
    arithmetic, blend and nodata test follow the host's, in float64."""
    src_h, src_w = values.shape[-2], values.shape[-1]
    fr, fc = torch.broadcast_tensors(fr, fc)
    fr = torch.where(torch.isfinite(fr), fr, 0.0)
    fc = torch.where(torch.isfinite(fc), fc, 0.0)
    r0 = torch.clamp(torch.floor(fr), 0, src_h - 1).to(torch.int64)
    c0 = torch.clamp(torch.floor(fc), 0, src_w - 1).to(torch.int64)
    r1 = torch.clamp(r0 + 1, 0, src_h - 1)
    c1 = torch.clamp(c0 + 1, 0, src_w - 1)
    wr = torch.clamp(fr - r0, 0.0, 1.0)[:, None]
    wc = torch.clamp(fc - c0, 0.0, 1.0)[:, None]

    v00 = _gather(values, r0, c0).to(torch.float64)
    v01 = _gather(values, r0, c1).to(torch.float64)
    v10 = _gather(values, r1, c0).to(torch.float64)
    v11 = _gather(values, r1, c1).to(torch.float64)

    top = v00 + (v01 - v00) * wc
    bottom = v10 + (v11 - v10) * wc
    blended = top + (bottom - top) * wr

    valid = inside[:, None]
    if no_data_value is not None:
        def is_nodata(v):
            if values.dtype.is_floating_point:
                return isclose_scalar(v, no_data_value)
            return equal_scalar(v, no_data_value)

        touched = is_nodata(v00) | is_nodata(v01) | is_nodata(v10) | is_nodata(v11)
        valid = valid & ~touched
    dtype = np.dtype(dtype)
    if dtype.kind in "iub":
        blended = torch.round(blended)
    return torch.where(
        valid, blended.to(torch_dtype(dtype)), dtype.type(fillvalue).item()
    )


def warp_torch(
    values,
    src_gt,
    src_srs,
    no_data_value,
    bbox,
    projection,
    width,
    height,
    dtype,
    fillvalue,
    interpolation="nearest",
    coarse_grid=None,
):
    """Warp a (bands, H, W) source into B target grids: (B, bands, h, w).

    ``bbox`` is a (B, 4) float64 tensor; a cross-CRS warp needs
    ``coarse_grid``, the (B, 2, ch, cw) stack of the tiles'
    ``coarse_index_grid`` at ``APPROX_STRIDE``.  ``interpolation`` is
    "nearest" or "bilinear".
    """
    _check_interpolation(interpolation)
    dtype = np.dtype(dtype)
    device = values.device
    bands, src_h, src_w = values.shape
    # flat source index: int32 holds it below 2**31 elements
    index_dtype = torch.int32 if src_h * src_w < 2**31 else torch.int64

    if get_projection(src_srs).upper() != get_projection(projection).upper():
        expected = (2,) + coarse_grid_shape(width, height, APPROX_STRIDE)
        if coarse_grid is None or tuple(coarse_grid.shape[1:]) != expected:
            raise ValueError(
                "warp_torch: a cross-CRS warp needs the coarse grid "
                "(B, %d, %d, %d) of coarse_index_grid()" % expected
            )
        frac_cols, frac_rows = _interp_coarse(coarse_grid, width, height, APPROX_STRIDE)
    else:
        bbox = bbox.to(torch.float64)
        x1, y1, x2, y2 = (bbox[:, k : k + 1] for k in range(4))
        pixel_w = (x2 - x1) / width
        pixel_h = (y1 - y2) / height  # negative: y decreases with the row
        xs = x1 + pixel_w * (
            torch.arange(width, dtype=torch.float64, device=device) + 0.5
        )
        ys = y2 + pixel_h * (
            torch.arange(height, dtype=torch.float64, device=device) + 0.5
        )
        sp, sa, sb, sq, sc, sd = src_gt
        frac_cols = ((xs - sp) / sa)[:, None, :]
        frac_rows = ((ys - sq) / sd)[:, :, None]

    rows, in_r = _floor_index(frac_rows, src_h, index_dtype)
    cols, in_c = _floor_index(frac_cols, src_w, index_dtype)
    inside = in_r & in_c  # (B, h, w)
    if interpolation == "bilinear":
        return _bilinear_sample_torch(
            values, frac_rows - 0.5, frac_cols - 0.5, inside, no_data_value, fillvalue, dtype
        )
    flat_index = torch.where(inside, rows * src_w + cols, 0)
    n_batch = inside.shape[0]
    gathered = torch.index_select(
        values.reshape(bands, src_h * src_w), 1, flat_index.reshape(-1)
    )
    gathered = gathered.reshape(bands, n_batch, height, width).movedim(0, 1)
    gathered = gathered.to(torch_dtype(dtype))
    out = torch.where(inside[:, None], gathered, dtype.type(fillvalue).item())
    if no_data_value is not None and no_data_value != fillvalue:
        if dtype.kind == "f":
            nodata = torch.tensor(no_data_value, dtype=out.dtype, device=device)
            src_nodata = torch.isclose(out, nodata)
        else:
            src_nodata = equal_scalar(out, no_data_value)
        out = torch.where(src_nodata, dtype.type(fillvalue).item(), out)
    return out
