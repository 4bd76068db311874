"""The Smooth twin.

Counterpart of dask_geomodeling_tpu/raster/spatial.py:_smooth_jax: nodata
becomes ``fill``, then the Gaussian (one kernel launch over all B x bands
planes of a batch), the cast back to the frame's dtype, then the exact
crop or the order-0 zoom back onto the request grid.
"""
import torch

from dask_geomodeling_tpu.raster.spatial import _smooth_process
from dask_geomodeling_tpu_torch.device import equal_scalar, numpy_dtype
from dask_geomodeling_tpu_torch.ops.cuda_stencils import gaussian_blur
from dask_geomodeling_tpu_torch.ops.stencils import blur_dtype
from dask_geomodeling_tpu_torch.registry import register

__all__ = []


def _smooth_torch(data, process_kwargs=None):
    if data is None or process_kwargs is None:
        return data
    size_y, size_x = process_kwargs["size"]
    fill = process_kwargs["fill"]
    no_data_value = data["no_data_value"]
    values = data["values"]
    dtype = values.dtype
    n_batch, bands, height, width = values.shape

    values = torch.where(
        equal_scalar(values, no_data_value),
        numpy_dtype(dtype).type(fill).item(),
        values,
    )
    planes = values.to(blur_dtype(dtype)).reshape(n_batch * bands, height, width)
    blurred = gaussian_blur(planes.contiguous(), size_y / 3, size_x / 3, fill)
    blurred = blurred.to(dtype).reshape(n_batch, bands, height, width)

    if process_kwargs["smooth_mode"] == "exact":
        my, mx = int(round(size_y)), int(round(size_x))
        blurred = blurred[:, :, my : height - my, mx : width - mx]
    else:
        # nearest-neighbour zoom back to the original shape (order 0),
        # ndimage.affine_transform's floor(c + 0.5) with c = i * zoom + size
        device = values.device
        zy, zx = 1 - 2 * size_y / height, 1 - 2 * size_x / width
        rows = torch.arange(height, dtype=torch.float64, device=device) * zy
        cols = torch.arange(width, dtype=torch.float64, device=device) * zx
        rows = torch.clamp((rows + size_y + 0.5).long(), 0, height - 1)
        cols = torch.clamp((cols + size_x + 0.5).long(), 0, width - 1)
        blurred = blurred[:, :, rows][:, :, :, cols]
    return {"values": blurred, "no_data_value": no_data_value}


register(_smooth_process, _smooth_torch)
