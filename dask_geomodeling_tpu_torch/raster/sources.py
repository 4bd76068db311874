"""The source twin, and the one bridge from numpy payloads to tensors.

Counterpart of dask_geomodeling_tpu/raster/sources.py:_source_process_jax.
A MemorySource payload is moved to the device once (``to_device``) and
stays resident across tiles and batches, as the JAX executor's
``_device_put_cached`` keeps it in HBM.
"""
import weakref

import numpy as np
import torch

from dask_geomodeling_tpu.config import config
from dask_geomodeling_tpu.geo.crs import get_projection
from dask_geomodeling_tpu.raster.sources import (
    RasterSourceBase,
    _source_jax_capable,
)
from dask_geomodeling_tpu_torch.ops.warp import (
    approx_stride,
    coarse_index_grid,
    warp_torch,
)
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["to_device"]

#: (id(array), device) -> (weakref to the array, tensor)
_RESIDENT = {}


def to_device(array, device):
    """The tensor on ``device`` holding numpy ``array``, cached by the
    array's identity: a source payload crosses to the device once and is
    shared by every later tile.  The entry goes when the array does.
    Twins treat the result as read-only (on the CPU it may share the
    array's memory)."""
    device = torch.device(device)
    key = (id(array), str(device))
    entry = _RESIDENT.get(key)
    if entry is not None and entry[0]() is array:
        return entry[1]
    if device.type == "cpu" and array.flags.writeable:
        tensor = torch.from_numpy(np.ascontiguousarray(array))
    else:
        tensor = torch.tensor(np.ascontiguousarray(array), device=device)
    try:
        ref = weakref.ref(array, lambda _ref: _RESIDENT.pop(key, None))
    except TypeError:
        return tensor  # not weak-referenceable: not cached
    _RESIDENT[key] = (ref, tensor)
    return tensor


def _source_stage(process_kwargs):
    """Per tile, on the host: a cross-CRS vals request gets its float64
    coarse index grid (ops/warp.py) in place of the planner's float32
    ``warp_grid``."""
    raster_data = process_kwargs["raster_data"]
    if (
        get_projection(raster_data.projection).upper()
        == get_projection(process_kwargs["projection"]).upper()
    ):
        return (process_kwargs,)
    grid = coarse_index_grid(
        tuple(raster_data.geo_transform),
        raster_data.projection,
        process_kwargs["bbox"],
        process_kwargs["projection"],
        process_kwargs["width"],
        process_kwargs["height"],
        approx_stride(),
    )
    return (dict(process_kwargs, warp_grid=grid),)


def _source_process_torch(process_kwargs):
    """Batch-first twin of RasterSourceBase.process for the vals path:
    ``raster_data.array`` is the resident tensor, ``bbox`` (B, 4) and
    ``warp_grid`` (B, 2, ch, cw, from ``_source_stage``) are per-tile
    tensors."""
    raster_data = process_kwargs["raster_data"]
    bands = process_kwargs["bands"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = dtype.type(process_kwargs["fillvalue"]).item()
    result = warp_torch(
        raster_data.array[bands[0] : bands[1]],
        tuple(raster_data.geo_transform),
        raster_data.projection,
        raster_data.no_data_value,
        process_kwargs["bbox"],
        process_kwargs["projection"],
        process_kwargs["width"],
        process_kwargs["height"],
        dtype,
        fillvalue,
        interpolation=config.get("geomodeling.warp-interpolation", "nearest"),
        coarse_grid=process_kwargs.get("warp_grid"),
    )
    if dtype.kind == "f":
        result = torch.where(torch.isfinite(result), result, fillvalue)
    return {"values": result, "no_data_value": fillvalue}


register(
    RasterSourceBase.process,
    _source_process_torch,
    capable=_source_jax_capable,
    stage=_source_stage,
)
