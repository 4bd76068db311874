"""Classify and Reclassify twins.

Counterparts of dask_geomodeling_tpu/raster/misc.py:_classify_jax and
_reclassify_jax.  ``torch.searchsorted`` wants the boundaries and the
values in one dtype, so both are cast to numpy's common type first, the
type numpy's own searchsorted compares in: float32 values against float
bins compare in float64, int64 values against int bins stay int64.
"""
import numpy as np
import torch

from dask_geomodeling_tpu import utils
from dask_geomodeling_tpu.raster.misc import (
    _classify_process,
    _reclassify_lookup,
    _reclassify_process,
)
from dask_geomodeling_tpu_torch.device import (
    equal_scalar,
    numpy_dtype,
    torch_dtype,
)
from dask_geomodeling_tpu_torch.registry import register

__all__ = []


def _common(sorted_array, values):
    """(boundaries tensor, values tensor) in numpy's common dtype."""
    common = np.result_type(sorted_array.dtype, numpy_dtype(values.dtype))
    boundaries = torch.from_numpy(sorted_array.astype(common)).to(values.device)
    return boundaries, values.to(torch_dtype(common)).contiguous()


def _classify_torch(data, bins, right):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    dtype = utils.get_uint_dtype(len(bins) + 2)
    fillvalue = utils.get_dtype_max(dtype)
    edges, keys = _common(np.asarray(bins), values)
    # np.digitize(x, bins, right=False) is searchsorted(bins, x, side="right")
    index = torch.searchsorted(edges, keys, right=not right)
    index = torch.where(equal_scalar(values, data["no_data_value"]), fillvalue, index)
    return {"values": index.to(torch_dtype(dtype)), "no_data_value": fillvalue}


def _reclassify_torch(store_data, process_kwargs):
    if store_data is None or "values" not in store_data:
        return store_data
    values = store_data["values"]
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = process_kwargs["fillvalue"]
    source, target = _reclassify_lookup(process_kwargs, store_data["no_data_value"])
    source_t, keys = _common(source, values)
    target_t = torch.from_numpy(target.astype(dtype)).to(values.device)

    slots = torch.clamp(torch.searchsorted(source_t, keys), max=len(source) - 1)
    hit = source_t[slots] == keys
    if process_kwargs["select"]:
        base = torch.full(values.shape, fillvalue, dtype=torch_dtype(dtype), device=values.device)
    else:
        base = values.to(torch_dtype(dtype))
    return {"values": torch.where(hit, target_t[slots], base), "no_data_value": fillvalue}


register(_classify_process, _classify_torch)
register(_reclassify_process, _reclassify_torch)
