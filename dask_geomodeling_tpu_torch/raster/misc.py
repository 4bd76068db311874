"""Classify and Reclassify: blocks, numpy processes and torch twins.

Counterparts of dask_geomodeling_tpu/raster/misc.py (``Classify``,
``Reclassify``, ``_classify_process``, ``_reclassify_lookup``,
``_reclassify_process`` and their twins).  ``torch.searchsorted`` wants
the boundaries and the values in one dtype, so the twins cast both to
numpy's common type first, the type numpy's own searchsorted compares in:
float32 values against float bins compare in float64, int64 values
against int bins stay int64.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import arg, expect_instance
from dask_geomodeling_tpu_torch.device import equal_scalar, numpy_dtype, torch_dtype
from dask_geomodeling_tpu_torch.geo import get_dtype_max, get_uint_dtype
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["Classify", "Reclassify"]


def _classify_process(data, bins, right):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    dtype = get_uint_dtype(len(bins) + 2)
    fillvalue = get_dtype_max(dtype)
    result_values = np.digitize(values, bins, right).astype(dtype)
    result_values[values == data["no_data_value"]] = fillvalue
    return {"values": result_values, "no_data_value": fillvalue}


class Classify(BaseSingle):
    """Classify values into bins given by increasing edges; the output is
    the bin index (0 = below the first edge)."""

    def __init__(self, store, bins, right=False):
        expect_instance(store, RasterBlock, "store")
        if not hasattr(bins, "__iter__"):
            raise TypeError(
                "bins must be an iterable of edges, got '%s'"
                % type(bins).__name__
            )
        edges = np.asarray(bins)
        for ok, message in (
            (edges.ndim == 1, "'bins' should be one-dimensional"),
            (np.issubdtype(edges.dtype, np.number), "'bins' should be numeric"),
        ):
            if not ok:
                raise TypeError(message)
        steps = np.diff(edges)
        if np.all(steps < 0) or not np.all(steps > 0):
            raise TypeError("'bins' should be monotonic")
        super().__init__(store, edges.tolist(), right)

    bins = arg(1)
    right = arg(2)

    @property
    def dtype(self):
        return get_uint_dtype(len(self.bins) + 2)

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)

    process = staticmethod(_classify_process)


def _reclassify_table(data):
    source, target = zip(*data)
    return np.asarray(source), np.asarray(target)


def _reclassify_lookup(process_kwargs, no_data_value):
    """Sorted (source, target) lookup arrays, with the store's nodata
    sentinel mapped onto the output fill; shared by process and twin."""
    source, target = _reclassify_table(process_kwargs["data"])
    if no_data_value is not None and no_data_value not in source:
        source = np.append(source, no_data_value)
        target = np.append(target, process_kwargs["fillvalue"])
    order = np.argsort(source)
    return source[order], target[order]


def _reclassify_process(store_data, process_kwargs):
    """Table lookup: searchsorted into the sorted source alphabet, then a
    hit test (a miss past either end lands on a non-equal slot).  Missed
    cells keep their value, or become the fill when ``select``."""
    if store_data is None or "values" not in store_data:
        return store_data
    values = store_data["values"]
    dtype = np.dtype(process_kwargs["dtype"])
    fill = process_kwargs["fillvalue"]
    source, target = _reclassify_lookup(
        process_kwargs, store_data["no_data_value"]
    )

    slots = np.minimum(np.searchsorted(source, values), len(source) - 1)
    hit = source[slots] == values
    base = (
        np.full(values.shape, fill, dtype)
        if process_kwargs["select"]
        else values.astype(dtype)
    )
    result = np.where(hit, target[slots].astype(dtype), base)
    return {"values": result, "no_data_value": fill}


class Reclassify(BaseSingle):
    """Reclassify integer/boolean rasters via [from, to] pairs; with
    ``select`` unmapped cells become nodata."""

    def __init__(self, store, data, select=False):
        dtype = store.dtype
        if dtype != bool and not np.issubdtype(dtype, np.integer):
            raise TypeError("The store must be of boolean or integer datatype")

        if not hasattr(data, "__iter__"):
            raise TypeError(
                "data must be an iterable of [from, to] pairs, got '%s'"
                % type(data).__name__
            )
        try:
            source, target = _reclassify_table(data)
        except ValueError:
            raise ValueError("Please supply a list of [from, to] values")
        if source.dtype != bool and not np.issubdtype(source.dtype, np.integer):
            raise TypeError(
                "Cannot reclassify from value with type '{}'".format(source.dtype)
            )
        if len(np.unique(source)) != len(source):
            raise ValueError("There are duplicates in the reclassify values")
        if not np.issubdtype(target.dtype, np.number):
            raise TypeError(
                "Cannot reclassify to value with type '{}'".format(target.dtype)
            )
        data = [list(x) for x in zip(source.tolist(), target.tolist())]

        if select is not True and select is not False:
            raise TypeError(
                "select must be a bool, got '%s'" % type(select).__name__
            )
        super().__init__(store, data, select)

    data = arg(1)
    select = arg(2)

    @property
    def dtype(self):
        _, target = _reclassify_table(self.data)
        return target.dtype

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)

    def get_sources_and_requests(self, **request):
        process_kwargs = {
            "dtype": self.dtype.str,
            "fillvalue": self.fillvalue,
            "data": self.data,
            "select": self.select,
        }
        return [(self.store, request), (process_kwargs, None)]

    process = staticmethod(_reclassify_process)


# --- torch twins ---


def _common(sorted_array, values):
    """(boundaries tensor, values tensor) in numpy's common dtype."""
    common = np.result_type(sorted_array.dtype, numpy_dtype(values.dtype))
    boundaries = torch.from_numpy(sorted_array.astype(common)).to(values.device)
    return boundaries, values.to(torch_dtype(common)).contiguous()


def _classify_torch(data, bins, right):
    if data is None or "values" not in data:
        return data
    values = data["values"]
    dtype = get_uint_dtype(len(bins) + 2)
    fillvalue = get_dtype_max(dtype)
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
