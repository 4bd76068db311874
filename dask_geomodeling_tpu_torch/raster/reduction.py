"""Reductions over stacks of rasters: ``reduce_rasters``, Max, and the
torch twin of both.

Counterparts of dask_geomodeling_tpu/raster/reduction.py.  The numpy
``reduce_rasters`` is copied; its twin ``reduce_rasters_torch`` follows it,
not the JAX package's ``reduce_rasters_jax``, wherever the two differ:

- the stack is lifted to ``result_type(dtype, float16)`` as numpy lifts
  it (the JAX twin lifts to at least float32, so a float16 or uint8 stack
  reduces in another precision there);
- sums follow numpy's pairwise summation (``pairwise_sum`` in its add
  loop, which the reduction over the stack axis reaches because
  ``stacked[:, some_data]`` lays each cell's layers out contiguously),
  products multiply the layers in stack order, both accumulating a
  float16 stack in float32 as numpy's half loops do, and a mean or
  variance divides in float64 before rounding to the stack's dtype, as
  numpy's ``_divide_by_count`` does;
- the median averages the two middle values (``torch.nanmedian`` takes
  the lower one), and ``p<n>`` interpolates with numpy's linear method in
  the stack's dtype.

Every statistic is served on the device.  A twin takes batch-first
(B, bands, h, w) values; the statistics work per cell, so the batch axis
changes nothing.
"""
import functools
from functools import partial

import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import expect_instance
from dask_geomodeling_tpu_torch.device import data_mask, numpy_dtype, torch_dtype
from dask_geomodeling_tpu_torch.geo import (
    Extent,
    filter_none,
    get_index,
    parse_percentile_statistic,
)
from dask_geomodeling_tpu_torch.raster.base import RasterBlock
from dask_geomodeling_tpu_torch.raster.elemwise import BaseElementwise
from dask_geomodeling_tpu_torch.registry import register

__all__ = [
    "Max",
    "reduce_rasters",
    "reduce_rasters_torch",
    "check_statistic",
    "STATISTICS",
]

STATISTICS = {
    "first": None,
    "last": None,
    "count": None,
    "sum": np.nansum,
    "mean": np.nanmean,
    "min": np.nanmin,
    "max": np.nanmax,
    "argmin": np.nanargmin,
    "argmax": np.nanargmax,
    "std": np.nanstd,
    "var": np.nanvar,
    "median": np.nanmedian,
    "product": np.nanprod,
    # "p<number>" uses np.nanpercentile
}


def check_statistic(statistic):
    """Raise ValueError for statistics outside STATISTICS / p<number>."""
    if statistic not in STATISTICS:
        statistic, percentile = parse_percentile_statistic(statistic)
        if percentile is None:
            raise ValueError('Unknown statistic "{}"'.format(statistic))


def _overwrite_with_data(out, layers):
    """Later layers overwrite earlier ones wherever they hold data."""
    for layer in layers:
        has_data = get_index(layer["values"], layer["no_data_value"])
        out[has_data] = layer["values"][has_data]
    return out


def _nan_stacked(layers, shape, dtype):
    """Stack layers into one float array with nodata translated to NaN."""
    lifted = np.result_type(dtype, np.float16)  # must be able to hold NaN
    stacked = np.full((len(layers),) + shape, np.nan, lifted)
    for axis0, layer in enumerate(layers):
        has_data = get_index(layer["values"], layer["no_data_value"])
        stacked[axis0, has_data] = layer["values"][has_data]
    return stacked


def _parse(statistic):
    """``(statistic, percentile or None)``; KeyError for unknown names."""
    percentile = None
    if statistic not in STATISTICS:
        statistic, percentile = parse_percentile_statistic(statistic)
        if percentile is None:
            raise KeyError('Unknown statistic "{}"'.format(statistic))
    return statistic, percentile


def reduce_rasters(stack, statistic, no_data_value=None, dtype=None):
    """Apply a nodata-skipping statistic along a stack of raster dicts.

    Args:
      stack (list of dicts): each with "values" and "no_data_value"; all
        values must share one shape
      statistic (str): one of STATISTICS or "p<number>"
      no_data_value (number): output nodata; defaults to the first element's
      dtype: output dtype; defaults to the first element's
    """
    statistic, percentile = _parse(statistic)

    if len(stack) == 0:
        raise ValueError("Cannot reduce a zero-length stack")

    if dtype is None:
        dtype = stack[0]["values"].dtype
    if no_data_value is None:
        no_data_value = stack[0]["no_data_value"]
    shape = stack[0]["values"].shape

    # sum and count never produce nodata: their neutral fill is zero
    fill = 0 if statistic in {"sum", "count"} else no_data_value
    out = np.full(shape, fill, dtype)

    if statistic == "last":
        return {
            "values": _overwrite_with_data(out, stack),
            "no_data_value": no_data_value,
        }
    if statistic == "first":
        return {
            "values": _overwrite_with_data(out, stack[::-1]),
            "no_data_value": no_data_value,
        }
    if statistic == "count":
        for layer in stack:
            out += get_index(layer["values"], layer["no_data_value"])
        return {"values": out, "no_data_value": no_data_value}

    if statistic == "percentile":
        reducer = partial(np.nanpercentile, q=percentile)
    else:
        reducer = STATISTICS[statistic]
    stacked = _nan_stacked(stack, shape, dtype)
    some_data = ~np.all(np.isnan(stacked), axis=0)
    out[some_data] = reducer(stacked[:, some_data], axis=0)
    return {"values": out, "no_data_value": no_data_value}


# --- the torch twin ---


#: numpy's PW_BLOCKSIZE: pairwise sums split blocks longer than this
_PAIRWISE_BLOCK = 128


def _pairwise(layers):
    """numpy's ``pairwise_sum`` over a list of tensors: up to 7 terms one
    by one from zero, up to 128 in eight interleaved partial sums, longer
    ones as the sum of two halves cut at a multiple of eight."""
    n = len(layers)
    if n < 8:
        total = torch.zeros_like(layers[0])
        for layer in layers:
            total = total + layer
        return total
    if n <= _PAIRWISE_BLOCK:
        partial_sums = list(layers[:8])
        i = 8
        while i < n - n % 8:
            partial_sums = [r + layer for r, layer in zip(partial_sums, layers[i : i + 8])]
            i += 8
        r = partial_sums
        total = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for layer in layers[i:]:
            total = total + layer
        return total
    half = n // 2
    half -= half % 8
    return _pairwise(layers[:half]) + _pairwise(layers[half:])


def _accumulator(dtype):
    """numpy's half loops accumulate a reduction in float32."""
    return torch.float32 if dtype == torch.float16 else dtype


def _sum(layers):
    dtype = layers[0].dtype
    return _pairwise([layer.to(_accumulator(dtype)) for layer in layers]).to(dtype)


def _product(layers):
    dtype = layers[0].dtype
    total = layers[0].to(_accumulator(dtype))
    for layer in layers[1:]:
        total = total * layer.to(total.dtype)
    return total.to(dtype)


def _divide_by_count(total, count):
    """numpy's ``_divide_by_count`` for a float total and an integer count:
    the division runs in float64 and rounds to the total's dtype."""
    return (total.to(torch.float64) / count.to(torch.float64)).to(total.dtype)


def _sorted_with_counts(stacked):
    """The stack sorted along the layers with NaN last (as +inf, numpy's
    masked sort fill), and each cell's number of data layers."""
    count = (~torch.isnan(stacked)).sum(0)
    ordered = torch.where(torch.isnan(stacked), torch.inf, stacked).sort(0).values
    return ordered, count


def _take(ordered, index):
    """``ordered[index]`` per cell; cells without data (index -1) take
    layer 0, which the caller discards."""
    return ordered.gather(0, index.clamp(min=0)[None])[0]


def _median(stacked):
    """numpy's masked-array median: the two middle data values, added and
    halved in the stack's dtype (one value twice for an odd count)."""
    ordered, count = _sorted_with_counts(stacked)
    high = count // 2
    low = torch.where(count % 2 == 1, high, high - 1)
    return (_take(ordered, low) + _take(ordered, high)) / 2


def _percentile(stacked, percentile):
    """``np.nanpercentile`` with the linear method, cell by cell: the
    quantile and the virtual index are in the stack's dtype, as numpy
    computes them for a float array."""
    dtype = numpy_dtype(stacked.dtype)
    ordered, count = _sorted_with_counts(stacked)
    quantile = np.true_divide(percentile, dtype.type(100))
    last = (count - 1).to(stacked.dtype)
    virtual = last * float(quantile)
    below = torch.floor(virtual)
    above_bounds = virtual >= last
    previous = torch.where(above_bounds, count - 1, below.to(torch.int64))
    following = torch.where(above_bounds, count - 1, below.to(torch.int64) + 1)
    # gamma against the index numpy ends with (-1 past the end), in float64
    index_used = torch.where(above_bounds, -1, below.to(torch.int64))
    gamma = (virtual.to(torch.float64) - index_used.to(torch.float64)).to(stacked.dtype)
    a, b = _take(ordered, previous), _take(ordered, following)
    diff = b - a
    result = a + diff * gamma
    return torch.where(gamma >= 0.5, b - diff * (1 - gamma), result)


def _variance(stacked, add=_sum):
    data = ~torch.isnan(stacked)
    count = data.sum(0)
    layers = torch.where(data, stacked, 0).unbind(0)
    mean = _divide_by_count(add(layers), count)
    deviations = [torch.where(d, layer - mean, 0) for d, layer in zip(data.unbind(0), layers)]
    return _divide_by_count(add([d * d for d in deviations]), count)


def _arg_extreme(stacked, largest):
    replaced = torch.where(torch.isnan(stacked), -torch.inf if largest else torch.inf, stacked)
    return replaced.argmax(0) if largest else replaced.argmin(0)


def _nan_reduce(stacked, statistic, percentile, add=_sum):
    """The statistic over the layer axis of ``stacked`` (NaN = no data),
    in the stack's dtype; only cells with data are used.  ``add`` sums a
    list of layers (numpy's pairwise order by default)."""
    nan = torch.isnan(stacked)
    if statistic == "sum":
        return add(torch.where(nan, 0, stacked).unbind(0))
    if statistic == "product":
        return _product(torch.where(nan, 1, stacked).unbind(0))
    if statistic == "mean":
        return _divide_by_count(add(torch.where(nan, 0, stacked).unbind(0)), (~nan).sum(0))
    if statistic in ("min", "max"):
        return functools.reduce(torch.fmin if statistic == "min" else torch.fmax, stacked.unbind(0))
    if statistic in ("argmin", "argmax"):
        return _arg_extreme(stacked, statistic == "argmax")
    if statistic == "var":
        return _variance(stacked, add)
    if statistic == "std":
        # numpy's sqrt is correctly rounded, torch's on the CPU is not
        # always; float64 holds a float32 or float16 square root exactly
        # enough to round it right
        variance = _variance(stacked, add)
        return torch.sqrt(variance.to(torch.float64)).to(variance.dtype)
    if statistic == "median":
        return _median(stacked)
    if statistic == "percentile":
        return _percentile(stacked, percentile)
    raise KeyError('Unknown statistic "{}"'.format(statistic))


def reduce_rasters_torch(stack, statistic, no_data_value=None, dtype=None):
    """Twin of :func:`reduce_rasters` over batch-first tensors, for every
    statistic, bitwise where the arithmetic allows it (module docstring)."""
    statistic, percentile = _parse(statistic)
    if len(stack) == 0:
        raise ValueError("Cannot reduce a zero-length stack")
    first = stack[0]["values"]
    dtype = np.dtype(numpy_dtype(first.dtype) if dtype is None else dtype)
    if no_data_value is None:
        no_data_value = stack[0]["no_data_value"]
    fill = 0 if statistic in {"sum", "count"} else no_data_value
    # np.full's conversion of the fill (None becomes False for booleans)
    fill = np.full((), fill, dtype)[()]
    out = torch.full(first.shape, fill.item(), dtype=torch_dtype(dtype), device=first.device)
    masks = [data_mask(layer["values"], layer["no_data_value"]) for layer in stack]

    if statistic in ("first", "last"):
        order = zip(masks, stack) if statistic == "last" else zip(masks[::-1], stack[::-1])
        for has_data, layer in order:
            out = torch.where(has_data, layer["values"].to(out.dtype), out)
        return {"values": out, "no_data_value": no_data_value}
    if statistic == "count":
        for has_data in masks:
            out = out + has_data.to(out.dtype)
        return {"values": out, "no_data_value": no_data_value}

    lifted = torch_dtype(np.result_type(dtype, np.float16))
    stacked = torch.stack(
        [
            torch.where(has_data, layer["values"].to(lifted), torch.nan)
            for has_data, layer in zip(masks, stack)
        ]
    )
    some_data = ~torch.isnan(stacked).all(0)  # a NaN data value counts as none
    reduced = _nan_reduce(stacked, statistic, percentile)
    out = torch.where(some_data, reduced.to(out.dtype), out)
    return {"values": out, "no_data_value": no_data_value}


class BaseReduction(BaseElementwise):
    """Base for reductions over multiple rasters; extent is the union."""

    def __init__(self, *args):
        for arg in args:
            expect_instance(arg, RasterBlock, "arg")
        super().__init__(*args)

    def get_sources_and_requests(self, **request):
        period = self.period
        process_kwargs = {"dtype": self.dtype.name, "fillvalue": self.fillvalue}
        if period is None:
            return [(process_kwargs, None)]

        start = request.get("start", None)
        stop = request.get("stop", None)
        if start is not None:
            if stop is not None:
                request["start"] = max(start, period[0])
                request["stop"] = min(stop, period[1])
            else:
                request["start"] = min(max(start, period[0]), period[1])
        else:
            request["start"] = period[1]

        return [(process_kwargs, None)] + [
            (source, request) for source in self.args
        ]

    @property
    def extent(self):
        extents = filter_none([x.extent for x in self.args])
        if not extents:
            return None
        if len(extents) == 1:
            return extents[0]
        x1, y1 = (min(e[axis] for e in extents) for axis in (0, 1))
        x2, y2 = (max(e[axis] for e in extents) for axis in (2, 3))
        return x1, y1, x2, y2

    @property
    def footprint(self):
        footprints = filter_none([x.footprint for x in self.args])
        if not footprints:
            return None
        return functools.reduce(Extent.union, footprints)


class _FunctionNamespace:
    """Pickle anchor for factory-made reduction process functions (see
    elemwise._FunctionNamespace)."""


reduction = _FunctionNamespace()


def _stack_of(args):
    """The frames of a reduction's args; a time/meta response passes
    through as it is, and no frame at all gives None."""
    stack = []
    for arg in args:
        if arg is None:
            continue
        if "time" in arg or "meta" in arg:
            return arg
        stack.append(arg)
    return stack or None


def wrap_reduction_function(statistic):
    """Build the nodata-skipping process function for one statistic, and
    register its twin."""

    def reduction_function(process_kwargs, *args):
        stack = _stack_of(args)
        if not isinstance(stack, list):
            return stack
        return reduce_rasters(
            stack, statistic, process_kwargs["fillvalue"], process_kwargs["dtype"]
        )

    def reduction_twin(process_kwargs, *args):
        stack = _stack_of(args)
        if not isinstance(stack, list):
            return stack
        return reduce_rasters_torch(
            stack, statistic, process_kwargs["fillvalue"], process_kwargs["dtype"]
        )

    reduction_function.__name__ = "reduce_" + statistic
    reduction_function.__qualname__ = "reduction.reduce_" + statistic
    reduction_twin.__qualname__ = "reduction_twin.reduce_" + statistic
    setattr(reduction, "reduce_" + statistic, reduction_function)
    register(reduction_function, reduction_twin)
    return reduction_function


class Max(BaseReduction):
    """Maximum of two or more rasters, ignoring nodata."""

    process = staticmethod(wrap_reduction_function("max"))

    @property
    def dtype(self):
        # unlike elementwise math, reductions keep the input dtype
        return np.result_type(*self.args)
