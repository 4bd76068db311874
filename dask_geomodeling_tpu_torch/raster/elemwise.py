"""Elementwise math blocks: Add, Subtract, Multiply.

Counterparts of dask_geomodeling_tpu/raster/elemwise.py: ``BaseElementwise``
and ``BaseMath`` with the numpy process generator
(``wrap_math_process_func``), and the torch twin of each process (its
``jax_impl``).  Nodata propagates from any raster operand, the operands
are cast to the block's dtype before the op (numpy's ``ufunc(...,
dtype=)``), and non-finite results become the fill.  Dtypes promote
bool/int to at least int32 and float to at least float32.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import expect_instance
from dask_geomodeling_tpu_torch.device import equal_scalar, torch_dtype
from dask_geomodeling_tpu_torch.geo import GeoTransform, get_dtype_max
from dask_geomodeling_tpu_torch.raster.base import RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["Add", "Subtract", "Multiply"]


class _combined:
    """Descriptor deriving a block attribute by folding the sources' values.

    A single-source block passes its source's attribute straight through
    (via ``single``, identity by default); with several sources the
    per-source values go through ``fold``, whose ``None`` means
    "undefined for this combination of sources".
    """

    def __init__(self, fold, single=None, doc=None):
        self.fold = fold
        self.single = single
        self.__doc__ = doc

    def __set_name__(self, owner, name):
        self.attr = name

    def __get__(self, block, owner=None):
        if block is None:
            return self
        values = [getattr(source, self.attr) for source in block._sources]
        if len(values) == 1:
            return values[0] if self.single is None else self.single(values[0])
        return self.fold(values)


def _when_all(fold):
    """Lift ``fold`` over possibly-missing values: any None wins."""

    def lifted(values):
        if any(value is None for value in values):
            return None
        return fold(values)

    return lifted


def _interval_overlap(periods):
    lo = max(period[0] for period in periods)
    hi = min(period[1] for period in periods)
    return None if hi < lo else (lo, hi)


def _box_overlap(extents):
    x_lo, y_lo = (max(e[axis] for e in extents) for axis in (0, 1))
    x_hi, y_hi = (min(e[axis] for e in extents) for axis in (2, 3))
    if x_hi <= x_lo or y_hi <= y_lo:
        return None
    return (x_lo, y_lo, x_hi, y_hi)


def _common_value(values):
    head = values[0]
    return head if all(value == head for value in values[1:]) else None


def _aligned_grid(grids):
    if any(grid is None for grid in grids):
        return None
    head = GeoTransform(grids[0])
    return head if all(head.aligns_with(g) for g in grids[1:]) else None


#: narrowest result dtype per input-dtype kind (bool/int at least int32,
#: float at least float32)
_DTYPE_FLOOR = {"b": np.int32, "i": np.int32, "u": np.int32, "f": np.float32}


class BaseElementwise(RasterBlock):
    """Base for elementwise blocks; extent/period are intersections of the
    sources', so non-overlapping sources yield an empty block."""

    def __init__(self, *args):
        super().__init__(*args)
        sources = self._sources
        if len(sources) < 2:
            return
        head, rest = sources[0], sources[1:]
        if any(s.temporal != head.temporal for s in rest):
            raise ValueError("Temporal properties of input rasters do not match.")
        delta = head.timedelta
        if head.temporal and delta is not None:
            if any(s.timedelta not in (None, delta) for s in rest):
                raise ValueError("Time resolutions of input rasters are not equal.")

    @property
    def _sources(self):
        return [arg for arg in self.args if isinstance(arg, RasterBlock)]

    def get_sources_and_requests(self, **request):
        period = self.period
        if (
            period is not None
            and request.get("start") is not None
            and request.get("stop") is not None
        ):
            # clamp to the common period so the sources' frames align
            request["start"] = max(request["start"], period[0])
            request["stop"] = min(request["stop"], period[1])

        process_kwargs = {"dtype": self.dtype.name, "fillvalue": self.fillvalue}
        return [(process_kwargs, None)] + [(source, request) for source in self.args]

    timedelta = _combined(
        _when_all(lambda deltas: deltas[0]),
        doc="common time resolution; None for mixed or nontemporal stacks",
    )
    period = _combined(
        _when_all(_interval_overlap), doc="intersection of the sources' periods"
    )
    extent = _combined(
        _when_all(_box_overlap), doc="intersection of the sources' extents"
    )
    projection = _combined(
        _common_value, doc="the shared native projection, if any"
    )
    geo_transform = _combined(
        _aligned_grid,
        single=lambda grid: None if grid is None else GeoTransform(grid),
        doc="the shared native grid when all sources align",
    )

    @property
    def temporal(self):
        return self._sources[0].temporal

    @property
    def dtype(self):
        joint = np.result_type(*self.args)
        floor = _DTYPE_FLOOR.get(joint.kind)
        return joint if floor is None else np.result_type(joint, floor)

    @property
    def fillvalue(self):
        dtype = self.dtype
        return None if dtype == bool else get_dtype_max(dtype)


class BaseMath(BaseElementwise):
    """Elementwise math on two raster-or-number operands."""

    OPERAND_TYPES = (RasterBlock, np.ndarray, float, int)

    def __init__(self, a, b):
        for operand in (a, b):
            expect_instance(operand, self.OPERAND_TYPES, "operand")
        super().__init__(a, b)


def _unpack_math_args(args):
    """Shared pre-processing of the numpy process and its twin: the
    compute operands and the (values, no_data_value) nodata sources.

    Returns None to propagate empties, a dict to short-circuit time/meta,
    or a tuple (compute_args, nodata_parts).
    """
    compute_args = []
    mask_parts = []
    for data in args:
        if data is None:
            return None
        if not isinstance(data, dict):
            compute_args.append(data)
            continue
        if "time" in data or "meta" in data:
            return data
        if "values" not in data:
            raise TypeError("Cannot apply math function to value {}".format(data))
        values = data["values"]
        compute_args.append(values)
        # booleans carry no nodata; frames without one contribute no mask
        is_bool = values.dtype == (
            torch.bool if isinstance(values, torch.Tensor) else np.dtype("bool")
        )
        if not is_bool and "no_data_value" in data:
            mask_parts.append((values, data["no_data_value"]))
    return compute_args, mask_parts


class _FunctionNamespace:
    """Pickle anchor: the generated process functions register here under
    their ufunc name, so their dotted ``__qualname__`` resolves."""


elemwise = _FunctionNamespace()


def wrap_math_process_func(func):
    """Build a process function applying numpy ``func`` to the data values
    only (nodata propagates), and register its torch twin.  The port's
    three ops (add, subtract, multiply) never give a boolean result."""

    def math_process_func(process_kwargs, *args):
        if not args:
            return None
        unpacked = _unpack_math_args(args)
        if unpacked is None or isinstance(unpacked, dict):
            return unpacked
        compute_args, mask_parts = unpacked

        nodata_mask = None
        for values, no_data_value in mask_parts:
            part = values == no_data_value
            nodata_mask = part if nodata_mask is None else (nodata_mask | part)

        dtype = np.dtype(process_kwargs["dtype"])
        fillvalue = process_kwargs["fillvalue"]
        with np.errstate(all="ignore"):
            result_values = func(*compute_args, dtype=dtype)

        # one combined fill write: non-finite results and input-nodata cells
        bad = ~np.isfinite(result_values)
        if nodata_mask is not None:
            bad |= nodata_mask
        result_values[bad] = fillvalue
        return {"no_data_value": fillvalue, "values": result_values}

    torch_func = getattr(torch, func.__name__)

    def math_twin(process_kwargs, *args):
        if not args:
            return None
        unpacked = _unpack_math_args(args)
        if unpacked is None or isinstance(unpacked, dict):
            return unpacked
        compute_args, mask_parts = unpacked

        nodata_mask = None
        for values, no_data_value in mask_parts:
            part = equal_scalar(values, no_data_value)
            nodata_mask = part if nodata_mask is None else nodata_mask | part

        dtype = np.dtype(process_kwargs["dtype"])
        fillvalue = process_kwargs["fillvalue"]
        device = next(a.device for a in compute_args if isinstance(a, torch.Tensor))
        result = torch_func(*[_operand(a, dtype, device) for a in compute_args])
        if dtype.kind == "f":
            result = torch.where(torch.isfinite(result), result, fillvalue)
        if nodata_mask is not None:
            result = torch.where(nodata_mask, fillvalue, result)
        return {"no_data_value": fillvalue, "values": result}

    math_process_func.__name__ = func.__name__
    math_process_func.__qualname__ = "elemwise." + func.__name__
    math_twin.__qualname__ = "math_twin." + func.__name__
    setattr(elemwise, func.__name__, math_process_func)
    # numeric operands are stacked per tile, one scalar a tile
    math_process_func.torch_dynamic = {"__scalars__"}
    register(math_process_func, math_twin)
    return math_process_func


def _operand(arg, dtype, device):
    """A compute operand cast to the block's ``dtype`` (numpy's
    ``ufunc(..., dtype=)`` promotes before computing)."""
    if isinstance(arg, torch.Tensor):
        return arg.to(torch_dtype(dtype))
    return torch.tensor(np.asarray(arg).astype(dtype), device=device)


class Add(BaseMath):
    """Add two rasters or a raster and a constant (nodata-propagating)."""

    process = staticmethod(wrap_math_process_func(np.add))


class Subtract(BaseMath):
    """Subtract two rasters or a constant from a raster."""

    process = staticmethod(wrap_math_process_func(np.subtract))


class Multiply(BaseMath):
    """Multiply two rasters or a raster by a constant."""

    process = staticmethod(wrap_math_process_func(np.multiply))
