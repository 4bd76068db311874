"""Elementwise blocks: math, comparisons, logic, FillNoData, Exp/Log.

Counterparts of dask_geomodeling_tpu/raster/elemwise.py: the blocks, the
numpy process generator (``wrap_math_process_func``) and the torch twin of
each process (its ``jax_impl``).  Nodata propagates from any raster
operand; math casts the operands to the block's dtype before the op
(numpy's ``ufunc(..., dtype=)``) and non-finite results become the fill;
comparisons and logic give booleans without nodata (a nodata cell
compares False, or True for NotEqual), computed in numpy's common dtype
of the operands.  Dtypes promote bool/int to at least int32 and float to
at least float32; Divide, Exp and Log to at least float32.
"""
import numpy as np
import torch

from dask_geomodeling_tpu_torch.core import expect_instance
from dask_geomodeling_tpu_torch.device import (
    COMPARISONS,
    as_operand,
    common_dtype,
    compare,
    data_mask,
    equal_scalar,
    torch_dtype,
)
from dask_geomodeling_tpu_torch.geo import GeoTransform, get_dtype_max, get_index
from dask_geomodeling_tpu_torch.raster.base import BaseSingle, RasterBlock
from dask_geomodeling_tpu_torch.registry import register

__all__ = [
    "Add",
    "Subtract",
    "Multiply",
    "Divide",
    "Power",
    "FillNoData",
    "Equal",
    "NotEqual",
    "Greater",
    "GreaterEqual",
    "Less",
    "LessEqual",
    "Invert",
    "And",
    "Or",
    "Xor",
    "IsData",
    "IsNoData",
    "Exp",
    "Log",
    "Log10",
]


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


def _footprint_overlap(footprints):
    overlap = footprints[0]
    for footprint in footprints[1:]:
        overlap = overlap.intersection(footprint)
        if overlap is None:
            return None
    return overlap


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
    footprint = _combined(
        _when_all(_footprint_overlap),
        doc="intersection of the sources' native footprints",
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


class BaseComparison(BaseMath):
    """Base for raster-vs-raster/constant comparisons (bool results)."""

    @property
    def dtype(self):
        return np.dtype("bool")


class BaseLogic(BaseElementwise):
    """Elementwise logic on two boolean operands."""

    def __init__(self, a, b):
        for operand in (a, b):
            if isinstance(operand, (RasterBlock, np.ndarray)):
                if operand.dtype != np.dtype("bool"):
                    raise TypeError("inputs must have boolean dtypes")
            else:
                expect_instance(operand, bool, "operand")
        super().__init__(a, b)

    @property
    def dtype(self):
        return np.dtype("bool")

    @property
    def fillvalue(self):
        return None


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


#: numpy ufunc name -> torch function, where the names differ
_TORCH_FUNCS = {"power": torch.pow, "equal": torch.eq}


def wrap_math_process_func(func):
    """Build a process function applying numpy ``func`` to the data values
    only (nodata propagates; a boolean result maps nodata to False, to
    True for ``np.not_equal``), and register its torch twin."""

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

        if dtype == np.dtype("bool"):
            no_data_value = None
            fillvalue = func is np.not_equal
            func_kwargs = {}
        else:
            func_kwargs = {"dtype": dtype}
            no_data_value = fillvalue

        with np.errstate(all="ignore"):
            result_values = func(*compute_args, **func_kwargs)

        # one combined fill write: non-finite results and input-nodata cells
        bad = ~np.isfinite(result_values)
        if nodata_mask is not None:
            bad |= nodata_mask
        result_values[bad] = fillvalue
        return {"no_data_value": no_data_value, "values": result_values}

    name = func.__name__
    torch_func = _TORCH_FUNCS.get(name) or getattr(torch, name)

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
        if dtype == np.dtype("bool"):
            no_data_value = None
            fillvalue = func is np.not_equal
            if len(compute_args) == 2 and name in COMPARISONS:
                result = compare(name, *compute_args)
            else:  # logic: numpy computes in the operands' common dtype
                common = common_dtype(*compute_args)
                result = torch_func(*[as_operand(a, common, device) for a in compute_args])
        else:
            no_data_value = fillvalue
            result = torch_func(*[as_operand(a, dtype, device) for a in compute_args])
            if dtype.kind == "f":
                result = torch.where(torch.isfinite(result), result, fillvalue)
        if nodata_mask is not None:
            result = torch.where(nodata_mask, fillvalue, result)
        return {"no_data_value": no_data_value, "values": result}

    math_process_func.__name__ = name
    math_process_func.__qualname__ = "elemwise." + name
    math_twin.__qualname__ = "math_twin." + name
    setattr(elemwise, name, math_process_func)
    register(math_process_func, math_twin)
    return math_process_func


class Add(BaseMath):
    """Add two rasters or a raster and a constant (nodata-propagating)."""

    process = staticmethod(wrap_math_process_func(np.add))


class Subtract(BaseMath):
    """Subtract two rasters or a constant from a raster."""

    process = staticmethod(wrap_math_process_func(np.subtract))


class Multiply(BaseMath):
    """Multiply two rasters or a raster by a constant."""

    process = staticmethod(wrap_math_process_func(np.multiply))


class Divide(BaseMath):
    """Divide two rasters or a raster by a constant; result >= float32."""

    process = staticmethod(wrap_math_process_func(np.divide))

    @property
    def dtype(self):
        return np.result_type(np.float32, *self.args)


class Power(BaseMath):
    """Raise a raster to a power (or a power raster)."""

    process = staticmethod(wrap_math_process_func(np.power))

    def __init__(self, a, b):
        # negative integer exponents fail for integer bases; cast to float
        if isinstance(b, int) and b < 0:
            b = float(b)
        super().__init__(a, b)


class Equal(BaseComparison):
    """a == b; nodata compares as False."""

    process = staticmethod(wrap_math_process_func(np.equal))


class NotEqual(BaseComparison):
    """a != b; nodata compares as True."""

    process = staticmethod(wrap_math_process_func(np.not_equal))


class Greater(BaseComparison):
    """a > b; nodata compares as False."""

    process = staticmethod(wrap_math_process_func(np.greater))


class GreaterEqual(BaseComparison):
    """a >= b; nodata compares as False."""

    process = staticmethod(wrap_math_process_func(np.greater_equal))


class Less(BaseComparison):
    """a < b; nodata compares as False."""

    process = staticmethod(wrap_math_process_func(np.less))


class LessEqual(BaseComparison):
    """a <= b; nodata compares as False."""

    process = staticmethod(wrap_math_process_func(np.less_equal))


def _invert_process(data):
    if "values" in data:
        return {"values": ~data["values"], "no_data_value": None}
    return data


class Invert(BaseSingle):
    """Logically invert a boolean raster (swap True and False)."""

    def __init__(self, x):
        super().__init__(x)
        if x.dtype != np.dtype("bool"):
            raise TypeError("input block must have boolean dtype")

    process = staticmethod(_invert_process)

    @property
    def dtype(self):
        return np.dtype("bool")


def _is_data_process(data):
    if data is None or "values" not in data:
        return data
    return {
        "values": data["values"] != data["no_data_value"],
        "no_data_value": None,
    }


def _is_no_data_process(data):
    if data is None or "values" not in data:
        return data
    return {
        "values": data["values"] == data["no_data_value"],
        "no_data_value": None,
    }


def _is_data_torch(data):
    if data is None or "values" not in data:
        return data
    return {
        "values": compare("not_equal", data["values"], data["no_data_value"]),
        "no_data_value": None,
    }


def _is_no_data_torch(data):
    if data is None or "values" not in data:
        return data
    return {
        "values": equal_scalar(data["values"], data["no_data_value"]),
        "no_data_value": None,
    }


class IsData(BaseSingle):
    """True where the raster has data."""

    def __init__(self, store):
        if store.dtype == np.dtype("bool"):
            raise TypeError("input block must not have boolean dtype")
        super().__init__(store)

    process = staticmethod(_is_data_process)

    @property
    def dtype(self):
        return np.dtype("bool")

    @property
    def fillvalue(self):
        return None


class IsNoData(IsData):
    """True where the raster has no data."""

    process = staticmethod(_is_no_data_process)


class And(BaseLogic):
    """Boolean AND of two boolean rasters/constants."""

    process = staticmethod(wrap_math_process_func(np.logical_and))


class Or(BaseLogic):
    """Boolean OR of two boolean rasters/constants."""

    process = staticmethod(wrap_math_process_func(np.logical_or))


class Xor(BaseLogic):
    """Boolean XOR of two boolean rasters/constants."""

    process = staticmethod(wrap_math_process_func(np.logical_xor))


def _frame_stack(args):
    """Collect (values, no_data_value) pairs from frame dicts.

    A time/meta response short-circuits (returned as-is); missing frames
    are dropped; an all-missing stack collapses to an empty list.
    """
    stack = []
    for data in args:
        if data is None:
            continue
        if "time" in data or "meta" in data:
            return data
        if "values" in data and "no_data_value" in data:
            stack.append((data["values"], data["no_data_value"]))
    return stack


def _fill_no_data_process(process_kwargs, *args):
    stack = _frame_stack(args)
    if isinstance(stack, dict):
        return stack
    if not stack:
        return None
    dtype = process_kwargs["dtype"]
    fillvalue = get_dtype_max(dtype)

    values = np.full(stack[0][0].shape, fillvalue, dtype=dtype)
    for frame, no_data_value in stack:
        index = get_index(frame, no_data_value)
        values[index] = frame[index]
    return {"values": values, "no_data_value": fillvalue}


def _fill_no_data_torch(process_kwargs, *args):
    stack = _frame_stack(args)
    if isinstance(stack, dict):
        return stack
    if not stack:
        return None
    dtype = np.dtype(process_kwargs["dtype"])
    fillvalue = get_dtype_max(dtype)

    first = stack[0][0]
    values = torch.full(first.shape, fillvalue, dtype=torch_dtype(dtype), device=first.device)
    for frame, no_data_value in stack:
        values = torch.where(
            data_mask(frame, no_data_value), frame.to(torch_dtype(dtype)), values
        )
    return {"values": values, "no_data_value": fillvalue}


class FillNoData(BaseElementwise):
    """Combine rasters, filling nodata from left to right (rightmost wins)."""

    def __init__(self, *args):
        for arg in args:
            expect_instance(arg, RasterBlock, "arg")
        super().__init__(*args)

    process = staticmethod(_fill_no_data_process)


class BaseLogExp(BaseSingle):
    """Base for Exp / Log / Log10."""

    def __init__(self, x):
        if x.dtype == np.dtype("bool"):
            raise TypeError("input block must not have boolean dtype")
        super().__init__(x)

    def get_sources_and_requests(self, **request):
        process_kwargs = {"dtype": self.dtype.name, "fillvalue": self.fillvalue}
        return [(process_kwargs, None), (self.args[0], request)]

    @property
    def dtype(self):
        return np.result_type(np.float32, *self.args)

    @property
    def fillvalue(self):
        return get_dtype_max(self.dtype)


class Exp(BaseLogExp):
    """e ** x; out-of-range results become nodata."""

    process = staticmethod(wrap_math_process_func(np.exp))


class Log(BaseLogExp):
    """Natural logarithm; results of x < 0 become nodata."""

    process = staticmethod(wrap_math_process_func(np.log))


class Log10(BaseLogExp):
    """Base-10 logarithm; results of x < 0 become nodata."""

    process = staticmethod(wrap_math_process_func(np.log10))


register(_invert_process, _invert_process)  # ``~`` is the same on a tensor
register(_is_data_process, _is_data_torch)
register(_is_no_data_process, _is_no_data_torch)
register(_fill_no_data_process, _fill_no_data_torch)
