"""Elementwise math twins, generated from each process's ``np_func``.

Counterpart of dask_geomodeling_tpu/raster/elemwise.py:wrap_math_process_func
and its ``jax_impl``: nodata propagates from any raster operand, the
operands are cast to the block's dtype before the op (numpy's
``ufunc(..., dtype=)``), and non-finite results become the fill.
"""
import numpy as np
import torch

from dask_geomodeling_tpu.raster.elemwise import Add, Multiply, Subtract
from dask_geomodeling_tpu_torch.device import equal_scalar, torch_dtype
from dask_geomodeling_tpu_torch.registry import register

__all__ = ["math_twin"]


def _operand(arg, dtype, device):
    """A compute operand cast to the block's ``dtype`` (numpy)."""
    if isinstance(arg, torch.Tensor):
        return arg.to(torch_dtype(dtype))
    return torch.tensor(np.asarray(arg).astype(dtype), device=device)


def math_twin(process):
    """The batch-first torch twin of a math process function."""
    func = getattr(torch, process.np_func.__name__)

    def twin(process_kwargs, *args):
        if not args or any(a is None for a in args):
            return None
        operands = []
        nodata_mask = None
        for data in args:
            if not isinstance(data, dict):
                operands.append(data)
                continue
            if "time" in data or "meta" in data:
                return data
            if "values" not in data:
                raise TypeError("Cannot apply math function to value {}".format(data))
            values = data["values"]
            operands.append(values)
            if values.dtype != torch.bool and "no_data_value" in data:
                part = equal_scalar(values, data["no_data_value"])
                nodata_mask = part if nodata_mask is None else nodata_mask | part

        # Add/Subtract/Multiply results are never boolean (int32 floor)
        dtype = np.dtype(process_kwargs["dtype"])
        fillvalue = process_kwargs["fillvalue"]
        device = next(a.device for a in operands if isinstance(a, torch.Tensor))
        result = func(*[_operand(a, dtype, device) for a in operands])
        if dtype.kind == "f":
            result = torch.where(torch.isfinite(result), result, fillvalue)
        if nodata_mask is not None:
            result = torch.where(nodata_mask, fillvalue, result)
        return {"no_data_value": fillvalue, "values": result}

    twin.__qualname__ = "math_twin." + process.np_func.__name__
    return twin


for _block in (Add, Subtract, Multiply):
    register(_block.process, math_twin(_block.process))
