"""The reductions: ``reduce_rasters``, its torch twin, and Max.

Every statistic, ``p<n>`` included, over float16, float32, float64, int32,
uint8 and boolean stacks with nodata holes and NaN data: the port's numpy
``reduce_rasters`` is the JAX package's bit for bit, and its twin
``reduce_rasters_torch`` equals it bitwise, but for std, var and product,
held to ``rtol=1e-6``: torch's square root on the CPU is not always
correctly rounded, and the float16 stacks' accumulation may be scheduled
differently (measured: bitwise on these inputs for every statistic but
float64 std, 1 ulp).

The JAX package's twin ``reduce_rasters_jax`` agrees with numpy on
float32 and float64 stacks for the order-free statistics; on a float16 or
uint8 stack it reduces in float32 where numpy reduces in float16, and its
means, variances and percentiles (and for uint8 its sums and products)
differ from numpy's, which the port follows.
"""
import warnings
from datetime import datetime

import numpy as np
import pytest
import torch

from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu.raster.reduction import reduce_rasters as jax_reduce_rasters
from dask_geomodeling_tpu.raster.reduction import reduce_rasters_jax
from dask_geomodeling_tpu.runtime.executor import _ensure_x64
from dask_geomodeling_tpu_torch.raster.reduction import (
    STATISTICS,
    check_statistic,
    reduce_rasters,
    reduce_rasters_torch,
)
from tests.test_torch_elemwise import assert_views_agree, source

DTYPES = ["float16", "float32", "float64", "int32", "uint8", "bool"]
STATS = sorted(STATISTICS) + ["p0", "p33.3", "p50", "p90", "p100"]
TOLERANT = {"std", "var", "product"}


def _stack(dtype, layers=5, seed=0):
    rng = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    stack = []
    for k in range(layers):
        if dtype == bool:
            stack.append({"values": rng.rand(3, 9, 11) > 0.5, "no_data_value": None})
            continue
        low = 0 if dtype.kind == "u" else -60
        values = (rng.rand(3, 9, 11) * (200 - low) + low).astype(dtype)
        nodata = np.finfo(dtype).max.item() if dtype.kind == "f" else np.iinfo(dtype).max
        values[rng.rand(*values.shape) < 0.35] = nodata
        values[:, 0, :4] = nodata  # cells without any data
        if dtype.kind == "f" and k == 1:
            values[1, 2, 2] = np.nan  # a NaN data value counts as none
        stack.append({"values": values, "no_data_value": nodata})
    return stack


def _fill(dtype):
    dtype = np.dtype(dtype)
    if dtype == bool:
        return None
    return np.finfo(dtype).max.item() if dtype.kind == "f" else np.iinfo(dtype).max


def _numpy(stack, statistic, dtype):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        return reduce_rasters(
            [dict(layer, values=layer["values"].copy()) for layer in stack],
            statistic, _fill(dtype), np.dtype(dtype),
        )


def _torch(stack, statistic, dtype):
    result = reduce_rasters_torch(
        [dict(layer, values=torch.from_numpy(layer["values"])[None]) for layer in stack],
        statistic, _fill(dtype), np.dtype(dtype),
    )
    return dict(result, values=result["values"][0].numpy())


@pytest.mark.parametrize("statistic", STATS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_twin_equals_numpy(dtype, statistic):
    for layers in (1, 4, 9):
        stack = _stack(dtype, layers)
        expected = _numpy(stack, statistic, dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            reference = jax_reduce_rasters(
                [dict(layer, values=layer["values"].copy()) for layer in stack],
                statistic, _fill(dtype), np.dtype(dtype),
            )
        np.testing.assert_array_equal(expected["values"], reference["values"])
        actual = _torch(stack, statistic, dtype)
        assert actual["values"].dtype == expected["values"].dtype
        assert actual["no_data_value"] == expected["no_data_value"]
        if statistic in TOLERANT:
            np.testing.assert_allclose(actual["values"], expected["values"], rtol=1e-6)
        else:
            np.testing.assert_array_equal(actual["values"], expected["values"])


def test_sums_follow_numpys_pairwise_order():
    """Sixteen and a hundred and forty layers: numpy's pairwise summation
    (eight partial sums, then halves) is what the twin reproduces."""
    for layers in (16, 140):
        stack = _stack("float32", layers, seed=3)
        for statistic in ("sum", "mean"):
            np.testing.assert_array_equal(
                _torch(stack, statistic, "float32")["values"],
                _numpy(stack, statistic, "float32")["values"],
            )


@pytest.mark.parametrize("statistic", ["first", "last", "count", "min", "max", "argmin", "median"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_jax_twin_agrees_where_the_order_is_free(dtype, statistic):
    _ensure_x64()
    stack = _stack(dtype)
    expected = _numpy(stack, statistic, dtype)
    jax_result = reduce_rasters_jax(stack, statistic, _fill(dtype), np.dtype(dtype))
    np.testing.assert_array_equal(np.asarray(jax_result["values"]), expected["values"])
    np.testing.assert_array_equal(_torch(stack, statistic, dtype)["values"], expected["values"])


@pytest.mark.parametrize(
    "dtype, statistic",
    [("float16", "mean"), ("float16", "var"), ("float16", "p33.3"), ("uint8", "sum"), ("uint8", "product")],
)
def test_float16_stacks_follow_numpy_not_the_jax_twin(dtype, statistic):
    """numpy lifts a float16 or uint8 stack to float16 only; the JAX twin
    lifts it to float32 and its results differ in many cells (measured:
    61 to 282 of 297).  The port follows numpy."""
    _ensure_x64()
    stack = _stack(dtype, layers=9, seed=5)
    expected = _numpy(stack, statistic, dtype)
    jax_values = np.asarray(reduce_rasters_jax(stack, statistic, _fill(dtype), np.dtype(dtype))["values"])
    assert (jax_values != expected["values"]).sum() > 20
    np.testing.assert_array_equal(_torch(stack, statistic, dtype)["values"], expected["values"])


def test_median_averages_the_two_middle_values():
    stack = [{"values": np.full((1, 1, 1), v, np.float32), "no_data_value": -1.0} for v in (1, 2, 4, 10)]
    assert _numpy(stack, "median", "float32")["values"][0, 0, 0] == 3.0
    assert _torch(stack, "median", "float32")["values"][0, 0, 0] == 3.0
    lower = torch.nanmedian(torch.tensor([1.0, 2.0, 4.0, 10.0]))
    assert lower == 2.0  # what torch.nanmedian would have given


def test_check_statistic():
    for statistic in STATS:
        check_statistic(statistic)
    for bad in ("p101", "mode", "px"):
        with pytest.raises(ValueError):
            check_statistic(bad)


@pytest.mark.parametrize("dtypes", [("float32", "float32", "float32"), ("uint8", "int16", "float32")])
def test_max_block(dtypes):
    view = R.Max(*[source(dtype, seed=i) for i, dtype in enumerate(dtypes)])
    assert_views_agree(view, jax_twin=dtypes[0] == dtypes[1])


def test_max_of_booleans_and_single_frames():
    flags = [R.Greater(source("float32", seed=i), 15.0) for i in range(2)]
    assert_views_agree(R.Max(*flags))
    request = dict(mode="vals", bbox=(135000.0, 455984.0, 135020.0, 456000.0),
                   projection="EPSG:28992", width=20, height=16, start=datetime(2000, 1, 1))
    assert_views_agree(R.Max(source("float64", bands=1), source("float32", seed=1, bands=1)), request)
