"""Add, Classify and Reclassify: the port's numpy processes and twins
against the JAX package's numpy processes.

Each case is a two-node compute graph: a host literal holding the input
raster and the port's process node.  ``compute_torch`` moves the raster to
the device, runs the twin batch-first and brings the result back, so the
executor's host/device handoff is exercised too.  The port's copy of the
numpy process is held to the JAX package's as well.  All bitwise.
"""
import numpy as np
import pytest
import torch

from dask_geomodeling_tpu.raster import elemwise as jax_elemwise
from dask_geomodeling_tpu.raster import misc as jax_misc
from dask_geomodeling_tpu_torch.device import equal_scalar
from dask_geomodeling_tpu_torch.raster import elemwise, misc
from dask_geomodeling_tpu_torch.runtime import executor
from dask_geomodeling_tpu_torch.runtime.executor import compute_torch

F32_NODATA = float(np.finfo(np.float32).max)


def _raster(seed, dtype=np.float32, nodata=F32_NODATA, scale=250):
    rng = np.random.RandomState(seed)
    values = (rng.rand(2, 23, 31) * scale).astype(dtype)
    values[:, 4:7, 9:15] = nodata
    return {"values": values, "no_data_value": nodata}


def _copy(arg):
    if isinstance(arg, dict) and "values" in arg:
        return dict(arg, values=arg["values"].copy())
    return arg


def _compare(reference, process, *args):
    """Run the JAX package's ``reference(*args)``, the port's numpy
    ``process(*args)`` and ``process`` through compute_torch; the raster
    args are graph keys of host literals."""
    expected = reference(*[_copy(a) for a in args])
    host = process(*[_copy(a) for a in args])
    assert host["no_data_value"] == expected["no_data_value"]
    assert host["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(host["values"], expected["values"])
    graph = {}
    node = [process]
    host_args = []
    for index, arg in enumerate(args):
        if isinstance(arg, dict) and "values" in arg:
            key = "raster_%d" % index
            graph[key] = {"values": arg["values"].copy(), "no_data_value": arg["no_data_value"]}
            node.append(key)
        else:
            node.append(arg)
        host_args.append(arg)
    graph["out"] = tuple(node)
    before = executor.host_node_runs
    actual = compute_torch(graph, "out", device="cpu")
    assert executor.host_node_runs == before  # the twin served the node
    assert actual["no_data_value"] == expected["no_data_value"]
    assert actual["values"].dtype == expected["values"].dtype
    np.testing.assert_array_equal(actual["values"], expected["values"])
    return actual


@pytest.mark.parametrize("block", ["Add", "Subtract", "Multiply"])
@pytest.mark.parametrize("operand", [1, 2.5, "raster"])
def test_math_twins(block, operand):
    a = _raster(0)
    b = _raster(1) if operand == "raster" else operand
    kwargs = {"dtype": "float32", "fillvalue": F32_NODATA}
    _compare(
        getattr(jax_elemwise, block).process,
        getattr(elemwise, block).process,
        kwargs,
        a,
        b,
    )


def test_add_int_promotes_before_the_op():
    a = _raster(2, dtype=np.uint8, nodata=255, scale=255)
    kwargs = {"dtype": "int32", "fillvalue": int(np.iinfo(np.int32).max)}
    # uint8 + 200 must not wrap
    _compare(jax_elemwise.Add.process, elemwise.Add.process, kwargs, a, 200)


@pytest.mark.parametrize("right", [False, True])
def test_classify(right):
    data = _raster(3)
    data["values"][0, 0, :4] = [50.0, 100.0, 150.0, 200.0]  # on the edges
    out = _compare(
        jax_misc._classify_process,
        misc._classify_process,
        data,
        [50.0, 100.0, 150.0, 200.0],
        right,
    )
    assert out["values"].dtype == np.uint8


def test_classify_int_values():
    data = _raster(4, dtype=np.int64, nodata=int(np.iinfo(np.int64).max), scale=20)
    _compare(jax_misc._classify_process, misc._classify_process, data, [4, 8, 12, 16], False)


@pytest.mark.parametrize("select", [False, True])
def test_reclassify_int64_output(select):
    data = _raster(5, dtype=np.uint8, nodata=255, scale=6)
    kwargs = {
        "dtype": "<i8",
        "fillvalue": int(np.iinfo(np.int64).max),
        "data": [[0, 1], [1, 5], [2, 9], [3, 13], [4, 17]],
        "select": select,
    }
    out = _compare(jax_misc._reclassify_process, misc._reclassify_process, data, kwargs)
    assert out["values"].dtype == np.int64


@pytest.mark.parametrize(
    "values,scalar",
    [
        (np.array([0, 1, 255], np.uint8), 255),
        (np.array([0, 1, 255], np.uint8), 256),  # out of range: no match
        (np.array([0, 1, 255], np.uint8), None),
        (np.array([2**53, 2**53 + 1], np.int64), float(2**53)),  # float64 compare
        (np.array([0.1, 0.2], np.float32), 0.1),  # float32 compare
        (np.array([0.1, 0.2], np.float32), np.float64(0.1)),  # float64 compare
    ],
)
def test_equal_scalar_follows_numpy(values, scalar):
    expected = values == scalar
    actual = equal_scalar(torch.from_numpy(values), scalar).numpy()
    np.testing.assert_array_equal(actual, expected)
