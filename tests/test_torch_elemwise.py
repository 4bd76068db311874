"""The elementwise blocks: math, comparisons, logic, FillNoData, Invert,
IsData/IsNoData and Exp/Log/Log10, carried across from the JAX package.

Each view is held, on the CPU, against the JAX package's numpy executor:
the port's ``compute_host`` bitwise, its torch twins through ``get_data``
and through ``evaluate_tiled`` (ragged 8^2 tiles in batches of 3) bitwise
for integer and boolean results and for Add/Subtract/Multiply/Divide,
with ``rtol=1e-6`` for Power, Exp, Log and Log10 (torch's transcendentals
round differently from libm's).  Where noted the JAX package's own twins
(its jax executor, on the CPU) are held to the same numpy results, to
show the reference agrees there too.

``assert_views_agree`` and ``source`` are shared with the other
``test_torch_*`` block tests.
"""
from datetime import datetime, timedelta

import numpy as np
import pytest

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu import raster as R
from dask_geomodeling_tpu_torch import compute_host, evaluate_tiled, from_reference
from dask_geomodeling_tpu_torch import raster as port
from dask_geomodeling_tpu_torch.runtime import executor
from dask_geomodeling_tpu_torch.runtime.tiles import tile_requests

HEIGHT, WIDTH = 16, 20
REQUEST = dict(
    mode="vals",
    bbox=(135000.0, 456000.0 - HEIGHT, 135000.0 + WIDTH, 456000.0),
    projection="EPSG:28992",
    width=WIDTH,
    height=HEIGHT,
    start=datetime(2000, 1, 1),
    stop=datetime(2000, 1, 1, 1),
)
NODATA = {
    "uint8": 255,
    "int16": -9999,
    "int32": -2147483648,
    "float32": float(np.finfo(np.float32).max),
    "float64": -9999.0,
}


def source(dtype="float32", seed=0, bands=2, scale=40.0, shape=(HEIGHT, WIDTH)):
    """A JAX-package MemorySource of ``dtype``: values in [-10, scale) for
    signed types ([0, scale) unsigned) rounded to tenths, with a nodata
    patch, zeros and the constants the tests compare against."""
    rng = np.random.RandomState(seed)
    dtype = np.dtype(dtype)
    low = 0 if dtype.kind == "u" else -10
    data = np.round(rng.rand(bands, *shape) * (scale - low) + low, 1).astype(dtype)
    data[:, 2:5, 3:7] = NODATA[dtype.name]
    data[:, 7 % shape[0], :4] = np.array([0, 3, 2.5, 12.34]).astype(dtype)
    return R.MemorySource(
        data=data,
        no_data_value=NODATA[dtype.name],
        projection="EPSG:28992",
        pixel_size=1.0,
        pixel_origin=(135000.0, 456000.0),
        time_first=datetime(2000, 1, 1),
        time_delta=timedelta(hours=1) if bands > 1 else None,
    )


def _numpy(view, request):
    with jax_config.set({"geomodeling.executor": "numpy"}):
        return view.get_data(**request)


def _same(actual, expected, rtol=None, what=""):
    if expected is None:
        assert actual is None, what
        return
    assert actual["values"].dtype == expected["values"].dtype, what
    assert actual["no_data_value"] == expected["no_data_value"], what
    if rtol is None:
        np.testing.assert_array_equal(actual["values"], expected["values"], err_msg=what)
    else:
        np.testing.assert_allclose(actual["values"], expected["values"], rtol=rtol, err_msg=what)


def _tiles_against_host(view, request, tile, batch, rtol):
    """evaluate_tiled against compute_host tile by tile, for views whose
    answer depends on the request's window (Place's statistics)."""
    tiles, nx = tile_requests(request, tile)
    out = evaluate_tiled(view, request, tile_size=tile, batch=batch, device="cpu")["values"]
    width, height = request["width"], request["height"]
    for index, tile_request in enumerate(tiles):
        j, i = divmod(index, nx)
        vw, vh = min(tile, width - i * tile), min(tile, height - j * tile)
        row_end = height - j * tile
        host = compute_host(*view.get_compute_graph(**tile_request))
        _same(
            {"values": out[:, row_end - vh : row_end, i * tile : i * tile + vw],
             "no_data_value": host["no_data_value"]},
            dict(host, values=host["values"][:, tile - vh :, :vw]),
            rtol,
            "tile %d" % index,
        )


def assert_views_agree(jax_view, request=REQUEST, rtol=None, jax_twin=False, tile=8, batch=3,
                       per_tile=False):
    """The port's view of ``jax_view`` against the JAX package's numpy
    executor: compute_host bitwise; get_data and evaluate_tiled on the CPU
    bitwise, or within ``rtol`` (``per_tile``: each tile against
    compute_host of its own request).  With ``jax_twin`` the JAX package's
    jax executor is held to the numpy result the same way.  Returns the
    numpy result."""
    expected = _numpy(jax_view, request)
    view = from_reference(jax_view.serialize())
    graph = view.get_compute_graph(**request)
    _same(compute_host(*graph), expected, what="compute_host")
    before = executor.host_node_runs
    _same(view.get_data(device="cpu", **request), expected, rtol, "get_data")
    assert executor.host_node_runs == before, "a node ran on the host"
    if expected is not None and max(request["width"], request["height"]) > tile:
        if per_tile:
            _tiles_against_host(view, request, tile, batch, rtol)
        else:
            tiled = evaluate_tiled(view, request, tile_size=tile, batch=batch, device="cpu")
            _same(tiled, expected, rtol, "evaluate_tiled")
        assert executor.host_node_runs == before, "a node ran on the host"
    if jax_twin:
        with jax_config.set({"geomodeling.executor": "jax"}):
            _same(jax_view.get_data(**request), expected, rtol, "JAX twin")
    return expected


MATH = ["Add", "Subtract", "Multiply", "Divide", "Power"]


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize("operand", ["int", "float", "raster", "uint8 raster"])
@pytest.mark.parametrize("block", MATH)
def test_math(block, operand, dtype):
    a = source(dtype)
    if operand == "int":
        b = 3
    elif operand == "float":
        b = 2.5
    elif operand == "raster":
        b = source(dtype, seed=1)
    else:
        b = source("uint8", seed=2, scale=6)
    if block == "Power" and operand != "int":
        a = source(dtype, scale=6)  # keep powers finite, mostly
        if operand == "raster":
            b = source("uint8", seed=1, scale=4)  # numpy refuses negative integer powers
    result = assert_views_agree(
        getattr(R, block)(a, b), rtol=1e-6 if block == "Power" else None
    )
    assert (result["values"] == result["no_data_value"]).any()


@pytest.mark.parametrize("block", MATH)
def test_math_agrees_with_the_jax_twin(block):
    assert_views_agree(getattr(R, block)(source("float32"), source("uint8", 1, scale=6)),
                       rtol=1e-6, jax_twin=True)


@pytest.mark.parametrize(
    "view, rtol",
    [
        (lambda: R.Divide(source("int16"), source("int16", seed=1)), None),  # x / 0
        (lambda: R.Log(source("float32")), 1e-6),  # log of negatives and 0
        (lambda: R.Power(source("float32", scale=1e4), 30), 1e-6),  # overflow
        (lambda: R.Exp(source("float64", scale=800)), 1e-6),  # overflow
        (lambda: R.Power(source("int16", scale=300), 5), None),  # wraps, no fill
    ],
    ids=["divide-by-zero", "log-negative", "power-overflow", "exp-overflow", "int-power"],
)
def test_non_finite_results_are_fill(view, rtol):
    result = assert_views_agree(view(), rtol=rtol)
    values = result["values"]
    assert np.isfinite(values).all()
    if values.dtype.kind == "f":
        # more fill than the nodata patch alone: the non-finite results
        assert (values == result["no_data_value"]).sum() > 2 * 3 * 4


COMPARISONS = ["Equal", "NotEqual", "Greater", "GreaterEqual", "Less", "LessEqual"]


@pytest.mark.parametrize("dtype", ["uint8", "int16", "float32", "float64"])
@pytest.mark.parametrize("operand", [3, 12.34, 300, -5, "raster"])
@pytest.mark.parametrize("block", COMPARISONS)
def test_comparisons(block, operand, dtype):
    a = source(dtype)
    b = source("float32", seed=1) if operand == "raster" else operand
    result = assert_views_agree(getattr(R, block)(a, b))
    assert result["values"].dtype == bool and result["no_data_value"] is None
    # nodata cells compare False, NotEqual True
    assert (result["values"][:, 2:5, 3:7] == (block == "NotEqual")).all()


@pytest.mark.parametrize("block", COMPARISONS)
def test_comparisons_agree_with_the_jax_twin(block):
    """Against a constant float32 holds exactly, the JAX twin agrees."""
    assert_views_agree(getattr(R, block)(source("float32"), 2.5), jax_twin=True)


@pytest.mark.parametrize("block", COMPARISONS)
def test_comparisons_follow_numpy_where_the_jax_twin_does_not(block):
    """numpy compares a float32 raster with the Python float 12.34 in
    float32, where the constant rounds to the cells that hold 12.34; the
    JAX twin compares in float64 and differs on those cells for four of
    the six comparisons.  The port follows numpy."""
    view = getattr(R, block)(source("float32"), 12.34)
    expected = assert_views_agree(view)
    with jax_config.set({"geomodeling.executor": "jax"}):
        jax_values = view.get_data(**REQUEST)["values"]
    differs = jax_values != expected["values"]
    if block in ("GreaterEqual", "Less"):
        assert not differs.any()
    else:
        assert differs[:, 7, 3].all() and differs.sum() == 2


def _flags(seed):
    return R.Greater(source("float32", seed=seed), 15.0)


@pytest.mark.parametrize("block", ["And", "Or", "Xor"])
@pytest.mark.parametrize("operand", ["raster", True, False])
def test_logic(block, operand):
    b = _flags(1) if operand == "raster" else operand
    result = assert_views_agree(getattr(R, block)(_flags(0), b), jax_twin=operand == "raster")
    assert result["values"].dtype == bool


def test_invert_and_data_masks():
    assert_views_agree(R.Invert(_flags(0)), jax_twin=True)
    for dtype in ("uint8", "float32", "float64"):
        for block in (R.IsData, R.IsNoData):
            result = assert_views_agree(block(source(dtype)))
            assert result["values"][:, 2:5, 3:7].all() == (block is R.IsNoData)


@pytest.mark.parametrize(
    "dtypes", [("float32", "float32"), ("uint8", "float32"), ("int16", "uint8"), ("float64", "int16")]
)
def test_fill_no_data(dtypes):
    first = source(dtypes[0])
    second = source(dtypes[1], seed=1)
    assert_views_agree(R.FillNoData(first, second), jax_twin=dtypes[0] == "float32")
    assert_views_agree(R.FillNoData(second, first, _flags(3)))


@pytest.mark.parametrize("block", ["Exp", "Log", "Log10"])
@pytest.mark.parametrize("dtype", ["uint8", "float32", "float64"])
def test_log_exp(block, dtype):
    assert_views_agree(getattr(R, block)(source(dtype, scale=20)), rtol=1e-6)


def test_operator_overloads_build_the_blocks():
    a, b = port.MemorySource(np.ones((1, 4, 4), np.float32), 0.0, "EPSG:28992", 1.0, (0, 4)), 2.0
    flags = a > b
    built = {
        "Divide": a / b, "Power": a ** b, "Equal": a == b, "NotEqual": a != b,
        "Greater": flags, "GreaterEqual": a >= b, "Less": a < b, "LessEqual": a <= b,
        "Invert": ~flags, "And": flags & flags, "Or": flags | flags, "Xor": flags ^ flags,
    }
    for name, block in built.items():
        assert type(block) is getattr(port, name), name
    # __eq__ builds a block, so hashing stays by identity
    assert len({a, a, flags}) == 2
