"""The port's moving maximum: plain torch version, CUDA kernel, MovingMax
twin.

``moving_max_reference`` computes in the input's own dtype, which for a
maximum is exact, so it is held bitwise to the Pallas TPU kernel (in
interpret mode) on the JAX package's own cases, and to the JAX package's
reduce_window version for the dtypes the Pallas kernel refuses.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

from dask_geomodeling_tpu import config as jax_config
from dask_geomodeling_tpu.geo.dtypes import get_footprint
from dask_geomodeling_tpu.ops.pallas_stencils import moving_max_pallas, moving_max_pallas_fits
from dask_geomodeling_tpu.ops.stencils import _footprint_runs, moving_max_jax
from dask_geomodeling_tpu.raster.spatial import _moving_max_process
from dask_geomodeling_tpu.runtime.executor import _ensure_x64
from dask_geomodeling_tpu_torch.ops import cuda_stencils
from dask_geomodeling_tpu_torch.ops.stencils import footprint_runs, moving_max_reference
from dask_geomodeling_tpu_torch.raster import spatial


@pytest.fixture
def x64():
    _ensure_x64()  # without it JAX narrows int64, uint32 and float64


def test_pallas_cases_bitwise(x64):
    """The cases of tests/test_raster_spatial.py:TestMovingMaxPallas, on
    whole arrays, edges included."""
    rng = np.random.RandomState(0)
    for dtype, size in [("f4", 5), ("u1", 3), ("i4", 7), ("u2", 5)]:
        x = (rng.rand(2, 40, 48) * 200).astype(dtype)
        pallas = np.asarray(moving_max_pallas(x, size, interpret=True))
        actual = moving_max_reference(torch.from_numpy(x), size).numpy()
        assert actual.dtype == pallas.dtype == x.dtype
        np.testing.assert_array_equal(actual, pallas)


@pytest.mark.parametrize("dtype", ["f8", "i8", "u4"])
def test_refused_dtypes_match_reduce_window(x64, dtype):
    assert not moving_max_pallas_fits(40, 48, 5, dtype)
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 40, 48) * 200).astype(dtype)
    if dtype == "i8":
        x = x * (2**40) - 2**45  # beyond float32's and float64's integers
    with jax_config.set({"geomodeling.pallas-stencils": False}):
        expected = np.asarray(moving_max_jax(x, 5))
    actual = moving_max_reference(torch.from_numpy(x), 5).numpy()
    assert actual.dtype == expected.dtype == x.dtype
    np.testing.assert_array_equal(actual, expected)


def test_unsigned_high_values():
    """uint64 above int64's range keeps its order (the sign-bit flip)."""
    x = np.array([[[2**63 + 5, 1, 2**64 - 1], [0, 2**63, 7]]], dtype=np.uint64)
    actual = moving_max_reference(torch.from_numpy(x), 3).numpy()
    # a 3x3 window over two rows: every cell sees both rows, its own
    # column and its neighbours
    expected = np.array([[[2**63 + 5, 2**64 - 1, 2**64 - 1]] * 2], dtype=np.uint64)
    np.testing.assert_array_equal(actual, expected)


def test_footprint_runs_match():
    for size in (3, 5, 7, 15):
        assert footprint_runs(size) == _footprint_runs(size)


def test_nan_spreads_like_pallas_and_unlike_scipy(x64):
    """A NaN takes every window that holds it, as jnp.maximum does in the
    Pallas kernel; scipy's maximum_filter lets it through in one cell."""
    x = (np.random.RandomState(2).rand(2, 12, 14) * 100).astype(np.float32)
    x[0, 5, 6] = np.nan
    x[1, 0, 0] = np.nan
    pallas = np.asarray(moving_max_pallas(x, 3, interpret=True))
    actual = moving_max_reference(torch.from_numpy(x), 3).numpy()
    np.testing.assert_array_equal(actual, pallas)  # NaN in the same places
    assert np.isnan(actual[0, 4:7, 5:8]).all() and np.isnan(actual).sum() == 9 + 4
    scipy = ndimage.maximum_filter(
        x, footprint=get_footprint(3)[None], mode="constant", cval=-np.inf
    )
    assert np.isnan(scipy).sum() < np.isnan(actual).sum()


def _twin_input(seed, dtype, nodata):
    rng = np.random.RandomState(seed)
    values = (rng.rand(3, 1, 30, 34) * 100).astype(dtype)
    values[0, 0, 10:16, 12:19] = nodata  # wider than the footprint: unreached
    values[1, 0, 3, 4] = nodata  # reached from its neighbours
    values[2, 0, 0:2, :] = nodata  # at the edge
    return values


@pytest.mark.parametrize(
    "dtype, nodata, size",
    [
        (np.float32, float(np.finfo(np.float32).max), 3),
        (np.float32, -9999.0, 5),
        (np.int16, -1, 3),
        (np.uint8, 255, 5),
    ],
)
def test_twin_equals_process(dtype, nodata, size):
    values = _twin_input(3, dtype, nodata)
    out = spatial._moving_max_torch(
        {"values": torch.from_numpy(values), "no_data_value": nodata}, size
    )
    assert out["no_data_value"] == nodata
    for b in range(values.shape[0]):
        expected = _moving_max_process({"values": values[b], "no_data_value": nodata}, size)
        np.testing.assert_array_equal(out["values"][b].numpy(), expected["values"])
        # the port's copy of the numpy process agrees too
        copied = spatial._moving_max_process({"values": values[b], "no_data_value": nodata}, size)
        np.testing.assert_array_equal(copied["values"], expected["values"])
    # the patch's inner cells, [10 + r, 16 - r) x [12 + r, 19 - r) of the
    # input, lie r pixels up and left in the cropped output
    r = size // 2
    assert (out["values"][0, 0, 10 : 16 - 2 * r, 12 : 19 - 2 * r] == nodata).all()


def test_wrapper_takes_reference_on_cpu():
    data = torch.from_numpy((np.random.RandomState(4).rand(2, 20, 30) * 9).astype(np.float32))
    before = cuda_stencils.moving_max_launches
    out = cuda_stencils.moving_max(data, 3)
    assert torch.equal(out, moving_max_reference(data, 3))
    assert cuda_stencils.moving_max_launches == before  # no kernel ran


def test_non_cpu_tensor_without_kernel_raises():
    meta = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_stencils.moving_max(meta, 3)


def _same(a, b):
    if a.dtype.is_floating_point:
        nan = torch.isnan(a)
        return torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan])
    return torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape, size, dtype",
    [
        ((64, 526, 526), 3, np.float32),  # the stencils path
        ((4, 200, 180), 5, np.float32),
        ((4, 200, 180), 15, np.float32),
        ((3, 67, 91), 7, np.float64),
        ((3, 67, 91), 5, np.int64),
        ((3, 67, 91), 5, np.uint32),
        ((3, 67, 91), 3, np.uint16),
        ((3, 67, 91), 3, np.int8),
        ((3, 67, 91), 3, np.float16),
    ],
)
def test_kernel_equals_reference_on_card(shape, size, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    data = torch.from_numpy((np.random.RandomState(5).rand(*shape) * 120).astype(dtype)).cuda()
    if data.dtype.is_floating_point:
        data[0, 10, 10] = float("nan")
    before = cuda_stencils.moving_max_launches
    out = cuda_stencils.moving_max(data, size)
    torch.cuda.synchronize()
    assert cuda_stencils.moving_max_launches == before + 1
    assert out.dtype == data.dtype
    assert _same(out, moving_max_reference(data, size))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = torch.zeros((2, 16, 16), device="cuda")
    with pytest.raises(TypeError):
        cuda_stencils.moving_max(data.to(torch.complex64), 3)
    with pytest.raises(ValueError):
        cuda_stencils.moving_max(data[:, :, ::2], 3)
    with pytest.raises(ValueError):
        cuda_stencils.moving_max(data[0], 3)
