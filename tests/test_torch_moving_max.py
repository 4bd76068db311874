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


def _half_width(size, dy):
    """csrc/moving_max.cu:half_width: the largest dx with
    4 (dx^2 + dy^2) < size^2."""
    k = size // 2
    while k > 0 and 4 * (k * k + dy * dy) >= size * size:
        k -= 1
    return k


@pytest.mark.parametrize("size", range(1, 16))
def test_kernel_half_widths_are_the_footprint_runs(size):
    odd = size // 2 * 2 + 1  # what the wrapper passes the kernel
    radius = odd // 2
    runs = [(dy, -_half_width(odd, abs(dy)), _half_width(odd, abs(dy)))
            for dy in range(-radius, radius + 1)]
    assert runs == footprint_runs(size)


def _separable_model(values, size):
    """The kernel's decomposition in torch: pad with the lowest value,
    horizontal maxima over [-k, k] grown one pair at a time, then one of
    them per footprint row down each column."""
    odd = size // 2 * 2 + 1
    radius = odd // 2
    dtype = values.dtype
    signed = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}.get(dtype)
    if signed is not None:
        sign = torch.iinfo(signed).min
        values = values.view(signed) ^ sign
    if values.dtype.is_floating_point:
        lowest = float("-inf")
    elif values.dtype == torch.bool:
        lowest = False
    else:
        lowest = torch.iinfo(values.dtype).min
    height, width = values.shape[-2:]
    padded = torch.nn.functional.pad(values, (radius,) * 4, value=lowest)

    def cols(dx):
        return padded[:, :, radius + dx : radius + dx + width]

    hmax = [cols(0)]
    for k in range(1, radius + 1):
        hmax.append(torch.maximum(torch.maximum(hmax[-1], cols(-k)), cols(k)))

    def rows(dy):
        return hmax[_half_width(odd, abs(dy))][:, radius + dy : radius + dy + height]

    out = rows(0)
    for dy in range(1, radius + 1):
        out = torch.maximum(torch.maximum(out, rows(-dy)), rows(dy))
    if signed is not None:
        out = (out ^ sign).view(dtype)
    return out


MODEL_DTYPES = [torch.float32, torch.float64, torch.float16, torch.int8, torch.int16,
                torch.int32, torch.int64, torch.uint8, torch.uint16, torch.uint32,
                torch.uint64, torch.bool]


def _extreme_planes(seed, shape, dtype):
    """Random planes of ``dtype`` holding its lowest and highest values,
    and NaN and +-inf where it is a float type."""
    rng = np.random.RandomState(seed)
    if dtype == torch.bool:
        return torch.from_numpy(rng.rand(*shape) > 0.7)
    if dtype.is_floating_point:
        data = torch.from_numpy(rng.randn(*shape) * 100).to(dtype)
        data[0, 1, 2] = float("nan")
        data[-1, -1, -1] = float("nan")
        data[0, -2, 0] = float("inf")
        data[-1, 0, 1] = float("-inf")
        return data
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    raw = rng.randint(0, 256, size=tuple(shape) + (np_dtype.itemsize,), dtype=np.uint8)
    data = raw.view(np_dtype)[..., 0].copy()
    data[0, 1, 2] = np.iinfo(np_dtype).max
    data[-1, -1, -1] = np.iinfo(np_dtype).min
    return torch.from_numpy(data)


@pytest.mark.parametrize("dtype", MODEL_DTYPES, ids=str)
@pytest.mark.parametrize("size", range(1, 16))
def test_kernel_decomposition_equals_reference(size, dtype):
    data = _extreme_planes(size, (2, 13, 17), dtype)
    model = _separable_model(data, size)
    want = moving_max_reference(data, size)
    assert model.dtype == want.dtype == dtype
    assert _same(model, want)


def _card_equal(data, size):
    before = cuda_stencils.moving_max_launches
    out = cuda_stencils.moving_max(data, size)
    want = moving_max_reference(data, size)
    torch.cuda.synchronize()
    assert cuda_stencils.moving_max_launches == before + 1
    assert out.dtype == want.dtype and out.shape == want.shape
    assert _same(out, want)


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("size", range(1, 16))
def test_kernel_every_size_float32(size):
    _on_card()
    _card_equal(_extreme_planes(20 + size, (3, 67, 131), torch.float32).cuda(), size)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", MODEL_DTYPES, ids=str)
@pytest.mark.parametrize("size", [3, 5, 7])
def test_kernel_every_width(size, dtype):
    _on_card()
    _card_equal(_extreme_planes(40 + size, (3, 45, 133), dtype).cuda(), size)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [3, 5, 7, 9])
@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 2, 3), (2, 3, 40), (2, 40, 3)])
def test_kernel_planes_smaller_than_the_halo(shape, size):
    _on_card()
    data = torch.from_numpy(np.random.RandomState(6).rand(*shape).astype(np.float32))
    _card_equal(data.cuda(), size)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [3, 5, 7, 11])
@pytest.mark.parametrize("width", [127, 128, 129, 130, 257, 526])
def test_kernel_widths(width, size):
    """Widths around one tile (128) and rows that are not a multiple of 16
    bytes (526 float32, the stencils path's)."""
    _on_card()
    _card_equal(_extreme_planes(60, (2, 50, width), torch.float32).cuda(), size)


@pytest.mark.cuda
@pytest.mark.parametrize("size", [3, 9])
def test_kernel_more_planes_than_the_grid_takes(size):
    """65,537 planes: more than a launch's 65,535 grid rows of planes."""
    _on_card()
    _card_equal(_extreme_planes(61, (65537, 4, 5), torch.float32).cuda(), size)
