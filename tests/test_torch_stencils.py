"""The port's Gaussian: plain torch version, CUDA kernel, Smooth twin.

The plain version follows scipy's arithmetic (float64 accumulation, float32
rounding between passes), so it is held bitwise to scipy and to the numpy
Smooth process.  The Pallas TPU kernel accumulates in float32, so against
it the check is allclose.
"""
import numpy as np
import pytest
import torch
from scipy import ndimage

from dask_geomodeling_tpu.ops.pallas_stencils import gaussian_blur_pallas
from dask_geomodeling_tpu.raster.spatial import _smooth_process
from dask_geomodeling_tpu_torch.ops import cuda_stencils
from dask_geomodeling_tpu_torch.ops.stencils import gaussian_blur_reference
from dask_geomodeling_tpu_torch.raster.spatial import _smooth_torch

SIGMAS = [(0.759, 0.760), (0.606, 0.608), (1.0, 1.0), (1.5, 2.0), (0.1, 0.1)]


def _planes(seed, shape=(2, 67, 83)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape) * 250).astype(np.float32)


@pytest.mark.parametrize("fill", [0.0, 0.1])
@pytest.mark.parametrize("sigma", SIGMAS)
def test_reference_bitwise_scipy(sigma, fill):
    data = _planes(0)
    expected = ndimage.gaussian_filter(
        data, (0, sigma[0], sigma[1]), mode="constant", cval=fill
    )
    actual = gaussian_blur_reference(torch.from_numpy(data), *sigma, fill)
    assert actual.dtype == torch.float32
    np.testing.assert_array_equal(actual.numpy(), expected)


def test_reference_float64_bitwise_scipy():
    data = _planes(1).astype(np.float64)
    expected = ndimage.gaussian_filter(data, (0, 1.2, 0.8), mode="constant", cval=0)
    actual = gaussian_blur_reference(torch.from_numpy(data), 1.2, 0.8, 0)
    assert actual.dtype == torch.float64
    np.testing.assert_array_equal(actual.numpy(), expected)


@pytest.mark.parametrize("sigma", [(0.759, 0.760), (1.5, 2.0)])
def test_reference_close_to_pallas(sigma):
    data = _planes(2, (2, 40, 52))
    pallas = np.asarray(gaussian_blur_pallas(data, *sigma, 0.0, interpret=True))
    actual = gaussian_blur_reference(torch.from_numpy(data), *sigma, 0.0)
    # the TPU kernel accumulates in float32
    np.testing.assert_allclose(actual.numpy(), pallas, rtol=1e-6, atol=1e-4)


def test_wrapper_takes_reference_on_cpu():
    data = torch.from_numpy(_planes(3))
    before = cuda_stencils.launches
    out = cuda_stencils.gaussian_blur(data, 0.759, 0.760, 0)
    assert torch.equal(out, gaussian_blur_reference(data, 0.759, 0.760, 0))
    assert cuda_stencils.launches == before  # no kernel ran


def _smooth_inputs(seed, shape=(2, 60, 70)):
    rng = np.random.RandomState(seed)
    values = (rng.rand(*shape) * 250).astype(np.float32)
    nodata = float(np.finfo(np.float32).max)
    values[:, 5:9, 10:14] = nodata
    return {"values": values, "no_data_value": nodata}


def _run_smooth_twin(data, process_kwargs):
    batched = {
        "values": torch.from_numpy(data["values"])[None],
        "no_data_value": data["no_data_value"],
    }
    out = _smooth_torch(batched, process_kwargs)
    return out["values"][0].numpy(), out["no_data_value"]


@pytest.mark.parametrize("size", [[2.275, 2.281], [3.6, 3.0], [5.9, 6.0]])
def test_smooth_exact_bitwise(size):
    data = _smooth_inputs(4)
    kwargs = {"smooth_mode": "exact", "fill": 0, "size": size}
    expected = _smooth_process(
        {"values": data["values"].copy(), "no_data_value": data["no_data_value"]},
        kwargs,
    )
    values, no_data_value = _run_smooth_twin(data, kwargs)
    assert no_data_value == expected["no_data_value"]
    np.testing.assert_array_equal(values, expected["values"])


@pytest.mark.parametrize("size", [[9.0, 9.5], [30.0, 24.0], [7.3, 12.1]])
def test_smooth_zoom_bitwise(size):
    # tighter than tests/test_raster_spatial.py holds the JAX Smooth twin
    # (allclose, rtol=1e-6): the zoom's order-0 index and the blur both
    # follow the host's arithmetic
    data = _smooth_inputs(5)
    kwargs = {"smooth_mode": "zoom", "fill": 0, "size": size}
    expected = _smooth_process(
        {"values": data["values"].copy(), "no_data_value": data["no_data_value"]},
        kwargs,
    )
    values, _ = _run_smooth_twin(data, kwargs)
    np.testing.assert_array_equal(values, expected["values"])


def test_cuda_tensor_without_kernel_raises():
    meta = torch.empty((2, 8, 8), device="meta")
    with pytest.raises(ValueError):
        cuda_stencils.gaussian_blur(meta, 1.0, 1.0, 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,sigma,dtype",
    [
        ((64, 516, 516), (0.759, 0.760), np.float32),  # the main path, r = 3
        ((8, 300, 260), (2.0, 1.9), np.float32),  # radius 8, the fused limit
        ((4, 200, 180), (10.0, 9.8), np.float32),  # radius 40, zoom mode
        ((4, 100, 90), (1.2, 0.8), np.float64),
        ((2, 100, 90), (12.0, 3.0), np.float64),
        # radius 440: the staged y window shrinks its chunk to fit
        ((2, 1000, 64), (110.0, 0.5), np.float32),
        # radius 504: too large a y window to stage (taps read device
        # memory); the x pass stages above 48 KB of shared memory
        ((2, 600, 300), (126.0, 0.5), np.float32),
        ((2, 300, 600), (0.5, 126.0), np.float32),
    ],
)
def test_kernel_equals_reference_on_card(shape, sigma, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    data = torch.from_numpy(_planes(6, shape).astype(dtype)).cuda()
    fused = max(sigma) <= 2.0  # radius <= 8: one fused launch, else two passes
    before = (cuda_stencils.launches, cuda_stencils.fused_launches)
    out = cuda_stencils.gaussian_blur(data, *sigma, 0.0)
    torch.cuda.synchronize()
    assert cuda_stencils.launches == before[0] + (1 if fused else 2)
    assert cuda_stencils.fused_launches == before[1] + (1 if fused else 0)
    assert out.dtype == data.dtype
    assert torch.equal(out, gaussian_blur_reference(data, *sigma, 0.0))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    data = torch.zeros((2, 16, 16), device="cuda")
    with pytest.raises(TypeError):
        cuda_stencils.gaussian_blur(data.half(), 1.0, 1.0, 0)
    with pytest.raises(ValueError):
        cuda_stencils.gaussian_blur(data[:, :, ::2], 1.0, 1.0, 0)
    with pytest.raises(ValueError):
        cuda_stencils.gaussian_blur(data[0], 1.0, 1.0, 0)


def test_kernel_weights_are_the_references_half():
    """The kernel takes w[0..r] of each axis; scipy's kernel is symmetric,
    so the taps at -j read the same weight as those at +j."""
    from dask_geomodeling_tpu_torch.ops.stencils import gaussian_weights

    for sigma_y, sigma_x in SIGMAS + [(5 / 3, 5 / 3), (2.0, 1.9), (10.0, 9.8), (0.1, 1.0)]:
        half, radius_y, radius_x = cuda_stencils._half_weights(sigma_y, sigma_x)
        assert half.dtype == np.float64 and half.flags["C_CONTIGUOUS"]
        for sigma, radius, part in [
            (sigma_y, radius_y, half[: radius_y + 1]),
            (sigma_x, radius_x, half[radius_y + 1 :]),
        ]:
            weights, r = gaussian_weights(sigma)
            assert r == radius and len(part) == r + 1
            np.testing.assert_array_equal(part, weights[r:])
            np.testing.assert_array_equal(weights[r::-1], weights[r:])


def _on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


def _card_equal(data, sigma, fill):
    """The kernel on ``data`` (a CUDA tensor) against the plain version:
    torch.equal, with NaN in the same places."""
    out = cuda_stencils.gaussian_blur(data, *sigma, fill)
    want = gaussian_blur_reference(data, *sigma, fill)
    torch.cuda.synchronize()
    assert out.dtype == want.dtype and out.shape == want.shape
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(out), nan)
    assert torch.equal(out[~nan], want[~nan])


# radius 3 (the headline path), 7 (the stencils path), 8 (the fused
# limit), 40 (two passes), and a radius of 0 on one axis
EDGE_SIGMAS = [(0.759, 0.760), (5 / 3, 5 / 3), (2.0, 2.0), (10.0, 10.0), (0.1, 1.0), (1.5, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", EDGE_SIGMAS)
@pytest.mark.parametrize("shape", [(3, 1, 1), (2, 2, 3), (2, 3, 40), (2, 40, 3), (2, 7, 9)])
def test_kernel_planes_smaller_than_the_halo(shape, sigma):
    _on_card()
    _card_equal(torch.from_numpy(_planes(7, shape)).cuda(), sigma, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("fill", [2.5, -3.75])
@pytest.mark.parametrize("sigma", EDGE_SIGMAS)
def test_kernel_nonzero_fill(sigma, fill, dtype):
    _on_card()
    _card_equal(torch.from_numpy(_planes(8, (3, 75, 131)).astype(dtype)).cuda(), sigma, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", EDGE_SIGMAS)
def test_kernel_nan_and_infinities(sigma):
    _on_card()
    data = _planes(9, (2, 90, 140))
    data[0, 10, 20] = np.nan
    data[0, 50, 0] = np.inf
    data[1, 0, 70] = -np.inf
    data[1, 89, 139] = np.nan
    data[1, 40:42, 60:62] = np.inf
    _card_equal(torch.from_numpy(data).cuda(), sigma, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", EDGE_SIGMAS)
@pytest.mark.parametrize("width", [121, 122, 123, 129, 250, 257, 526])
def test_kernel_widths(width, sigma):
    """Odd widths, widths around one tile (122 at radius 3) and rows that
    are not a multiple of 16 bytes."""
    _on_card()
    _card_equal(torch.from_numpy(_planes(10, (2, 70, width))).cuda(), sigma, 0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("sigma", [(0.759, 0.760), (0.1, 1.0), (3.0, 3.0)])
def test_kernel_more_planes_than_the_grid_takes(sigma):
    """65,537 planes: more than a launch's 65,535 grid rows of planes."""
    _on_card()
    _card_equal(torch.from_numpy(_planes(11, (65537, 5, 6))).cuda(), sigma, 0.0)
