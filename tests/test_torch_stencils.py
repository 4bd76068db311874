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
