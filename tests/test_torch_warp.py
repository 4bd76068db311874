"""warp_torch against the JAX package's warp_jax and the host warp_numpy.

Cross-CRS, the port interpolates a float64 coarse index grid where
warp_jax interpolates the same grid rounded to float32 (the JAX package's
``host_coarse_grid``): the port matches the host's exact per-pixel warp
bit for bit on these tiles, and where it differs from warp_jax the two
took neighbouring source pixels.  Same-CRS
all three agree bit for bit.  The inputs hold a nodata patch, NaN source
cells, cells outside the source and out-of-domain tiles (NaN and
far-away coarse grids).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_geomodeling_tpu.geo import Extent
from dask_geomodeling_tpu.ops.warp import host_coarse_grid, warp_jax, warp_numpy
from dask_geomodeling_tpu.runtime.executor import _ensure_x64
from dask_geomodeling_tpu_torch.ops import warp as port_warp
from dask_geomodeling_tpu_torch.ops.warp import coarse_index_grid, warp_torch

SRC_GT = (85000.0, 1.0, 0, 455000.0, 0, -1.0)
SRC_SRS = "EPSG:28992"
SRC_SHAPE = (96, 112)
WIDTH, HEIGHT = 56, 40


@pytest.fixture(scope="module", autouse=True)
def x64():
    _ensure_x64()  # what the JAX executors do before tracing


def _source(dtype):
    rng = np.random.RandomState(7)
    values = (rng.rand(2, *SRC_SHAPE) * 250).astype(dtype)
    if np.dtype(dtype).kind == "f":
        nodata = float(np.finfo(dtype).max)
        values[0, 3:9, 4:12] = np.nan
    else:
        nodata = -9999
    values[:, 20:30, 40:52] = nodata
    return values, nodata


def _fill(dtype):
    return float(np.finfo(dtype).max) if np.dtype(dtype).kind == "f" else -1


def _cross_tiles():
    """Tiles in EPSG:3857 over and past the source, and their float64
    coarse index grids; tiles 0, 4 and 5 are (partly) out of the domain."""
    # the source spans about x 486026..486210, y 6814238..6814397 here
    x0, y0 = 485990.0, 6814210.0
    cell = 1.6
    bboxes = []
    for i, j in [(0, 0), (1, 0), (0, 2), (1, 2), (1, 1), (2, 1)]:
        bx = x0 + i * WIDTH * cell
        by = y0 + j * HEIGHT * cell
        bboxes.append((bx, by, bx + WIDTH * cell, by + HEIGHT * cell))
    grids = np.stack(
        [
            coarse_index_grid(SRC_GT, SRC_SRS, bbox, "EPSG:3857", WIDTH, HEIGHT, 8)
            for bbox in bboxes
        ]
    )
    grids[0, :, 1:3, 2:5] = np.nan  # partly out of the transform's domain
    grids[4] = np.nan  # wholly out of the domain
    grids[5] = 1e30  # far outside the source, beyond the int32 range
    return np.asarray(bboxes), grids


def _jax_batched(values, nodata, dtype, projection, bboxes, grids):
    def one(bbox, grid):
        return warp_jax(
            jnp.asarray(values), SRC_GT, SRC_SRS, nodata, bbox, projection,
            WIDTH, HEIGHT, np.dtype(dtype), _fill(dtype), coarse_grid=grid,
        )

    if grids is None:
        return np.asarray(jax.jit(jax.vmap(lambda b: one(b, None)))(bboxes))
    return np.asarray(jax.jit(jax.vmap(one))(bboxes, grids.astype(np.float32)))


def _torch_batched(values, nodata, dtype, projection, bboxes, grids):
    return warp_torch(
        torch.from_numpy(values), SRC_GT, SRC_SRS, nodata,
        torch.from_numpy(bboxes), projection, WIDTH, HEIGHT, np.dtype(dtype),
        _fill(dtype), coarse_grid=None if grids is None else torch.from_numpy(grids),
    ).numpy()


def test_float64_grid_rounds_to_the_jax_packages():
    bboxes, grids = _cross_tiles()
    for tile in (1, 2, 3):
        expected = host_coarse_grid(
            SRC_GT, SRC_SRS, tuple(bboxes[tile]), "EPSG:3857", WIDTH, HEIGHT, 8
        )
        np.testing.assert_array_equal(grids[tile].astype(np.float32), expected)


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_cross_crs_matches_host_warp(dtype):
    values, nodata = _source(dtype)
    bboxes, grids = _cross_tiles()
    actual = _torch_batched(values, nodata, dtype, "EPSG:3857", bboxes, grids)
    fill = _fill(dtype)
    for tile in (1, 2, 3):  # grids as the transform gives them
        host = warp_numpy(
            values, SRC_GT, SRC_SRS, nodata, tuple(bboxes[tile]), "EPSG:3857",
            WIDTH, HEIGHT, dtype=dtype, fillvalue=fill,
        )
        np.testing.assert_array_equal(actual[tile], host)
        assert (actual[tile] == fill).any() and (actual[tile] != fill).any()
    # out-of-domain cells, and tiles far outside, are fill; so is warp_jax
    expected = _jax_batched(values, nodata, dtype, "EPSG:3857", bboxes, grids)
    assert (actual[4] == fill).all() and (actual[5] == fill).all()
    nan_cells = np.isnan(
        grids[0, 0, :, :]
    ).repeat(8, axis=0).repeat(8, axis=1)[:HEIGHT, :WIDTH]
    assert (actual[0][:, nan_cells] == fill).all()
    np.testing.assert_array_equal(actual[4:], expected[4:])


def test_wide_source_host_exact_where_warp_jax_is_not():
    """At column indices near 8000, float32 resolves about 1/1000 of a
    pixel: warp_jax's float32 grid moves a few cells to a neighbouring
    source pixel, the port's float64 grid reproduces the host.  Each source
    pixel holds its own flat index, so a cell tells which pixel it took."""
    height, width = 64, 8192
    values = np.arange(height * width, dtype=np.int32).reshape(1, height, width)
    x0, y0, _, _ = Extent(
        (85000 + 7900, 455000 - height, 85000 + width, 455000), SRC_SRS
    ).transformed("EPSG:3857").bbox
    w, h, cell = 128, 96, 1.5
    bboxes = np.asarray(
        [(x0 + i * w * cell, y0 - 20, x0 + (i + 1) * w * cell, y0 + h * cell - 20)
         for i in range(3)]
    )
    grids = np.stack(
        [coarse_index_grid(SRC_GT, SRC_SRS, tuple(b), "EPSG:3857", w, h, 8) for b in bboxes]
    )
    actual = warp_torch(
        torch.from_numpy(values), SRC_GT, SRC_SRS, None, torch.from_numpy(bboxes),
        "EPSG:3857", w, h, np.int32, -1, coarse_grid=torch.from_numpy(grids),
    ).numpy()
    jax_out = np.asarray(
        jax.jit(
            jax.vmap(
                lambda b, g: warp_jax(
                    jnp.asarray(values), SRC_GT, SRC_SRS, None, b, "EPSG:3857",
                    w, h, np.dtype(np.int32), -1, coarse_grid=g,
                )
            )
        )(bboxes, grids.astype(np.float32))
    )
    host = np.stack(
        [
            warp_numpy(values, SRC_GT, SRC_SRS, None, tuple(b), "EPSG:3857", w, h,
                       dtype=np.int32, fillvalue=-1)
            for b in bboxes
        ]
    )
    np.testing.assert_array_equal(actual, host)
    assert (actual != -1).mean() > 0.5
    differ = actual != jax_out
    # measured: 6 of 36864 cells, each at a pixel edge
    assert 0 < differ.sum() <= 40
    for a, b in zip(actual[differ], jax_out[differ]):
        if a == -1 or b == -1:  # inside for one warp, just outside for the other
            row, col = divmod(int(max(a, b)), width)
            assert row in (0, height - 1) or col in (0, width - 1)
        else:
            (ra, ca), (rb, cb) = divmod(int(a), width), divmod(int(b), width)
            assert abs(ra - rb) <= 1 and abs(ca - cb) <= 1


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
def test_same_crs_matches_warp_jax_and_host(dtype):
    values, nodata = _source(dtype)
    cell = 0.7
    bboxes = np.asarray(
        [
            (85000.3 + i * 30.0, 454900.1 + j * 25.0,
             85000.3 + i * 30.0 + WIDTH * cell, 454900.1 + j * 25.0 + HEIGHT * cell)
            for i, j in [(0, 0), (1, 2), (3, 3), (-1, -1)]
        ]
    )
    expected = _jax_batched(values, nodata, dtype, SRC_SRS, bboxes, None)
    actual = _torch_batched(values, nodata, dtype, SRC_SRS, bboxes, None)
    np.testing.assert_array_equal(actual, expected)
    for bbox, tile in zip(bboxes, actual):
        host = warp_numpy(
            values, SRC_GT, SRC_SRS, nodata, tuple(bbox), SRC_SRS, WIDTH, HEIGHT,
            dtype=dtype, fillvalue=_fill(dtype),
        )
        np.testing.assert_array_equal(tile, host)


def test_cross_crs_needs_the_grid():
    values, nodata = _source(np.float32)
    bboxes, _ = _cross_tiles()
    with pytest.raises(ValueError):
        _torch_batched(values, nodata, np.float32, "EPSG:3857", bboxes, None)


def test_bilinear_not_ported_yet():
    values, nodata = _source(np.float32)
    bboxes, grids = _cross_tiles()
    with pytest.raises(NotImplementedError):
        warp_torch(
            torch.from_numpy(values), SRC_GT, SRC_SRS, nodata,
            torch.from_numpy(bboxes), "EPSG:3857", WIDTH, HEIGHT, np.float32, 0.0,
            interpolation="bilinear", coarse_grid=torch.from_numpy(grids),
        )


@pytest.mark.parametrize("dtype", [np.float32, np.int16])
@pytest.mark.parametrize("projection", ["EPSG:3857", SRC_SRS])
def test_port_warp_numpy_is_the_jax_packages(dtype, projection):
    values, nodata = _source(dtype)
    if projection == SRC_SRS:
        bboxes = [(85000.3, 454900.1, 85000.3 + WIDTH * 0.7, 454900.1 + HEIGHT * 0.7)]
    else:
        bboxes = [tuple(b) for b in _cross_tiles()[0]]
    for bbox in bboxes:
        args = (values, SRC_GT, SRC_SRS, nodata, bbox, projection, WIDTH, HEIGHT)
        kwargs = dict(dtype=dtype, fillvalue=_fill(dtype))
        np.testing.assert_array_equal(
            port_warp.warp_numpy(*args, **kwargs), warp_numpy(*args, **kwargs)
        )
